"""Differentiable safety-parameter tuning — the training path
(counterpart: cbf_tpu/learn/tuning.py).

The filter's parameters (gamma, dmin and the approach-velocity weight k)
are trained against a closed-loop rollout objective: track the packing
disk while penalizing separation below a target. Every stage of the step
is differentiable with ``unroll_relax > 0``: the barrier rows, the QP's
unrolled relax rounds, the k-NN selection (the kernels select through
:func:`cbf_tpu_torch.ops.knn.knn_select`, whose gradient is zero, and the
gathered rows and nearest distance are recomputed from the positions),
the sparse certificate's K solve (its implicit gradient) and the
integration.

The JAX package computes the loss under a (dp, sp) ``shard_map``: members
data-parallel, agents ring-sharded. On one card dp folds into the member
axis and sp is 1; sp > 1 raises (ROADMAP.md item 10). The members' losses
are summed in one autograd graph, so one backward gives every member's
contribution, as JAX's in-region ``value_and_grad`` and psum do.
``jax.checkpoint`` per step becomes ``torch.utils.checkpoint`` (non
re-entrant), and ``optax.adam`` becomes ``torch.optim.Adam`` with the same
rate, betas and eps.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cbf_tpu_torch.core.filter import CBFParams
from cbf_tpu_torch.errors import SLICE_PARALLEL, OutOfSliceError
from cbf_tpu_torch.ops import knn
from cbf_tpu_torch.parallel.ensemble import _local_swarm_step
from cbf_tpu_torch.scenarios import swarm as swarm_scenario
from cbf_tpu_torch.utils.math import safe_norm


class TunableParams(NamedTuple):
    """Unconstrained parametrization (0-dim float32 tensors); softplus
    maps to the positive cone."""
    gamma_raw: torch.Tensor
    dmin_raw: torch.Tensor
    k_raw: torch.Tensor            # approach-velocity weight (cbf.py:47 `k`)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 8                 # rollout horizon per loss evaluation
    unroll_relax: int = 2          # differentiable relax rounds in the QP
    separation_target: float = 0.2
    safety_weight: float = 10.0
    learning_rate: float = 1e-2
    # Recompute each step's internals on the backward pass: activation
    # memory O(1) in the horizon instead of O(steps).
    remat: bool = True


def _inv_softplus(y: float) -> float:
    return float(np.log(np.expm1(y)))


def init_params(gamma: float = 0.5, dmin: float = 0.2, k: float = 0.1, *,
                device=None) -> TunableParams:
    """The reference's gamma/dmin (cbf.py:6,16) and a small k, as float32
    0-dim tensors on ``device`` (None = the card)."""
    dev = swarm_scenario.resolve_device(device)
    return TunableParams(*(torch.tensor(_inv_softplus(v), dtype=torch.float32,
                                        device=dev)
                           for v in (gamma, dmin, k)))


def params_to_cbf(p: TunableParams, max_speed) -> CBFParams:
    sp = torch.nn.functional.softplus
    return CBFParams(max_speed=max_speed, dmin=sp(p.dmin_raw),
                     k=sp(p.k_raw), gamma=sp(p.gamma_raw))


def _mesh_sp(mesh) -> int:
    """sp of a ``(dp, sp)`` pair (None: one member group, sp 1); dp folds
    into the member axis on one card."""
    if mesh is None:
        return 1
    dp, sp = mesh
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh must be a (dp, sp) pair of positive ints, "
                         f"got {mesh!r}")
    return int(sp)


def _validated_loss_parts(cfg: swarm_scenario.Config, mesh,
                          tc: TrainConfig = TrainConfig()):
    """The JAX package's rejections for the differentiable path, then the
    per-member loss."""
    if cfg.certificate and \
            swarm_scenario.certificate_backend(cfg) != "sparse":
        raise NotImplementedError(
            "certificate=True training requires the SPARSE backend "
            "(solvers.sparse_admm: scan-based iterations with a "
            "finite-difference-validated gradient — "
            "tests/test_sparse_certificate.py); the dense backend's "
            "fori_loop solver is not reverse-differentiable. Set "
            "certificate_backend='sparse' (any n) or train with "
            "certificate=False (filter parameters transfer; the second "
            "layer is parameter-free)")
    if cfg.gating_rebuild_skin or cfg.certificate_rebuild_skin:
        raise ValueError(
            "the Verlet caches (gating_rebuild_skin / "
            "certificate_rebuild_skin) are not supported on the "
            "differentiable trainer path (the rebuild cond has no "
            "gradient) — train with both at 0; the tuned parameters "
            "transfer (the caches change neighbor SELECTION only, and "
            "only above truncation density)")
    if cfg.certificate_warm_start or cfg.certificate_tol is not None:
        raise ValueError(
            "certificate_warm_start/certificate_tol are not supported on "
            "the differentiable trainer path (the warm-start carry is "
            "data, not a differentiable input, and the adaptive budget's "
            "while_loop has no reverse rule) — train with both off; the "
            "tuned parameters transfer (both knobs change solver "
            "ITERATION SCHEDULING only, never the certified solution the "
            "residual gate asserts)")
    if cfg.certificate_fused:
        raise ValueError(
            "certificate_fused is not supported on the differentiable "
            "trainer path: the fused x-update differentiates through the "
            "unrolled Chebyshev scan instead of the CG path's validated "
            "implicit gradient — train with it off; the tuned parameters "
            "transfer (the fused path changes iteration STRUCTURE, not "
            "the certified solution the residual gate asserts)")
    sp = _mesh_sp(mesh)
    if cfg.gating == "streaming" and not (sp == 1 and knn.supported(cfg.n)):
        raise ValueError(
            "gating='streaming' on the trainer path requires sp == 1 and "
            "N within the kernels' bound (the forced kernel lives on the "
            "whole-swarm-per-member branch)")
    if sp != 1:
        raise OutOfSliceError("the agent-sharded trainer (sp > 1)",
                              SLICE_PARALLEL)
    return _member_loss(cfg, tc)


def _member_loss(cfg: swarm_scenario.Config, tc: TrainConfig):
    """loss(params, x0, v0[, theta0]) of one member: the mean over the
    horizon of the tracking term plus the weighted separation hinge."""
    unicycle = cfg.dynamics == "unicycle"

    def one(params: TunableParams, *state0):
        max_speed = swarm_scenario.default_cbf(
            cfg, device=state0[0].device).max_speed
        cbf = params_to_cbf(params, max_speed)

        def body(x, v, th, t):
            x2, v2, th2, _, nearest = _local_swarm_step(
                x, v, cfg, cbf, unroll_relax=tc.unroll_relax,
                compute_metrics=False, t=t, theta=th)[:5]
            # Hinge on separation: per-agent nearest-neighbour distance
            # below the target (clipped to the gating radius when no
            # neighbour is in range).
            near = torch.clamp(nearest, max=cfg.safety_distance)
            viol = torch.clamp(tc.separation_target - near, min=0.0)
            sep = torch.sum(viol ** 2) / cfg.n
            # Tracking: mean squared stand-off from the packing disk.
            c = torch.sum(x2, dim=0) / cfg.n
            d_c = safe_norm(x2 - c[None], dim=1)
            track = torch.sum(torch.clamp(d_c - cfg.pack_radius,
                                          min=0.0) ** 2) / cfg.n
            return x2, v2, th2, track + tc.safety_weight * sep

        x, v = state0[0], state0[1]
        th = state0[2] if unicycle else None
        losses = []
        for t in range(tc.steps):
            if tc.remat:
                x, v, th, loss_t = checkpoint(body, x, v, th, t,
                                              use_reentrant=False)
            else:
                x, v, th, loss_t = body(x, v, th, t)
            losses.append(loss_t)
        return torch.mean(torch.stack(losses))

    def loss(params: TunableParams, *state0):
        E = state0[0].shape[0]
        per_member = [one(params, *(s[e] for s in state0))
                      for e in range(E)]
        return torch.sum(torch.stack(per_member)) / E

    return loss


def make_loss_fn(cfg: swarm_scenario.Config, mesh=None,
                 tc: TrainConfig = TrainConfig()):
    """loss(params, *state0) -> 0-dim tensor. ``state0`` is (x0, v0) of
    (E, N, 2) tensors, plus an (E, N) theta0 in unicycle mode
    (:func:`cbf_tpu_torch.parallel.ensemble.ensemble_initial_states`).
    ``mesh``: None or a (dp, sp) pair; sp > 1 raises."""
    return _validated_loss_parts(cfg, mesh, tc)


def make_loss_and_grad_fn(cfg: swarm_scenario.Config, mesh=None,
                          tc: TrainConfig = TrainConfig()):
    """value_and_grad(params, *state0) -> (loss, TunableParams of grads):
    one forward over every member and one backward."""
    loss_fn = _validated_loss_parts(cfg, mesh, tc)

    def value_and_grad(params: TunableParams, *state0):
        leaves = TunableParams(*(p.detach().requires_grad_()
                                 for p in params))
        with torch.enable_grad():
            loss = loss_fn(leaves, *state0)
            grads = torch.autograd.grad(loss, list(leaves))
        return loss.detach(), TunableParams(*grads)

    return value_and_grad


class AdamState(NamedTuple):
    """The optimizer's state: its leaf tensors and ``torch.optim.Adam``."""
    params: TunableParams
    adam: torch.optim.Adam


class Adam:
    """``optax.adam(lr)``'s role: ``init(params)`` gives the state that
    :func:`make_train_step`'s step threads."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params: TunableParams) -> AdamState:
        leaves = TunableParams(*(p.detach().clone().requires_grad_()
                                 for p in params))
        return AdamState(leaves, torch.optim.Adam(
            list(leaves), lr=self.learning_rate, betas=(0.9, 0.999),
            eps=1e-8))


def make_train_step(cfg: swarm_scenario.Config, mesh=None,
                    tc: TrainConfig = TrainConfig()):
    """(train_step, optimizer). ``train_step(params, opt_state, *state) ->
    (params, opt_state, loss)``: the rollout loss over every member, its
    backward, one Adam update. Initialize with ``optimizer.init(params)``
    (the returned optimizer's, so rule and state match)."""
    loss_fn = _validated_loss_parts(cfg, mesh, tc)
    optimizer = Adam(tc.learning_rate)

    def train_step(params: TunableParams, opt_state: AdamState, *state):
        leaves, adam = opt_state
        with torch.no_grad():
            for leaf, p in zip(leaves, params):
                leaf.copy_(p)
        adam.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(leaves, *state)
            loss.backward()
        adam.step()
        new = TunableParams(*(leaf.detach().clone() for leaf in leaves))
        return new, opt_state, loss.detach()

    return train_step, optimizer
