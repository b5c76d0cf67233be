"""The ensemble step with each member's whole swarm on one device
(counterpart: cbf_tpu/parallel/ensemble.py).

The JAX package runs Monte-Carlo members of the swarm over a (dp, sp)
mesh; on one card dp folds into the member axis and sp is 1, so each
member's step is :func:`_local_swarm_step`'s whole-swarm branch in its
differentiable form: the k-NN kernels' zero-gradient selection
(:func:`knn.knn_gating_pallas_diff`) where :func:`knn.supported`, the
dense search beyond, the filter, the joint certificate per member,
integration. The trainer (:mod:`cbf_tpu_torch.learn.tuning`)
differentiates through it.

Not ported (the ensembles and partitioning slice, ROADMAP.md item 10):
agent sharding (sp > 1, the exchange search) and
``sharded_swarm_rollout`` with the step metrics, Verlet cache,
certificate warm carry and lockstep certificate only it threads.
"""

from __future__ import annotations

import torch

from cbf_tpu_torch.core.filter import CBFParams, safe_controls
from cbf_tpu_torch.errors import SLICE_PARALLEL, OutOfSliceError
from cbf_tpu_torch.ops import knn
from cbf_tpu_torch.rollout.gating import knn_gating
from cbf_tpu_torch.scenarios import swarm as swarm_scenario
from cbf_tpu_torch.utils.math import safe_norm


def ensemble_initial_states(cfg: swarm_scenario.Config, seeds, *,
                            device=None):
    """(E, N, 2) positions and (E, N, 2) zero velocities, one spawn per
    seed (the scenario's spawn and obstacle-clearing push), plus (E, N)
    seeded headings in unicycle mode. The port's spawn jitter is its own
    stream (:func:`swarm_scenario.spawn_positions`); carry a JAX state
    across with :mod:`cbf_tpu_torch.convert` for parity."""
    dev = swarm_scenario.resolve_device(device)
    x0 = torch.stack([swarm_scenario.clear_obstacle_spawn(
        cfg, swarm_scenario.spawn_positions(cfg, int(s), device=dev))
        for s in seeds])
    if cfg.dynamics == "unicycle":
        theta0 = torch.stack([swarm_scenario.heading_spawn(cfg, int(s),
                                                           device=dev)
                              for s in seeds])
        return x0, torch.zeros_like(x0), theta0
    return x0, torch.zeros_like(x0)


def _local_swarm_step(x, v, cfg: swarm_scenario.Config, cbf: CBFParams,
                      unroll_relax: int = 2, t=0, theta=None):
    """One member's whole-swarm step (the JAX step at sp size 1 with
    ``compute_metrics=False``), differentiable with ``unroll_relax > 0``.
    x, v: (N, 2); ``theta`` (N,) in unicycle mode (``x`` is then the body
    centre and the filter works on the projection points); ``t`` the
    global step (the obstacle ring is closed-form in it).

    Returns (x_new, v_new, theta_new or None, nearest1 (N,) — the gated
    nearest distance, inf with nothing in radius)."""
    dt_ = x.dtype
    dev = x.device
    f, g, discrete = swarm_scenario.barrier_dynamics(cfg, dt_, device=dev)
    K = min(cfg.k_neighbors, cfg.n - 1)
    M = cfg.n_obstacles

    unicycle = cfg.dynamics == "unicycle"
    body = x
    if unicycle:
        x = swarm_scenario.projection_points(cfg, body, theta)

    mean = torch.sum(x, dim=0) / cfg.n
    to_c = mean[None] - x
    d_c = safe_norm(to_c, keepdim=True)
    pull = torch.clamp(d_c - cfg.pack_radius, min=0.0)
    u0 = cfg.consensus_gain * pull * to_c / torch.clamp(d_c, min=1e-9)
    if M:
        obstacles4 = swarm_scenario.obstacle_states_at(cfg, t, dt_,
                                                       device=dev)
        dodge, d_o = swarm_scenario.lane_dodge(x, obstacles4,
                                               cfg.safety_distance)
        u0 = u0 + 2.0 * dodge
    double = cfg.dynamics == "double"
    vslots = v if (double or not discrete) else torch.zeros_like(v)
    states4 = torch.cat([x, vslots], dim=1)
    if knn.supported(cfg.n):
        # The kernels select, torch recomputes what the loss differentiates;
        # "streaming" forces the streaming kernel (honored or rejected:
        # never the auto choice under a streaming label).
        obs_slab, mask, nearest1, _ = knn.knn_gating_pallas_diff(
            states4, cfg.safety_distance, K,
            kernel="streaming" if cfg.gating == "streaming" else "auto")
    else:
        obs_slab, mask = knn_gating(
            states4, states4, cfg.safety_distance, K,
            exclude_self_row=torch.ones(cfg.n, dtype=torch.bool, device=dev))
        d = safe_norm(x[:, None, :] - obs_slab[..., :2], dim=-1)
        nearest1 = torch.amin(torch.where(mask, d, torch.inf), dim=1)

    u0 = swarm_scenario.complete_nominal(cfg, u0, x, v, obs_slab, mask)

    priority = None
    if M:
        obs_slab, mask, priority = swarm_scenario.attach_obstacle_rows(
            obs_slab, mask, obstacles4, d_o, cfg.safety_distance)
        nearest1 = torch.minimum(nearest1, torch.amin(d_o, dim=1))

    priority, cap = swarm_scenario.relax_tiers(cfg, mask, priority)
    plain_box = double or unicycle
    u_safe, _ = safe_controls(
        states4, obs_slab, mask, f, g, u0, cbf,
        unroll_relax=unroll_relax,
        priority_mask=priority, relax_cap=cap,
        reference_layout=not plain_box, vel_box_rows=not plain_box)
    u = torch.where(torch.any(mask, dim=1)[:, None], u_safe, u0)
    if cfg.certificate:
        u = swarm_scenario.apply_certificate(cfg, u, x)[0]

    if unicycle:
        x_new, theta_new, p_new = swarm_scenario.unicycle_apply(
            cfg, body, theta, u)
        return x_new, (p_new - x) / cfg.dt, theta_new, nearest1
    x_new, v_new = swarm_scenario.integrate(cfg, x, v, u)
    return x_new, v_new, None, nearest1


def sharded_swarm_rollout(*args, **kwargs):
    """The (dp, sp)-sharded ensemble rollout: not ported yet."""
    raise OutOfSliceError("sharded_swarm_rollout", SLICE_PARALLEL)
