"""Scenario 4: antipodal position swap — the classic CBF stress test
(counterpart: cbf_tpu/scenarios/antipodal.py).

N agents start on a circle and swap to their antipodal points, so every
straight-line path crosses the centre at once: the densest sustained
filter engagement. A counter-clockwise bias rotates the nominal go-to-goal
command (``swirl``), plus an engagement-adaptive term (``swirl_engaged``)
for agents whose gating mask is live; the safety layer is untouched. The
JAX package's docstring records, at N=32, all 32 agents reaching their
antipodes with the adaptive term and 28 without it.

Gating is the plain top-k path (:func:`cbf_tpu_torch.rollout.gating.
knn_gating`), as the JAX scenario takes the jnp top-k, not a Pallas
kernel.

Run headless: ``python -m cbf_tpu_torch.scenarios.antipodal
[--device cpu]``; or ``python -m cbf_tpu_torch run antipodal --video
swap.gif``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cbf_tpu_torch.core.filter import CBFParams, safe_controls
from cbf_tpu_torch.rollout.engine import (StepOutputs, min_pairwise_distance,
                                          rollout)
from cbf_tpu_torch.rollout.gating import knn_gating
from cbf_tpu_torch.scenarios.meet_at_center import filter_dynamics
from cbf_tpu_torch.scenarios.swarm import resolve_device
from cbf_tpu_torch.sim.controllers import si_position_controller

# Guarded relax rounds the compiled step captures: the deepest relax of
# any step of the default 1500-step run at N=32 (PERF.md §6, PR 9).
RELAX_ROUNDS = 0


@dataclasses.dataclass(frozen=True)
class Config:
    n: int = 32
    steps: int = 1500
    k_neighbors: int = 8
    safety_distance: float = 0.4
    # Circle radius scales with N so the start ring itself is
    # collision-free (arc spacing >= 0.3 m).
    min_radius: float = 1.2
    speed_limit: float = 0.15
    goal_gain: float = 1.0
    # Counter-clockwise nominal-command bias (radians); 0 disables.
    swirl: float = 0.35
    # Extra swirl for agents whose gating mask is live (the right-hand
    # rule): blocked agents rotate harder around the blocker.
    swirl_engaged: float = 0.4
    # Deterministic per-agent angular spawn jitter (fraction of the agent
    # spacing), off by default.
    spawn_jitter: float = 0.0
    seed: int = 0
    max_speed: float = 15.0
    dyn_scale: float = 0.1             # reference dynamics scale
    dt: float = 0.033
    record_trajectory: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def circle_radius(self) -> float:
        return max(self.min_radius, 0.3 * self.n / (2 * np.pi))


class State(NamedTuple):
    x: torch.Tensor     # (N, 2)
    v: torch.Tensor     # (N, 2) previous filtered velocities


def initial_state(cfg: Config, *, device=None) -> State:
    """Start on the circle (the optional jitter drawn by numpy, as the JAX
    package draws it), at rest."""
    th = 2 * np.pi * np.arange(cfg.n) / cfg.n
    spacing = 2 * np.pi / cfg.n
    rng = np.random.default_rng(cfg.seed)
    th = th + cfg.spawn_jitter * spacing * rng.uniform(-0.5, 0.5, cfg.n)
    x0 = cfg.circle_radius * np.stack([np.cos(th), np.sin(th)], axis=1)
    dev = resolve_device(device)
    return State(x=torch.as_tensor(x0, dtype=cfg.dtype, device=dev),
                 v=torch.zeros((cfg.n, 2), dtype=cfg.dtype, device=dev))


def goals(cfg: Config, *, device=None) -> torch.Tensor:
    """(N, 2): each agent's antipodal point (of the start position rounded
    to the dtype, as the JAX package negates its stored start)."""
    return -initial_state(cfg, device=device).x


def make(cfg: Config = Config(), cbf: CBFParams | None = None, *,
         device=None):
    """(initial State, step) on ``device`` (None = the card; without one
    this raises — pass ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    if cbf is None:
        cbf = CBFParams(max_speed=cfg.max_speed, k=0.0)
    dt_ = cfg.dtype
    f, g = filter_dynamics(cfg.dyn_scale, dt_, dev)
    K = min(cfg.k_neighbors, cfg.n - 1)
    target_t = goals(cfg, device=dev).T                       # (2, N)
    exclude_self = torch.ones(cfg.n, dtype=torch.bool, device=dev)

    state0 = initial_state(cfg, device=dev)

    def step(state: State, t):
        x = state.x
        states4 = torch.cat([x, state.v], dim=1)
        obs_slab, mask, dropped = knn_gating(
            states4, states4, cfg.safety_distance, K,
            exclude_self_row=exclude_self, with_dropped=True)
        engaged = torch.any(mask, dim=1)

        u0 = si_position_controller(x.T, target_t, cfg.goal_gain,
                                    cfg.speed_limit).T          # (N, 2)
        # Per-agent swirl: base bias plus the engagement-adaptive term.
        ang = cfg.swirl + cfg.swirl_engaged * engaged.to(dt_)
        c, s = torch.cos(ang), torch.sin(ang)
        u0 = torch.stack([c * u0[:, 0] - s * u0[:, 1],
                          s * u0[:, 0] + c * u0[:, 1]], dim=1)

        u_safe, info = safe_controls(states4, obs_slab, mask, f, g, u0, cbf)
        u = torch.where(engaged[:, None], u_safe, u0)

        x_new = x + cfg.dt * u
        out = StepOutputs(
            min_pairwise_distance=min_pairwise_distance(x.T),
            filter_active_count=torch.sum(engaged, dtype=torch.int32),
            infeasible_count=torch.sum(~info.feasible & engaged,
                                       dtype=torch.int32),
            max_relax_rounds=torch.amax(info.relax_rounds),
            trajectory=x if cfg.record_trajectory else (),
            gating_dropped_count=torch.sum(dropped, dtype=torch.int32),
        )
        return State(x=x_new, v=u), out

    step.relax_rounds = RELAX_ROUNDS
    return state0, step


def run(cfg: Config = Config(), *, device=None, **kw):
    state0, step = make(cfg, device=device, **kw)
    return rollout(step, state0, cfg.steps)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run the antipodal swap headless and print a summary.")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    cfg = Config()
    final, outs = run(cfg, device=args.device)
    d_goal = torch.linalg.norm(final.x - goals(cfg, device=final.x.device),
                               dim=1).cpu().numpy()
    md = float(outs.min_pairwise_distance.min())
    print(f"antipodal swap: N={cfg.n}, {cfg.steps} steps")
    print(f"  agents within 0.2 m of antipode: {(d_goal < 0.2).sum()}/{cfg.n}"
          f" (mean residual {d_goal.mean():.3f} m)")
    print(f"  min pairwise distance over run: {md:.4f} m "
          f"(L1 barrier floor {0.2 / np.sqrt(2):.4f})")
    print(f"  filter engaged {int(outs.filter_active_count.sum())}"
          f" agent-steps; infeasible {int(outs.infeasible_count.sum())}")


if __name__ == "__main__":
    main()
