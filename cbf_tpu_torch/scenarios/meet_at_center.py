"""Scenario 1: rendezvous through a ring of cyclic-pursuit obstacles
(counterpart: cbf_tpu/scenarios/meet_at_center.py).

10 robots of the reference ``meet_at_center.py``: agents 0-4 cyclic-pursue
on a circle (the moving obstacles), agents 5-9 rendezvous by
complete-graph consensus, each free agent's control passed through the
CBF filter against every in-radius obstacle and fellow agent. The
1000-iteration loop is the compiled rollout.

Details kept from the reference (line numbers in its meet_at_center.py):
- initial circles: obstacles on a 0.7-diameter circle, free agents 1.5x
  out, headings theta + 2/3 pi (:37-48)
- obstacle law: ring-Laplacian consensus rotated by -pi/5 (:65-71, :89-96)
- free law: complete-graph consensus (:74, :99-103)
- CBF inputs: 4-D states = [pose positions ; commanded velocities]
  (:114), f = 0.1*0, g = 0.1*[[1,0],[0,1],[0,0],[0,0]] (:26-27), danger
  radius 0.2 with self-exclusion via distance > 0 (:117-133), the filter
  applied only to free agents and only when the danger set is non-empty
  (:118, :136-143)
- the joint barrier certificate is created but not applied (:108-109)
- loop tail: si-to-uni map, actuator saturation, unicycle step (:148-153)

The step is capture-safe: the free agents' filtered controls rejoin the
obstacles' by a concatenation (the JAX package's ``.at[:, free].set``),
and every constant is built on the device in :func:`make`.

Run headless: ``python -m cbf_tpu_torch.scenarios.meet_at_center
[--device cpu]``.
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
from cbf_tpu_torch.rollout.gating import danger_slab
from cbf_tpu_torch.scenarios.swarm import resolve_device
from cbf_tpu_torch.sim import (SimParams, adjacency_from_laplacian,
                               complete_gl, consensus_velocities, cycle_gl,
                               cyclic_pursuit_velocities, si_to_uni_dyn,
                               uni_to_si_states, unicycle_step)

# Guarded relax rounds the compiled step captures: the deepest relax of
# any step of the default 1000-iteration run (PERF.md §6, PR 9).
RELAX_ROUNDS = 1


@dataclasses.dataclass(frozen=True)
class Config:
    """Scenario knobs (the reference hard-codes all of these)."""
    n_obstacles: int = 5
    n_free: int = 5
    iterations: int = 1000
    diameter: float = 0.7
    safety_distance: float = 0.2       # danger gating radius (:117)
    max_speed: float = 15.0            # (:25)
    dyn_scale: float = 0.1             # the 0.1 factor on f, g (:26-27)
    record_trajectory: bool = True
    dtype: torch.dtype = torch.float32

    @property
    def n(self) -> int:
        return self.n_obstacles + self.n_free


class State(NamedTuple):
    poses: torch.Tensor   # (3, N)


def initial_poses(cfg: Config) -> np.ndarray:
    """Reference initial conditions (:37-48), transposed to (3, N)."""
    ic = np.zeros((cfg.n, 3))
    for i in range(cfg.n_obstacles):
        th = i * (2 * np.pi / cfg.n_obstacles)
        ic[i] = [cfg.diameter * np.cos(th), cfg.diameter * np.sin(th),
                 th + 2 / 3 * np.pi]
    for i in range(cfg.n_obstacles, cfg.n):
        th = i * (2 * np.pi / cfg.n_obstacles) + np.pi / cfg.n_obstacles
        ic[i] = [1.5 * cfg.diameter * np.cos(th),
                 1.5 * cfg.diameter * np.sin(th), th + 2 / 3 * np.pi]
    return ic.T


def filter_dynamics(dyn_scale: float, dtype, device):
    """The reference's (f, g) for the filter: a single integrator carried
    in a 4-D state, scaled by ``dyn_scale``."""
    f = dyn_scale * torch.zeros((4, 4), dtype=dtype, device=device)
    g = dyn_scale * torch.as_tensor([[1, 0], [0, 1], [0, 0], [0, 0]],
                                    dtype=dtype, device=device)
    return f, g


def make(cfg: Config = Config(), sim: SimParams = SimParams(),
         cbf: CBFParams | None = None, *, device=None):
    """(initial State, step) on ``device`` (None = the card; without one
    this raises — pass ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    if cbf is None:
        cbf = CBFParams(max_speed=cfg.max_speed)
    n_obs, n_free = cfg.n_obstacles, cfg.n_free
    dt = cfg.dtype

    A_ring = adjacency_from_laplacian(cycle_gl(n_obs), dtype=dt, device=dev)
    A_full = adjacency_from_laplacian(complete_gl(n_free), dtype=dt,
                                      device=dev)
    theta = -np.pi / n_obs
    f, g = filter_dynamics(cfg.dyn_scale, dt, dev)

    # Candidate rows under the reference's `distance > 0` self-exclusion:
    # the fellow-agent block, not the obstacle block (:124-133).
    exclude_self = torch.cat([torch.zeros(n_obs, dtype=torch.bool),
                              torch.ones(n_free, dtype=torch.bool)]).to(dev)

    state0 = State(poses=torch.as_tensor(initial_poses(cfg), dtype=dt,
                                         device=dev))

    def step(state: State, t):
        poses = state.poses
        x_si = uni_to_si_states(poses, sim.projection_distance)

        # Nominal control laws (:86-103).
        v_obs = cyclic_pursuit_velocities(x_si[:, :n_obs], A_ring, theta)
        v_free = consensus_velocities(x_si[:, n_obs:], A_full)
        si_velocities = torch.cat([v_obs, v_free], dim=1)          # (2, N)

        # CBF filtering of the free agents (:112-143). 4-D states pair the
        # pose positions with the commanded velocities (:114).
        states4 = torch.cat([poses[:2], si_velocities], dim=0).T   # (N, 4)
        agent_states = states4[n_obs:]
        obs_slab, mask = danger_slab(agent_states, states4,
                                     cfg.safety_distance, exclude_self)
        u0 = v_free.T                                        # (n_free, 2)
        u_safe, info = safe_controls(agent_states, obs_slab, mask, f, g,
                                     u0, cbf)
        engaged = torch.any(mask, dim=1)                           # (n_free,)
        u_final = torch.where(engaged[:, None], u_safe, u0)
        si_velocities = torch.cat([v_obs, u_final.T], dim=1)

        # Loop tail (:148-153).
        dxu = si_to_uni_dyn(si_velocities, poses, sim.projection_distance)
        new_poses = unicycle_step(poses, dxu, sim)

        out = StepOutputs(
            min_pairwise_distance=min_pairwise_distance(poses[:2]),
            filter_active_count=torch.sum(engaged, dtype=torch.int32),
            infeasible_count=torch.sum(~info.feasible & engaged,
                                       dtype=torch.int32),
            max_relax_rounds=torch.amax(info.relax_rounds),
            trajectory=poses[:2] if cfg.record_trajectory else (),
        )
        return State(poses=new_poses), out

    step.relax_rounds = RELAX_ROUNDS
    return state0, step


def run(cfg: Config = Config(), *, device=None, **kw):
    state0, step = make(cfg, device=device, **kw)
    return rollout(step, state0, cfg.iterations)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run meet_at_center headless and print a summary.")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    cfg = Config()
    final, outs = run(cfg, device=args.device)
    md = outs.min_pairwise_distance.cpu().numpy()
    spread = float(min_pairwise_distance(final.poses[:2, cfg.n_obstacles:]))
    print(f"meet_at_center: {cfg.iterations} steps, N={cfg.n}")
    print(f"  min pairwise distance over run: {md.min():.4f} m")
    print(f"  final free-agent spread: {spread:.4f} m")
    print(f"  filter engaged on {int(outs.filter_active_count.sum())} "
          f"agent-steps; infeasible {int(outs.infeasible_count.sum())}")


if __name__ == "__main__":
    main()
