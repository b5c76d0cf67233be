"""Scenario 2: leader-follower crossing of a rotating obstacle ring
(counterpart: cbf_tpu/scenarios/cross_and_rescue.py).

4 robots of the reference ``cross_and_rescue.py`` cross a ring of 6
virtual obstacles (pure state, not robots) cyclic-pursuing around the
origin, toward a goal at (1.5, 0), with a two-layer safety stack: the CBF
filter, then the joint barrier certificate (the dense ADMM backend,
:func:`cbf_tpu_torch.sim.certificates.si_barrier_certificate`, 250
iterations on a Cholesky factor, all on the device). The recorded
trajectory replays through :mod:`cbf_tpu_torch.render`.

Details kept from the reference (line numbers in its cross_and_rescue.py):
- robots start on a 0.6*0.6-diameter circle at x - 1.15 (:51-53);
  obstacles on a 0.6-diameter ring (:48-50)
- obstacle law: ring consensus rotated by -pi/6, scaled 0.05 (:107-118),
  integrated by explicit Euler with T = 1/30 (:68, :173)
- goal-column trick: the goal is a virtual 5th consensus node wired by a
  hand-written directed Laplacian; its zero row keeps it static (:89-95,
  :102)
- a static virtual obstacle at the origin joins the obstacle set every
  step (:130-131) and is trimmed back off before integration (:173)
- CBF gating as in scenario 1 (0.2 m radius, self-exclusion) over
  obstacles ++ robots (:134-150); then the joint certificate on the
  robots (:162-163)
- 3000 iterations (:67)

Run headless: ``python -m cbf_tpu_torch.scenarios.cross_and_rescue
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
from cbf_tpu_torch.scenarios.meet_at_center import filter_dynamics
from cbf_tpu_torch.scenarios.swarm import resolve_device
from cbf_tpu_torch.sim import (CertificateParams, SimParams,
                               adjacency_from_laplacian, consensus_velocities,
                               cycle_gl, cyclic_pursuit_velocities,
                               si_barrier_certificate, si_to_uni_dyn,
                               uni_to_si_states, unicycle_step)

# The reference's hand-written directed Laplacian wiring robot 0 to the goal
# (node 4) and robots 1-3 leader-follower (:89-95). Kept verbatim as data.
L2_GOAL = np.array(
    [
        [-1, 0, 0, 0, 1],
        [1, -2, 0, 1, 0],
        [1, 1, -2, 0, 0],
        [1, 0, 1, -2, 0],
        [0, 0, 0, 0, 0],
    ],
    dtype=np.float64,
)

# Guarded relax rounds the compiled step captures: the deepest relax of
# any step of the default 3000-iteration run (PERF.md §6, PR 9).
RELAX_ROUNDS = 1


@dataclasses.dataclass(frozen=True)
class Config:
    n_robots: int = 4
    n_obstacles: int = 6
    iterations: int = 3000
    diameter: float = 0.6
    goal: tuple = (1.5, 0.0)
    obs_speed_scale: float = 0.05      # (:118)
    obs_dt: float = 1.0 / 30.0         # (:68)
    safety_distance: float = 0.2       # (:134)
    max_speed: float = 15.0            # (:30)
    dyn_scale: float = 0.1             # (:31-32)
    record_trajectory: bool = True
    dtype: torch.dtype = torch.float32


class State(NamedTuple):
    poses: torch.Tensor     # (3, n_robots)
    obs_pos: torch.Tensor   # (2, n_obstacles)


def initial_state(cfg: Config, *, device=None) -> State:
    """Reference initial conditions (:43-57)."""
    robots = np.zeros((cfg.n_robots, 3))
    for i in range(cfg.n_robots):
        th = i * (2 * np.pi / cfg.n_robots)
        robots[i] = [0.6 * cfg.diameter * np.cos(th) - 1.15,
                     0.6 * cfg.diameter * np.sin(th), th + 2 / 3 * np.pi]
    obs = np.zeros((cfg.n_obstacles, 2))
    for i in range(cfg.n_obstacles):
        th = i * (2 * np.pi / cfg.n_obstacles)
        obs[i] = [cfg.diameter * np.cos(th), cfg.diameter * np.sin(th)]
    dev = resolve_device(device)
    return State(poses=torch.as_tensor(robots.T, dtype=cfg.dtype,
                                       device=dev),
                 obs_pos=torch.as_tensor(obs.T, dtype=cfg.dtype, device=dev))


def make(cfg: Config = Config(), sim: SimParams = SimParams(),
         cbf: CBFParams | None = None,
         cert: CertificateParams = CertificateParams(), *, device=None):
    """(initial State, step) on ``device`` (None = the card; without one
    this raises — pass ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    if cbf is None:
        cbf = CBFParams(max_speed=cfg.max_speed)
    nR, nO = cfg.n_robots, cfg.n_obstacles
    dt = cfg.dtype

    A_ring = adjacency_from_laplacian(cycle_gl(nO), dtype=dt, device=dev)
    A_goal = adjacency_from_laplacian(L2_GOAL, dtype=dt, device=dev)
    theta_obs = -np.pi / nO
    f, g = filter_dynamics(cfg.dyn_scale, dt, dev)
    goal_col = torch.as_tensor(np.array(cfg.goal).reshape(2, 1), dtype=dt,
                               device=dev)
    zero_col = torch.zeros((2, 1), dtype=dt, device=dev)

    # Candidate pool per step: [6 ring obstacles, 1 static origin obstacle,
    # 4 robots] — self-exclusion applies to the robot block only (:141-150).
    exclude_self = torch.cat([torch.zeros(nO + 1, dtype=torch.bool),
                              torch.ones(nR, dtype=torch.bool)]).to(dev)

    state0 = initial_state(cfg, device=dev)

    def step(state: State, t):
        poses, obs_pos = state.poses, state.obs_pos
        x_si = uni_to_si_states(poses, sim.projection_distance)     # (2, nR)
        x_si_goal = torch.cat([x_si, goal_col], dim=1)              # (2, nR+1)

        # Obstacle ring law (:107-118) and robot consensus with the goal
        # column (:121-125; row 4 of L2 is zero so the goal stays put).
        obs_vel = cfg.obs_speed_scale * cyclic_pursuit_velocities(
            obs_pos, A_ring, theta_obs)
        v_all = consensus_velocities(x_si_goal, A_goal)             # (2, nR+1)
        si_velocities = v_all[:, :nR]                               # (2, nR)

        # Obstacle 4-D states: positions ++ commanded velocities, with the
        # static origin obstacle appended (:130-132).
        obs_pos_aug = torch.cat([obs_pos, zero_col], dim=1)
        obs_vel_aug = torch.cat([obs_vel, zero_col], dim=1)
        obstacle_states = torch.cat([obs_pos_aug, obs_vel_aug], dim=0).T
        agent_states = torch.cat([poses[:2], si_velocities], dim=0).T
        pool = torch.cat([obstacle_states, agent_states], dim=0)    # (M, 4)

        obs_slab, mask = danger_slab(agent_states, pool,
                                     cfg.safety_distance, exclude_self)
        u0 = si_velocities.T
        u_safe, info = safe_controls(agent_states, obs_slab, mask, f, g,
                                     u0, cbf)
        engaged = torch.any(mask, dim=1)
        u_final = torch.where(engaged[:, None], u_safe, u0)

        # Second safety layer: the joint certificate (:162-163). Its
        # fixed-iteration ADMM's primal residual rides out in StepOutputs.
        si_velocities, cert_info = si_barrier_certificate(
            u_final.T, x_si, cert, with_info=True)

        dxu = si_to_uni_dyn(si_velocities, poses, sim.projection_distance)
        new_poses = unicycle_step(poses, dxu, sim)
        new_obs = obs_pos + cfg.obs_dt * obs_vel                    # (:173)

        # Safety margin across robots and virtual obstacles.
        everyone = torch.cat([poses[:2], obs_pos_aug], dim=1)
        out = StepOutputs(
            min_pairwise_distance=min_pairwise_distance(everyone),
            filter_active_count=torch.sum(engaged, dtype=torch.int32),
            infeasible_count=torch.sum(~info.feasible & engaged,
                                       dtype=torch.int32),
            max_relax_rounds=torch.amax(info.relax_rounds),
            trajectory=((poses[:2], obs_pos) if cfg.record_trajectory
                        else ()),
            certificate_residual=cert_info.primal_residual,
        )
        return State(poses=new_poses, obs_pos=new_obs), out

    step.relax_rounds = RELAX_ROUNDS
    return state0, step


def run(cfg: Config = Config(), *, device=None, **kw):
    state0, step = make(cfg, device=device, **kw)
    return rollout(step, state0, cfg.iterations)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run cross_and_rescue headless and print a summary.")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    cfg = Config()
    final, outs = run(cfg, device=args.device)
    goal = np.array(cfg.goal)
    dists = np.linalg.norm(final.poses[:2].cpu().numpy().T - goal, axis=1)
    print(f"cross_and_rescue: {cfg.iterations} steps")
    print(f"  robot distances to goal: {np.round(dists, 3)}")
    print(f"  min pairwise distance over run: "
          f"{float(outs.min_pairwise_distance.min()):.4f} m")
    print(f"  filter engaged on {int(outs.filter_active_count.sum())} "
          f"agent-steps; infeasible {int(outs.infeasible_count.sum())}")


if __name__ == "__main__":
    main()
