"""Reference scenario 2 on the migration layer: leader-follower crossing of
a rotating virtual-obstacle ring, with optional video (counterpart:
examples/cross_and_rescue_compat.py).

Mirrors the structure of the reference ``cross_and_rescue.py`` written
against ``cbf_tpu_torch.compat`` only: 4 robots cross a ring of 6 virtual
obstacles (numpy state + scatter markers on ``r.axes``, not simulated
robots) cyclic-pursuing around the origin, toward a goal at (1.5, 0)
wired in as a virtual 5th consensus node (the goal-column Laplacian
trick). A static virtual obstacle sits at the origin. Two-layer safety:
per-agent CBF-QP filter, then the joint barrier certificate. Video
replays the recorded trajectory after the run through
``cbf_tpu_torch.render`` instead of grabbing frames inside the loop. The
markers on ``r.axes`` need matplotlib.

Run: ``python -m cbf_tpu_torch.examples.cross_and_rescue_compat
[--steps 3000] [--video out.gif] [--device cpu]``. The batched
equivalent is ``cbf_tpu_torch.scenarios.cross_and_rescue``.
"""

from __future__ import annotations

import argparse

import numpy as np

from cbf_tpu_torch.compat import (
    ControlBarrierFunction,
    Robotarium,
    create_si_to_uni_mapping,
    create_single_integrator_barrier_certificate_with_boundary,
    determine_marker_size,
    topological_neighbors,
)

F_DYN = 0.1 * np.zeros((4, 4))          # cross_and_rescue.py:31-32
G_DYN = 0.1 * np.array([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0], [0.0, 0.0]])

N_ROBOTS = 4                            # cross_and_rescue.py:36
N_OBS = 6                               # cross_and_rescue.py:37
DIAMETER = 0.6
GOAL = np.array([1.5, 0.0])
DANGER_RADIUS = 0.2                     # cross_and_rescue.py:134
OBS_DT = 1.0 / 30.0                     # cross_and_rescue.py:68

# Directed Laplacian wiring robot 0 to the goal node and robots 1-3
# leader-follower; the zero last row keeps the goal static (:89-95).
L_GOAL = np.array(
    [
        [-1, 0, 0, 0, 1],
        [1, -2, 0, 1, 0],
        [1, 1, -2, 0, 0],
        [1, 0, 1, -2, 0],
        [0, 0, 0, 0, 0],
    ],
    dtype=float,
)


def ring_laplacian(n: int) -> np.ndarray:
    L = -np.eye(n)
    for i in range(n):
        L[i, (i + 1) % n] = 1.0
    return L


def main(steps: int = 3000, video: str | None = None,
         show_figure: bool = False, device=None):
    """Run ``steps`` steps on ``device`` (None = the card) and return the
    final (3, N_ROBOTS) poses; ``video`` replays the recorded positions."""
    # Robots on a small circle offset to x = -1.15 (:51-53); obstacles on a
    # 0.6-diameter ring about the origin (:48-50).
    ic = np.zeros((3, N_ROBOTS))
    for i in range(N_ROBOTS):
        th = 2 * np.pi * i / N_ROBOTS
        ic[:, i] = [0.6 * DIAMETER * np.cos(th) - 1.15,
                    0.6 * DIAMETER * np.sin(th), th + 2 * np.pi / 3]
    obs_pos = np.stack([
        DIAMETER * np.cos(2 * np.pi * np.arange(N_OBS) / N_OBS),
        DIAMETER * np.sin(2 * np.pi * np.arange(N_OBS) / N_OBS),
    ])

    r = Robotarium(number_of_robots=N_ROBOTS, show_figure=show_figure,
                   initial_conditions=ic, device=device)
    cbf = ControlBarrierFunction(15, device=device)  # :30
    si_to_uni_dyn, uni_to_si_states = create_si_to_uni_mapping(
        device=device)
    barrier_cert = create_single_integrator_barrier_certificate_with_boundary(
        safety_radius=0.12, device=device)
    L_ring = ring_laplacian(N_OBS)

    # Obstacle + goal markers on the simulator's axes, exactly how the
    # reference decorates the figure (:62-65).
    obs_markers = r.axes.scatter(obs_pos[0], obs_pos[1],
                                 s=determine_marker_size(r, 0.05), c="C1",
                                 zorder=2)
    r.axes.scatter([0.0], [0.0], s=determine_marker_size(r, 0.05), c="red",
                   zorder=2)
    r.axes.scatter([GOAL[0]], [GOAL[1]], s=determine_marker_size(r, 0.06),
                   c="green", marker="*", zorder=2)

    th_obs = -np.pi / N_OBS
    rot = np.array([[np.cos(th_obs), -np.sin(th_obs)],
                    [np.sin(th_obs), np.cos(th_obs)]])

    robot_traj, obs_traj = [], []
    for _ in range(steps):
        x = r.get_poses()
        x_si = uni_to_si_states(x)
        robot_traj.append(x_si.T.copy())
        obs_traj.append(obs_pos.T.copy())

        # Obstacle ring: rotated consensus, scaled 0.05 (:107-118).
        obs_vel = np.zeros_like(obs_pos)
        for i in range(N_OBS):
            for j in topological_neighbors(L_ring, i):
                obs_vel[:, i] += obs_pos[:, j] - obs_pos[:, i]
            obs_vel[:, i] = rot @ obs_vel[:, i]
        obs_vel *= 0.05

        # Robot consensus incl. the virtual goal column (:100-102,121-125).
        x_goal = np.concatenate([x_si, GOAL.reshape(2, 1)], axis=1)
        dxi = np.zeros((2, N_ROBOTS), np.float32)
        for i in range(N_ROBOTS):
            for j in topological_neighbors(L_GOAL, i):
                dxi[:, i] += x_goal[:, j] - x_goal[:, i]
        dxi *= 0.05

        # Obstacle pool for gating: ring obstacles ++ static origin obstacle
        # (:130-131) ++ fellow robots, all as 4-D pos++vel states.
        obs_aug = np.concatenate([obs_pos, np.zeros((2, 1))], axis=1)
        vel_aug = np.concatenate([obs_vel, np.zeros((2, 1))], axis=1)
        obstacle_states = np.concatenate([obs_aug, vel_aug]).T
        robot_states = np.concatenate([x_si, dxi]).T

        for i in range(N_ROBOTS):
            danger = [
                s for s in obstacle_states
                if np.linalg.norm(s[:2] - robot_states[i, :2]) < DANGER_RADIUS
            ] + [
                robot_states[j] for j in range(N_ROBOTS)
                if j != i
                and np.linalg.norm(robot_states[j, :2] - robot_states[i, :2])
                < DANGER_RADIUS
            ]
            if danger:
                dxi[:, i] = cbf.get_safe_control(robot_states[i], danger,
                                                 F_DYN, G_DYN, dxi[:, i])

        # Second safety layer: the joint certificate (:162-163).
        dxi = barrier_cert(dxi, x_si)

        r.set_velocities(np.arange(N_ROBOTS), si_to_uni_dyn(dxi, x))
        obs_markers.set_offsets(obs_pos.T)            # (:172)
        obs_pos = obs_pos + OBS_DT * obs_vel          # explicit Euler (:173)
        r.step()

    final = r.get_poses()
    dists = np.linalg.norm(final[:2].T - GOAL, axis=1)
    print(f"cross_and_rescue (compat): robot distances to goal after "
          f"{steps} steps: {np.round(dists, 3)}")
    r.call_at_scripts_end()

    if video:
        from cbf_tpu_torch.render import Layer, replay
        replay(
            [
                Layer(np.stack(robot_traj).transpose(0, 2, 1), color="C0",
                      radius=0.05, label="robots"),
                Layer(np.stack(obs_traj).transpose(0, 2, 1), color="C1",
                      radius=0.05, label="obstacles"),
                Layer(GOAL.reshape(2, 1), color="green", radius=0.06,
                      marker="*", label="goal"),
            ],
            video, stride=max(1, steps // 300),
            title="cross_and_rescue (compat)",
        )
        print(f"video written to {video}")
    return final


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--video", type=str, default=None)
    p.add_argument("--show", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    a = p.parse_args()
    main(a.steps, a.video, a.show, a.device)
