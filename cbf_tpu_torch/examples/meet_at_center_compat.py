"""Reference scenario 1 on the migration layer: cyclic-pursuit obstacles +
CBF-protected rendezvous (counterpart: examples/meet_at_center_compat.py).

Mirrors the structure of the reference ``meet_at_center.py`` — 10 robots,
robots 0-4 cyclic-pursuing a circle via a ring Laplacian, robots 5-9
rendezvousing by complete-graph consensus, each free agent's command
filtered through the CBF-QP when anything is within the 0.2 m danger
radius — written against ``cbf_tpu_torch.compat`` only, the way a user
migrating from the reference stack would (imports changed, loop body
kept). Every compat call crosses host<->device; the batched equivalent is
``cbf_tpu_torch.scenarios.meet_at_center``.

Run: ``python -m cbf_tpu_torch.examples.meet_at_center_compat
[--steps 1000] [--video out.gif] [--show] [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from cbf_tpu_torch.compat import (
    ControlBarrierFunction,
    Robotarium,
    completeGL,
    create_si_to_uni_mapping,
    topological_neighbors,
)

# Dynamics the reference passes to the filter (meet_at_center.py:26-27):
# single-integrator carried in a 4-D state, scaled by 0.1.
F_DYN = 0.1 * np.zeros((4, 4))
G_DYN = 0.1 * np.array([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0], [0.0, 0.0]])

N = 10                      # meet_at_center.py:31
HALF = N // 2
DANGER_RADIUS = 0.2         # meet_at_center.py:117
PURSUIT_THETA = -np.pi / HALF  # meet_at_center.py:92


def ring_laplacian(n: int) -> np.ndarray:
    """Directed ring (the shape hand-written at meet_at_center.py:65-71)."""
    L = -np.eye(n)
    for i in range(n):
        L[i, (i + 1) % n] = 1.0
    return L


def initial_conditions() -> np.ndarray:
    """Obstacles on a 0.7-diameter circle, free agents on a 1.5x concentric
    circle (meet_at_center.py:37-48)."""
    ic = np.zeros((3, N))
    for i in range(HALF):
        th = 2 * np.pi * i / HALF
        ic[:, i] = [0.35 * np.cos(th), 0.35 * np.sin(th), th]
        ic[:, HALF + i] = [0.525 * np.cos(th), 0.525 * np.sin(th), th]
    return ic


def main(steps: int = 1000, video: str | None = None,
         show_figure: bool = False, device=None) -> np.ndarray:
    """Run ``steps`` steps on ``device`` (None = the card) and return the
    final (3, N) poses; ``video`` replays the recorded positions."""
    r = Robotarium(number_of_robots=N, show_figure=show_figure,
                   initial_conditions=initial_conditions(), device=device)
    cbf = ControlBarrierFunction(15, device=device)  # meet_at_center.py:25
    si_to_uni_dyn, uni_to_si_states = create_si_to_uni_mapping(
        device=device)
    L_ring = ring_laplacian(HALF)
    L_full = completeGL(HALF)

    rot = np.array([[np.cos(PURSUIT_THETA), -np.sin(PURSUIT_THETA)],
                    [np.sin(PURSUIT_THETA), np.cos(PURSUIT_THETA)]])

    traj = []
    for _ in range(steps):
        x = r.get_poses()
        x_si = uni_to_si_states(x)
        traj.append(x[:2].copy())
        dxi = np.zeros((2, N), np.float32)

        # Obstacle ring: rotated consensus (meet_at_center.py:86-96).
        for i in range(HALF):
            for j in topological_neighbors(L_ring, i):
                dxi[:, i] += x_si[:, j] - x_si[:, i]
            dxi[:, i] = rot @ dxi[:, i]
        # Free agents: complete-graph consensus (meet_at_center.py:99-103).
        for i in range(HALF, N):
            for j in topological_neighbors(L_full, i - HALF):
                dxi[:, i] += x_si[:, HALF + j] - x_si[:, i]
        dxi *= 0.05

        # 4-D states = positions ++ commanded velocities
        # (meet_at_center.py:114 — commanded, not measured).
        states = np.concatenate([x_si, dxi]).T

        # Danger gating + per-agent filter (meet_at_center.py:118-143).
        for i in range(HALF, N):
            danger = [
                states[j] for j in range(N)
                if j != i
                and np.linalg.norm(states[j, :2] - states[i, :2]) < DANGER_RADIUS
            ]
            if danger:
                dxi[:, i] = cbf.get_safe_control(states[i], danger,
                                                 F_DYN, G_DYN, dxi[:, i])

        r.set_velocities(np.arange(N), si_to_uni_dyn(dxi, x))
        r.step()

    final = r.get_poses()
    center_spread = np.linalg.norm(final[:2, HALF:]
                                   - final[:2, HALF:].mean(1, keepdims=True),
                                   axis=0).mean()
    print(f"meet_at_center (compat): free-agent spread about their centroid "
          f"after {steps} steps: {center_spread:.3f} m")
    r.call_at_scripts_end()

    if video:
        from cbf_tpu_torch.render import render_meet_at_center
        render_meet_at_center(np.stack(traj), video, n_obstacles=HALF,
                              stride=max(1, steps // 300))
        print(f"video written to {video}")
    return final


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--video", type=str, default=None)
    p.add_argument("--show", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    a = p.parse_args()
    main(a.steps, a.video, a.show, a.device)
