"""Drop-in migration layer: the reference's object API over the port
(counterpart: cbf_tpu/compat.py).

The reference stack exposes two object surfaces a migrating user has code
against: the ``ControlBarrierFunction`` class (its cbf.py:5-92) and the
rps Robotarium simulator API it installs (the ``Robotarium`` container,
``create_si_to_uni_mapping``,
``create_single_integrator_barrier_certificate_with_boundary``,
``completeGL``, ``topological_neighbors``, ``determine_marker_size`` and
the position controllers). This module provides each of those names with
the reference's calling conventions, each delegating to the port's
batched torch implementation:

    from cbf_tpu_torch.compat import (
        ControlBarrierFunction, Robotarium, completeGL,
        topological_neighbors, create_si_to_uni_mapping,
        create_single_integrator_barrier_certificate_with_boundary,
    )

    c = ControlBarrierFunction(15)                 # cbf.py-style filter
    r = Robotarium(number_of_robots=10, initial_conditions=ic)
    x = r.get_poses(); r.set_velocities(ids, dxu); r.step()

Numpy arrays in, numpy arrays out, in float32. The objects and factories
take a keyword ``device`` (None means the card, and raises without one;
pass ``device="cpu"`` for the CPU), and every call copies its inputs to
that device and its result back: a host<->device round trip per call,
the documented cost of this layer. The fast path is the functional stack
(``cbf_tpu_torch.core.filter.safe_controls`` and the compiled
``cbf_tpu_torch.rollout.engine.rollout``), where agents batch and whole
rollouts replay as CUDA graphs.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from cbf_tpu_torch.core.filter import CBFParams, safe_control
from cbf_tpu_torch.render.video import determine_marker_size as _marker_size_ax
from cbf_tpu_torch.scenarios.swarm import resolve_device
from cbf_tpu_torch.sim.certificates import (CertificateParams,
                                            si_barrier_certificate)
from cbf_tpu_torch.sim.controllers import (si_position_controller,
                                           unicycle_position_controller)
from cbf_tpu_torch.sim.graph import complete_gl
from cbf_tpu_torch.sim.robotarium import ARENA, SimParams, unicycle_step
from cbf_tpu_torch.sim.transformations import si_to_uni_dyn, uni_to_si_states


def _f32(a, device) -> torch.Tensor:
    """A host array as a float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _si_to_uni_clamped(dxi, poses, projection_distance,
                       angular_velocity_limit):
    """``si_to_uni_dyn`` with the angular-rate clamp."""
    dxu = si_to_uni_dyn(dxi, poses, projection_distance)
    w = torch.clamp(dxu[1], -angular_velocity_limit, angular_velocity_limit)
    return torch.stack([dxu[0], w])


class ControlBarrierFunction:
    """Reference-interface CBF filter (cbf.py:5-16) on the port's filter.

    Constructor signature matches cbf.py:6-16: ``max_speed`` required (the
    scenarios pass 15 — meet_at_center.py:25), ``dmin=0.2``, ``k=1``;
    ``gamma = 0.5`` is hard-coded exactly as the reference hard-codes it
    (cbf.py:16). ``device``: where the filter runs (None = the card).
    """

    def __init__(self, max_speed, dmin=0.2, k=1.0, *, device=None):
        self.device = resolve_device(device)
        self.max_speed = float(max_speed)
        self.dmin = float(dmin)
        self.k = float(k)
        self.gamma = 0.5
        self.last_info = None   # QPInfo diagnostics of the most recent call

    def get_safe_control(self, robot_state, obs_states, f, g, u0):
        """Filtered control for one agent (cbf.py:18-92 contract).

        Args mirror the reference: ``robot_state`` (4,) = (x, y, vx, vy),
        ``obs_states`` sequence of (4,) danger states, ``f`` (4, 4) /
        ``g`` (4, 2) affine dynamics, ``u0`` (2,) nominal control. Returns a
        numpy (2,) filtered control; infeasibility is handled by the bounded
        +1-relaxation equivalent of cbf.py:78-87 (rounds surfaced in
        ``self.last_info``).
        """
        robot_state = np.asarray(robot_state, np.float32).reshape(4)
        obs = np.asarray(obs_states, np.float32).reshape(-1, 4)
        u0 = np.asarray(u0, np.float32).reshape(2)
        m = obs.shape[0]
        # Pad the obstacle axis to a power-of-two bucket, as the JAX
        # package does for its compiled programs, so both solve the same
        # rows (masked rows are null).
        K = max(1, 1 << (m - 1).bit_length()) if m else 1
        obs_pad = np.zeros((K, 4), np.float32)
        obs_pad[:m] = obs
        mask = np.zeros(K, bool)
        mask[:m] = True
        dev = self.device
        u, info = safe_control(
            _f32(robot_state, dev), _f32(obs_pad, dev),
            torch.as_tensor(mask, device=dev), _f32(f, dev), _f32(g, dev),
            _f32(u0, dev),
            CBFParams(self.max_speed, self.dmin, self.k, self.gamma),
        )
        self.last_info = type(info)(*(_host(v) for v in info))
        return _host(u)


class Robotarium:
    """Stateful rps-style sim container over the functional unicycle core.

    Implements the exact surface the reference scripts drive
    (meet_at_center.py:51,79,151,153,159; cross_and_rescue.py:59,63-65,96 —
    SURVEY.md §2.6): ``get_poses`` → ``set_velocities`` → ``step`` with the
    one-``get_poses``-per-step discipline the rps original enforces, actuator
    saturation in wheel space, a 0.033 s tick, optional live matplotlib
    rendering (``show_figure``) and wall-clock pacing (``sim_in_real_time``).
    ``.figure`` / ``.axes`` are real matplotlib handles (created lazily when
    headless) so scenario code that scatters custom markers on them
    (cross_and_rescue.py:63-65) works unchanged. The poses live on the
    host; each ``step`` integrates them on ``device`` (None = the card).
    """

    def __init__(self, number_of_robots=-1, show_figure=False,
                 sim_in_real_time=False, initial_conditions=None,
                 sim_params: SimParams = SimParams(), seed: int = 0, *,
                 device=None):
        self.device = resolve_device(device)
        self._seed = int(seed)
        ic = np.asarray(initial_conditions if initial_conditions is not None
                        else [], np.float32)
        if ic.size:
            poses = ic.reshape(3, -1).astype(np.float32)
            if number_of_robots not in (-1, None) \
                    and poses.shape[1] != number_of_robots:
                raise ValueError(
                    f"initial_conditions provide {poses.shape[1]} robots, "
                    f"number_of_robots={number_of_robots}")
        else:
            if number_of_robots in (-1, None):
                raise ValueError("need number_of_robots or initial_conditions")
            poses = self._random_poses(number_of_robots)
        self.number_of_robots = poses.shape[1]
        self.params = sim_params
        self.show_figure = bool(show_figure)
        self.sim_in_real_time = bool(sim_in_real_time)

        self._poses = poses
        self._velocities = np.zeros((2, self.number_of_robots), np.float32)
        self._poses_read = False

        self._figure = None
        self._axes = None
        self._robot_markers = None
        self._steps = 0
        self._t_start = time.time()
        self._last_step_wall = self._t_start
        self._min_pairwise = math.inf
        if self.show_figure:
            self._init_figure()

    # -- figure ------------------------------------------------------------
    def _init_figure(self):
        import matplotlib
        if not self.show_figure:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        self._figure, self._axes = plt.subplots(figsize=(6.4, 4.0))
        xmin, xmax, ymin, ymax = ARENA
        self._axes.set_xlim(xmin, xmax)
        self._axes.set_ylim(ymin, ymax)
        self._axes.set_aspect("equal")
        s = determine_marker_size(self, 0.06)
        self._robot_markers = self._axes.scatter(
            self._poses[0], self._poses[1], s=s, marker="o", zorder=3)
        if self.show_figure:
            plt.ion()
            plt.show(block=False)

    @property
    def figure(self):
        if self._figure is None:
            self._init_figure()
        return self._figure

    @property
    def axes(self):
        if self._axes is None:
            self._init_figure()
        return self._axes

    # -- rps contract ------------------------------------------------------
    def _random_poses(self, n, min_spacing=0.2):
        """Uniform poses with pairwise min-spacing rejection, so robots never
        spawn already violating the certificate radius (matching the rps
        generator's spaced initial conditions [external — inferred]).
        Seeded (the constructor's ``seed``; AUD004): a fallback spawn
        that differed per process would break replayability for any
        record built on it."""
        rng = np.random.default_rng(self._seed)
        xmin, xmax, ymin, ymax = ARENA
        pts = np.empty((2, 0))
        for _ in range(1000):
            cand = np.stack([rng.uniform(xmin + 0.1, xmax - 0.1),
                             rng.uniform(ymin + 0.1, ymax - 0.1)])[:, None]
            if pts.shape[1] == 0 or \
                    np.min(np.linalg.norm(pts - cand, axis=0)) >= min_spacing:
                pts = np.concatenate([pts, cand], axis=1)
                if pts.shape[1] == n:
                    break
        else:
            raise RuntimeError(
                f"could not place {n} robots {min_spacing} m apart in the "
                "arena; pass initial_conditions")
        return np.concatenate(
            [pts, rng.uniform(-np.pi, np.pi, (1, n))]).astype(np.float32)

    def get_poses(self):
        """3×N (x, y, θ) poses; exactly one call per step() (rps rule)."""
        if self._poses_read:
            raise RuntimeError(
                "get_poses() already called this step; call step() first "
                "(the rps Robotarium enforces the same discipline)")
        self._poses_read = True
        return self._poses.copy()

    def set_velocities(self, ids, velocities):
        """Stage 2×N unicycle commands (v, ω) (meet_at_center.py:151).

        ``ids`` is accepted for signature parity; like the rps original in
        the reference's usage, the full 2×N array addresses all robots.
        """
        del ids
        v = np.asarray(velocities, np.float32)
        if v.shape != (2, self.number_of_robots):
            raise ValueError(
                f"velocities must be (2, {self.number_of_robots}), "
                f"got {v.shape}")
        self._velocities = v.copy()  # callers may reuse/mutate their buffer

    def step(self):
        """Advance one dt tick: saturate, integrate, render, pace."""
        if not self._poses_read:
            raise RuntimeError(
                "call get_poses() before step() (rps discipline)")
        self._poses = _host(unicycle_step(
            _f32(self._poses, self.device),
            _f32(self._velocities, self.device), self.params))
        self._steps += 1
        self._poses_read = False

        if self.number_of_robots > 1:
            d = self._poses[:2, :, None] - self._poses[:2, None, :]
            dist = np.sqrt((d ** 2).sum(0))
            np.fill_diagonal(dist, np.inf)
            self._min_pairwise = min(self._min_pairwise, float(dist.min()))

        if self._robot_markers is not None:
            self._robot_markers.set_offsets(self._poses[:2].T)
            if self.show_figure:
                self._figure.canvas.draw_idle()
                self._figure.canvas.flush_events()

        if self.sim_in_real_time:
            now = time.time()
            sleep = float(self.params.dt) - (now - self._last_step_wall)
            if sleep > 0:
                time.sleep(sleep)
        self._last_step_wall = time.time()

    def call_at_scripts_end(self):
        """End-of-run diagnostics hook (meet_at_center.py:159)."""
        wall = time.time() - self._t_start
        md = self._min_pairwise if self._min_pairwise < math.inf else float("nan")
        print(f"cbf_tpu_torch.compat.Robotarium: {self._steps} steps "
              f"({self._steps * float(self.params.dt):.1f} sim-s) in "
              f"{wall:.1f} wall-s; {self.number_of_robots} robots; "
              f"min inter-robot distance {md:.4f} m")


# -- rps utility factories -------------------------------------------------

def completeGL(n):
    """Complete-graph Laplacian (rps name; meet_at_center.py:74)."""
    return complete_gl(int(n))


def topological_neighbors(L, agent):
    """Neighbor index array of ``agent`` from Laplacian row nonzeros
    (meet_at_center.py:88,101 semantics: any nonzero off-diagonal entry)."""
    L = np.asarray(L)
    row = L[int(agent)].copy()
    row[int(agent)] = 0.0
    return np.nonzero(row)[0]


def create_si_to_uni_mapping(projection_distance=0.05,
                             angular_velocity_limit=np.pi, *, device=None):
    """(si_to_uni_dyn, uni_to_si_states) closure pair (meet_at_center.py:61).

    Near-identity diffeomorphism through a point ``projection_distance``
    ahead of the wheel axis, with an angular-rate clamp [external — inferred
    from usage; SURVEY.md §2.6]. ``device``: where the maps run (None =
    the card).
    """
    dev = resolve_device(device)

    def _si_to_uni(dxi, poses):
        return _host(_si_to_uni_clamped(
            _f32(dxi, dev), _f32(poses, dev), float(projection_distance),
            float(angular_velocity_limit)))

    def _uni_to_si(poses):
        return _host(uni_to_si_states(_f32(poses, dev),
                                      float(projection_distance)))

    return _si_to_uni, _uni_to_si


def create_single_integrator_barrier_certificate_with_boundary(
        barrier_gain=100.0, safety_radius=0.17, magnitude_limit=0.2, *,
        device=None):
    """Joint all-agent min-deviation certificate QP factory
    (created meet_at_center.py:58, applied cross_and_rescue.py:163).

    Returns ``cert(dxi, x) -> dxi`` enforcing pairwise distance ≥
    safety_radius plus arena-boundary rows, solved by the dense ADMM
    backend on ``device`` (None = the card; the rps original calls a host
    QP solver per step).
    """
    dev = resolve_device(device)
    params = CertificateParams(float(barrier_gain), float(safety_radius),
                               float(magnitude_limit))

    def cert(dxi, x):
        return _host(si_barrier_certificate(_f32(dxi, dev), _f32(x, dev),
                                            params))

    return cert


def create_si_position_controller(x_velocity_gain=1.0, y_velocity_gain=1.0,
                                  velocity_magnitude_limit=0.15, *,
                                  device=None):
    """P go-to-goal factory (rps.utilities.controllers surface — imported by
    the reference at meet_at_center.py:16, never called). Signature follows
    the rps original's per-axis gains [external — inferred; SURVEY.md §2.6].
    """
    dev = resolve_device(device)
    gains = _f32([[float(x_velocity_gain)], [float(y_velocity_gain)]], dev)

    def controller(x, positions):
        x = _f32(x, dev)[:2]
        goals = _f32(positions, dev)[:2]
        # Per-axis gain == unit-gain controller on gain-scaled error.
        dxi = si_position_controller(torch.zeros_like(x), gains * (goals - x),
                                     1.0, float(velocity_magnitude_limit))
        return _host(dxi)

    return controller


def create_clf_unicycle_position_controller(linear_velocity_gain=0.8,
                                            angular_velocity_gain=3.0, *,
                                            device=None):
    """CLF unicycle go-to-goal factory (rps controllers surface)."""
    dev = resolve_device(device)

    def controller(poses, positions):
        return _host(unicycle_position_controller(
            _f32(poses, dev), _f32(positions, dev)[:2],
            float(linear_velocity_gain), float(angular_velocity_gain)))

    return controller


def determine_marker_size(robotarium_or_axes, marker_size_meters):
    """Meters → matplotlib scatter points² (cross_and_rescue.py:62).

    Accepts a :class:`Robotarium` (rps calling convention) or a bare axes.
    """
    ax = getattr(robotarium_or_axes, "axes", robotarium_or_axes)
    return _marker_size_ax(ax, float(marker_size_meters))
