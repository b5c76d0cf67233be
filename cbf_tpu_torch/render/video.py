"""Host-side trajectory rendering: replay recorded rollouts to video
(counterpart: cbf_tpu/render/video.py, copied with the port's ``ARENA``).

The reference renders inside its hot loop — a live Robotarium figure and
a per-step ``writer.grab_frame()`` into ``simulation.mp4`` (its
cross_and_rescue.py:96-98). Here rendering is decoupled: scenarios record
position snapshots as rollout outputs on the device, and this module
replays the stacked arrays afterwards. The sim never touches a figure.

Writer selection for .mp4: FFMpegWriter when ffmpeg is on PATH, else an
OpenCV-backed writer, else a RuntimeError pointing at .gif
(PillowWriter). ``replay`` is the generic engine; ``render_meet_at_center``
/ ``render_cross_and_rescue`` / ``render_swarm`` adapt each scenario's
recorded ``StepOutputs.trajectory`` to it with the reference's styling
(obstacle ring red, free agents blue, goal gold).

matplotlib is imported inside the functions that draw. Where it is not
installed, ``replay`` still writes a .gif: :func:`_replay_pil` draws the
same layers, frames and arena as filled discs with Pillow (no axes,
title or legend), so a headless machine without matplotlib can still
replay a run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
from typing import Sequence

import numpy as np

from cbf_tpu_torch.sim.robotarium import ARENA


@dataclasses.dataclass(frozen=True)
class Layer:
    """One scatter layer of the replay.

    positions: (T, 2, K) array — K entities tracked over T frames, column
    layout as everywhere in the sim layer. A (2, K) array is broadcast as
    static (the goal marker, a fixed obstacle).
    """
    positions: np.ndarray
    color: str = "C0"
    radius: float = 0.04          # meters — converted via determine_marker_size
    marker: str = "o"
    label: str | None = None
    trail: int = 0                # draw a fading trail of this many past frames

    def at(self, t: int) -> np.ndarray:
        p = np.asarray(self.positions)
        return p if p.ndim == 2 else p[t]


def determine_marker_size(ax, radius: float) -> float:
    """Meters -> matplotlib scatter size (points^2) for the given axes.

    Equivalent of rps ``determine_marker_size`` (consumed at
    cross_and_rescue.py:62 [external — inferred from usage]): a marker whose
    on-screen diameter spans ``2*radius`` meters of axes data space.
    """
    fig = ax.get_figure()
    # Axes width in display points.
    bbox = ax.get_window_extent().transformed(fig.dpi_scale_trans.inverted())
    width_points = bbox.width * 72.0
    x0, x1 = ax.get_xlim()
    meters_per_point = (x1 - x0) / max(width_points, 1e-9)
    diameter_points = 2.0 * radius / meters_per_point
    return diameter_points ** 2


class _Cv2Mp4Writer:
    """Minimal FFMpegWriter-compatible mp4 writer over OpenCV — implements
    exactly the ``saving(fig, path, dpi)`` / ``grab_frame()`` surface that
    ``replay`` (and the reference's in-loop pattern, cross_and_rescue.py:96-98)
    uses. The VideoWriter opens lazily on the first frame, when the figure's
    pixel size is known."""

    def __init__(self, fps: int):
        self.fps = fps
        self._fig = None
        self._vw = None

    @contextlib.contextmanager
    def saving(self, fig, out_path: str, dpi=None):
        self._fig, self._path = fig, out_path
        try:
            yield self
        finally:
            if self._vw is not None:
                self._vw.release()
            self._fig = self._vw = None

    def grab_frame(self):
        import cv2

        self._fig.canvas.draw()
        rgb = np.asarray(self._fig.canvas.buffer_rgba())[..., :3]
        h, w = rgb.shape[:2]
        if self._vw is None:
            self._vw = cv2.VideoWriter(
                self._path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
            if not self._vw.isOpened():
                raise RuntimeError(
                    f"OpenCV VideoWriter failed to open {self._path}")
        self._vw.write(rgb[..., ::-1].copy())      # RGB -> BGR


def _make_writer(out_path: str, fps: int):
    from matplotlib import animation

    if out_path.endswith(".mp4"):
        if shutil.which("ffmpeg") is not None:
            return animation.FFMpegWriter(fps=fps)
        try:
            import cv2  # noqa: F401
        except ImportError:
            raise RuntimeError(
                "mp4 needs ffmpeg on PATH or OpenCV installed — pass a "
                ".gif path (PillowWriter) instead")
        return _Cv2Mp4Writer(fps=fps)
    return animation.PillowWriter(fps=fps)


def replay(layers: Sequence[Layer], out_path: str, *, fps: int = 30,
           stride: int = 1, arena=ARENA, figsize=(6.4, 4.0), dpi: int = 80,
           title: str | None = None) -> str:
    """Render layered position trajectories to ``out_path`` (.mp4/.gif).

    Args:
      layers: scatter layers; the first dynamic layer defines T.
      stride: render every ``stride``-th recorded frame (a 3000-step rollout
        at stride=10 becomes a 300-frame video).
    Returns out_path.
    """
    T = max((np.asarray(l.positions).shape[0]
             for l in layers if np.asarray(l.positions).ndim == 3), default=1)
    try:
        import matplotlib
    except ImportError:
        return _replay_pil(layers, out_path, T, fps=fps, stride=stride,
                           arena=arena, size=(round(figsize[0] * dpi),
                                              round(figsize[1] * dpi)))
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize, dpi=dpi)
    x0, x1, y0, y1 = arena
    ax.set_xlim(x0, x1)
    ax.set_ylim(y0, y1)
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)

    scatters, trails = [], []
    for l in layers:
        p = l.at(0)
        s = ax.scatter(p[0], p[1], s=determine_marker_size(ax, l.radius),
                       c=l.color, marker=l.marker, label=l.label, zorder=3)
        scatters.append(s)
        tr = None
        if l.trail:
            tr = ax.scatter([], [], s=determine_marker_size(ax, l.radius) / 6,
                            c=l.color, alpha=0.25, zorder=2)
        trails.append(tr)
    if any(l.label for l in layers):
        ax.legend(loc="upper right", fontsize=8)

    writer = _make_writer(out_path, fps)
    with writer.saving(fig, out_path, dpi):
        for t in range(0, T, stride):
            for l, s, tr in zip(layers, scatters, trails):
                p = l.at(t)
                s.set_offsets(p.T)
                if tr is not None and t > 0:
                    past = np.asarray(l.positions)[max(0, t - l.trail):t]
                    tr.set_offsets(past.transpose(0, 2, 1).reshape(-1, 2))
            writer.grab_frame()
    plt.close(fig)
    return out_path


# matplotlib's colours that the renderers name, for the Pillow replay.
_PIL_COLORS = {"C0": "#1f77b4", "C1": "#ff7f0e", "tab:blue": "#1f77b4",
               "tab:red": "#d62728"}


def _replay_pil(layers: Sequence[Layer], out_path: str, T: int, *,
                fps: int, stride: int, arena, size) -> str:
    """``replay`` without matplotlib: the same frames (every ``stride``-th
    of T) of the same layers in the same arena (equal aspect), each entity
    a filled disc of its radius and each trail a fainter small disc, as a
    Pillow .gif."""
    from PIL import Image, ImageColor, ImageDraw

    if not out_path.endswith(".gif"):
        raise RuntimeError("without matplotlib only .gif replays are "
                           "written (Pillow); pass a .gif path")
    w, h = size
    x0, x1, y0, y1 = arena
    scale = min(w / (x1 - x0), h / (y1 - y0))
    ox = (w - scale * (x1 - x0)) / 2 - scale * x0
    oy = (h - scale * (y1 - y0)) / 2 + scale * y1

    def discs(draw, p, radius, fill):
        r = max(scale * radius, 1.0)
        for x, y in zip(p[0], p[1]):
            cx, cy = ox + scale * float(x), oy - scale * float(y)
            draw.ellipse((cx - r, cy - r, cx + r, cy + r), fill=fill)

    colors = [ImageColor.getrgb(_PIL_COLORS.get(l.color, l.color))
              for l in layers]
    frames = []
    for t in range(0, T, stride):
        im = Image.new("RGB", (w, h), "white")
        draw = ImageDraw.Draw(im)
        for l, rgb in zip(layers, colors):
            if l.trail and t > 0:
                faint = tuple(255 - (255 - c) // 4 for c in rgb)
                for past in np.asarray(l.positions)[max(0, t - l.trail):t]:
                    discs(draw, past, l.radius / 2.5, faint)
        for l, rgb in zip(layers, colors):
            discs(draw, l.at(t), l.radius, rgb)
        frames.append(im)
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=max(1, round(1000 / fps)), loop=0)
    return out_path


def render_meet_at_center(trajectory, out_path: str, *, n_obstacles: int = 5,
                          stride: int = 5, **kw) -> str:
    """Replay a meet_at_center rollout.

    Args: trajectory — the scenario's recorded ``StepOutputs.trajectory``,
    a (T, 2, N) position stack; first ``n_obstacles`` columns are the
    cyclic-pursuit ring.
    """
    traj = np.asarray(trajectory)
    return replay(
        [
            Layer(traj[:, :, :n_obstacles], color="tab:red", label="obstacles"),
            Layer(traj[:, :, n_obstacles:], color="tab:blue", trail=30,
                  label="agents"),
        ],
        out_path, stride=stride, title="meet_at_center", **kw)


def render_cross_and_rescue(trajectory, out_path: str, *,
                            goal=(1.5, 0.0), stride: int = 10, **kw) -> str:
    """Replay a cross_and_rescue rollout.

    Args: trajectory — the scenario's recorded trajectory pytree
    ``(robot_xy (T, 2, nR), obs_xy (T, 2, nO))``. Styling follows the
    reference artifact: ring obstacles red, static origin obstacle red, goal
    gold (cross_and_rescue.py:63-65).
    """
    robots, obs = (np.asarray(a) for a in trajectory)
    static = np.zeros((2, 1))
    goal_col = np.asarray(goal, float).reshape(2, 1)
    return replay(
        [
            Layer(obs, color="tab:red", radius=0.1, label="obstacles"),
            Layer(static, color="tab:red", radius=0.1),
            Layer(goal_col, color="gold", radius=0.06, marker="*",
                  label="goal"),
            Layer(robots, color="tab:blue", trail=60, label="robots"),
        ],
        out_path, stride=stride, title="cross_and_rescue", **kw)


def render_swarm(trajectory, out_path: str, *, stride: int = 10,
                 obstacles=None, **kw) -> str:
    """Replay a swarm rollout. trajectory: (T, N, 2) (the swarm scenario
    records row-major positions). ``obstacles``: optional (T, M, 2)
    obstacle positions (reconstruct closed-form via
    ``scenarios.swarm.obstacle_positions_at`` — they carry no state)."""
    traj = np.asarray(trajectory).transpose(0, 2, 1)        # -> (T, 2, N)
    half = float(np.abs(traj).max()) * 1.05 + 1e-3
    layers = [Layer(traj, color="tab:blue", radius=0.02)]
    if obstacles is not None:
        obs = np.asarray(obstacles).transpose(0, 2, 1)      # -> (T, 2, M)
        # The arena must cover the obstacle orbit too, or a ring wider
        # than the agent cloud draws entirely off-frame.
        half = max(half, float(np.abs(obs).max()) * 1.05 + 1e-3)
        layers.append(Layer(obs, color="tab:red", radius=0.1,
                            label="obstacles"))
    return replay(
        layers, out_path, stride=stride, arena=(-half, half, -half, half),
        title="swarm rendezvous", **kw)
