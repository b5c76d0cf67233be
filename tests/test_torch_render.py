"""The port's replay renderer (cbf_tpu_torch.render) against the JAX
package's (cbf_tpu.render): the same marker sizes, and replays of the same
trajectories with the same frame counts and equal first and last frame
pixels. Without matplotlib the port still writes the .gif (its Pillow
replay): the same frame count, the layers drawn in their colours."""

import sys

import numpy as np
import pytest

import matplotlib
matplotlib.use("Agg")

from PIL import Image

from cbf_tpu import render as jren
from cbf_tpu_torch import render as tren
from cbf_tpu_torch.sim import robotarium


def _frames(path):
    with Image.open(path) as im:
        n = im.n_frames
        im.seek(0)
        first = np.asarray(im.convert("RGB"))
        im.seek(n - 1)
        last = np.asarray(im.convert("RGB"))
    return n, first, last


def _trajectories():
    rng = np.random.default_rng(3)
    T = 23
    robots = np.cumsum(rng.normal(0, 0.02, (T, 2, 4)), axis=0)
    obs = np.cumsum(rng.normal(0, 0.02, (T, 2, 6)), axis=0)
    return T, robots, obs


@pytest.mark.parametrize("radius", [0.02, 0.05, 0.1])
def test_marker_size_equal(radius):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6.4, 4.0), dpi=80)
    x0, x1, y0, y1 = robotarium.ARENA
    ax.set_xlim(x0, x1)
    ax.set_ylim(y0, y1)
    assert tren.determine_marker_size(ax, radius) == \
        jren.determine_marker_size(ax, radius)
    plt.close(fig)


@pytest.mark.parametrize("which", ["meet_at_center", "cross_and_rescue",
                                   "swarm"])
def test_replay_frames_equal_jax(tmp_path, which):
    T, robots, obs = _trajectories()
    paths = {}
    for name, pkg in (("port", tren), ("jax", jren)):
        out = str(tmp_path / f"{name}.gif")
        if which == "meet_at_center":
            traj = np.concatenate([obs[:, :, :5], robots], axis=2)
            paths[name] = pkg.render_meet_at_center(traj, out, stride=4)
        elif which == "cross_and_rescue":
            paths[name] = pkg.render_cross_and_rescue((robots, obs), out,
                                                      stride=4)
        else:
            paths[name] = pkg.render_swarm(
                robots.transpose(0, 2, 1), out, stride=4,
                obstacles=obs.transpose(0, 2, 1))
    got, want = _frames(paths["port"]), _frames(paths["jax"])
    assert got[0] == want[0] == len(range(0, T, 4))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_replay_without_matplotlib(tmp_path, monkeypatch):
    T, robots, obs = _trajectories()
    want = _frames(jren.render_cross_and_rescue(
        (robots, obs), str(tmp_path / "jax.gif"), stride=4))
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    path = tren.render_cross_and_rescue((robots, obs),
                                        str(tmp_path / "port.gif"), stride=4)
    n, first, last = _frames(path)
    assert n == want[0]
    for frame in (first, last):
        colours = {tuple(c) for c in frame.reshape(-1, 3)}
        assert (255, 255, 255) in colours
        assert (0x1F, 0x77, 0xB4) in colours          # tab:blue robots
        assert (0xD6, 0x27, 0x28) in colours          # tab:red obstacles
    with pytest.raises(RuntimeError, match="gif"):
        tren.render_cross_and_rescue((robots, obs),
                                     str(tmp_path / "port.mp4"))
