"""The port's migration layer (cbf_tpu_torch.compat) and its examples
(cbf_tpu_torch.examples) against the JAX package's (cbf_tpu.compat,
examples/*_compat.py), numpy in and numpy out on the CPU.

Tolerances, float32 throughout: single calls atol 1e-6 (the filter, maps
and controllers agree to an ulp or two); the certificate factory 1e-5
(its parameters are Python floats in the port and float32 arrays in the
JAX package's jitted call, so the cubic margins may round an ulp apart);
25-step loops 1e-5 on the final poses. Graph utilities, the rps call
discipline and every relax count exactly.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from cbf_tpu import compat as jc
from cbf_tpu_torch import compat as tc
from cbf_tpu_torch.examples import cross_and_rescue_compat as t_car
from cbf_tpu_torch.examples import meet_at_center_compat as t_mac

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FX = 0.1 * np.zeros((4, 4))
GX = 0.1 * np.array([[1.0, 0], [0, 1.0], [0, 0], [0, 0]])
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_control_barrier_function_matches_jax(rng):
    ours, theirs = tc.ControlBarrierFunction(15, **CPU), \
        jc.ControlBarrierFunction(15)
    assert ours.gamma == theirs.gamma == 0.5
    relaxed = 0
    for case in range(12):
        m = int(rng.integers(1, 6))
        robot = rng.uniform(-1, 1, 4)
        obs = robot[None, :] + rng.uniform(-0.15, 0.15, (m, 4))
        if case % 3 == 0:
            obs[:, 2:] = -20.0 * (robot[None, :2] - obs[:, :2])
        u0 = rng.uniform(-0.2, 0.2, 2)
        np.testing.assert_allclose(
            ours.get_safe_control(robot, list(obs), FX, GX, u0),
            theirs.get_safe_control(robot, list(obs), FX, GX, u0),
            rtol=0, atol=1e-6)
        for a, b in zip(ours.last_info, theirs.last_info):
            assert a.shape == np.asarray(b).shape
        np.testing.assert_array_equal(ours.last_info.relax_rounds,
                                      theirs.last_info.relax_rounds)
        relaxed += float(ours.last_info.relax_rounds) > 0
    assert relaxed > 0
    u = ours.get_safe_control(np.array([[0.1], [0.1], [0.0], [0.0]]),
                              [np.array([[0.15], [0.1], [0.0], [0.0]])],
                              FX, GX, np.array([[0.1], [0.0]]))
    assert u.shape == (2,) and np.all(np.isfinite(u))


def test_robotarium_matches_jax_and_keeps_the_rps_discipline():
    ic = np.array([[0.0, 0.5, -0.4], [0.0, 0.0, 0.3], [0.0, np.pi, 1.0]])
    ours = tc.Robotarium(number_of_robots=3, initial_conditions=ic, **CPU)
    theirs = jc.Robotarium(number_of_robots=3, initial_conditions=ic)
    v = np.array([[0.1, 0.3, -0.2], [0.5, -4.0, 1.0]])   # one saturates
    for _ in range(5):
        np.testing.assert_allclose(ours.get_poses(), theirs.get_poses(),
                                   rtol=0, atol=1e-6)
        ours.set_velocities(np.arange(3), v)
        theirs.set_velocities(np.arange(3), v)
        ours.step()
        theirs.step()
    x = ours.get_poses()
    with pytest.raises(RuntimeError):
        ours.get_poses()                 # one get_poses per step
    ours.step()
    with pytest.raises(RuntimeError):
        ours.step()                      # step without get_poses
    with pytest.raises(ValueError):
        ours.set_velocities(np.arange(3), np.zeros((2, 4)))
    with pytest.raises(ValueError):
        tc.Robotarium(**CPU)             # neither count nor poses
    np.testing.assert_array_equal(
        tc.Robotarium(number_of_robots=12, **CPU).get_poses(),
        jc.Robotarium(number_of_robots=12).get_poses())
    assert np.all(np.isfinite(x))
    ours.call_at_scripts_end()


def test_rps_utilities_match_jax():
    np.testing.assert_array_equal(tc.completeGL(4), jc.completeGL(4))
    ring = -np.eye(3)
    ring[0, 1] = ring[1, 2] = ring[2, 0] = 1.0
    for L, agent in ((tc.completeGL(4), 2), (ring, 0)):
        np.testing.assert_array_equal(tc.topological_neighbors(L, agent),
                                      jc.topological_neighbors(L, agent))
    r = tc.Robotarium(number_of_robots=1, initial_conditions=np.zeros((3, 1)),
                      **CPU)
    rj = jc.Robotarium(number_of_robots=1, initial_conditions=np.zeros((3, 1)))
    assert tc.determine_marker_size(r, 0.05) == \
        jc.determine_marker_size(rj, 0.05) > 0


def test_robotarium_live_figure_real_time():
    """The reference's default mode (show_figure, sim_in_real_time) under
    Agg: the live markers track the poses and step() paces to the tick."""
    import time

    import matplotlib
    matplotlib.use("Agg")

    ic = np.array([[0.0, 0.5, -0.5], [0.0, 0.3, -0.3], [0.0, 0.0, 0.0]])
    r = tc.Robotarium(number_of_robots=3, show_figure=True,
                      sim_in_real_time=True, initial_conditions=ic, **CPU)
    assert r.figure is not None and r.axes is not None
    v = np.zeros((2, 3), np.float32)
    v[0] = 0.05
    t0 = time.time()
    for _ in range(4):
        r.get_poses()
        r.set_velocities(np.arange(3), v)
        r.step()
    assert time.time() - t0 >= 3 * float(r.params.dt)
    np.testing.assert_allclose(np.asarray(r._robot_markers.get_offsets()),
                               r._poses[:2].T, atol=1e-6)


@pytest.mark.parametrize("factory", ["si_to_uni", "uni_to_si", "certificate",
                                     "si_position", "unicycle_position"])
def test_factories_match_jax(factory, rng):
    n = 6
    poses = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(-np.pi, np.pi, n)])
    dxi = rng.uniform(-0.3, 0.3, (2, n))
    dxi[:, 0] = [0.0, 1.0]               # sideways: the angular clamp binds
    atol = 1e-6
    if factory in ("si_to_uni", "uni_to_si"):
        ours = tc.create_si_to_uni_mapping(**CPU)
        theirs = jc.create_si_to_uni_mapping()
        k = 0 if factory == "si_to_uni" else 1
        args = (dxi, poses) if k == 0 else (poses,)
        got, want = ours[k](*args), theirs[k](*args)
    elif factory == "certificate":
        atol = 1e-5
        x = poses[:2] * 0.3              # packed: pair rows bind
        got = tc.create_single_integrator_barrier_certificate_with_boundary(
            safety_radius=0.12, **CPU)(dxi, x)
        want = jc.create_single_integrator_barrier_certificate_with_boundary(
            safety_radius=0.12)(dxi, x)
        assert np.abs(got - np.clip(dxi, -0.2, 0.2)).max() > 1e-3
    elif factory == "si_position":
        got = tc.create_si_position_controller(1.0, 2.0, **CPU)(poses, dxi)
        want = jc.create_si_position_controller(1.0, 2.0)(poses, dxi)
    else:
        got = tc.create_clf_unicycle_position_controller(**CPU)(poses, dxi)
        want = jc.create_clf_unicycle_position_controller()(poses, dxi)
    assert got.dtype == np.float32 and got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["meet_at_center_compat",
                                  "cross_and_rescue_compat"])
def test_examples_match_jax(name, tmp_path):
    """Both examples at 25 steps (the port's cross_and_rescue one with its
    video), written against each package's compat layer: the same final
    poses."""
    ours = {"meet_at_center_compat": t_mac,
            "cross_and_rescue_compat": t_car}[name]
    kw = {}
    if name == "cross_and_rescue_compat":
        kw["video"] = str(tmp_path / "v.gif")
    got = ours.main(steps=25, device="cpu", **kw)
    assert got.shape == ((3, 10) if name.startswith("meet") else (3, 4))
    if kw:
        assert (tmp_path / "v.gif").exists()
    want = _jax_example(name).main(steps=25)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_device_none_means_the_card():
    """No fallback: without ``device`` every object and factory asks for
    the card, and raises without one."""
    for make in (lambda: tc.ControlBarrierFunction(15),
                 lambda: tc.Robotarium(number_of_robots=2),
                 tc.create_si_to_uni_mapping,
                 tc.create_single_integrator_barrier_certificate_with_boundary,
                 tc.create_si_position_controller,
                 tc.create_clf_unicycle_position_controller,
                 lambda: t_mac.main(steps=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
