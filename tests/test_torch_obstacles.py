"""The port's obstacle field (cbf_tpu_torch.scenarios.swarm: the closed-form
ring/scatter law, lane dodge, exact priority rows, spawn stand-off repair,
the discrete barrier and relax-cap tiers it switches on) against the JAX
package's, function by function on the same numpy inputs and as a whole
rollout from the same carried-across state.

Tolerances: the obstacle law within 2 ulps of the field's largest
coordinate (PyTorch's and XLA's cos/sin may round differently by one ulp,
in float32 and float64 alike), and so the spawn repair, which starts from
those positions (it is bit-equal where they are); lane dodge and distances
float32 atol 1e-6, float64 atol 1e-12; obstacle rows and masks exact. Whole
rollouts keep test_torch_swarm.py's tolerances: float32 min distance rtol
1e-6, x and v atol 1e-5; float64 atol 1e-10; every count exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.rollout import engine as jeng
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu_torch import convert
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.scenarios import swarm as tsw

LAYOUTS = ["orbit", "static", "scatter"]
COUNTS = ("filter_active_count", "infeasible_count", "gating_dropped_count",
          "max_relax_rounds")


def _configs(dtype_name, **kw):
    return (jsw.Config(dtype=getattr(jnp, dtype_name), **kw),
            tsw.Config(dtype=getattr(torch, dtype_name), **kw))


def _ulps(dtype_name, scale, n=2):
    return n * np.finfo(dtype_name).eps * scale


@pytest.fixture(params=["float32", "float64"])
def dtype_name(request):
    if request.param == "float64":
        request.getfixturevalue("x64")
    return request.param


@pytest.mark.parametrize("layout", LAYOUTS)
def test_obstacle_states_match_jax(layout, dtype_name):
    jc, tc = _configs(dtype_name, n=1024, n_obstacles=12,
                      obstacle_layout=layout)
    for t in (0, 1, 17, 250, 9999):
        want = np.asarray(jsw.obstacle_states_at(jc, t, jc.dtype))
        got = tsw.obstacle_states_at(tc, t, tc.dtype, device="cpu")
        assert got.dtype == tc.dtype and got.shape == (12, 4)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=_ulps(dtype_name, np.abs(want).max()), err_msg=str(t))
        if layout != "orbit":
            assert not got[:, 2:].any()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_host_obstacle_positions_match_jax(layout):
    jc, tc = _configs("float32", n=256, n_obstacles=7,
                      obstacle_layout=layout)
    for t in (0.0, 3.0, 41.0):
        want = jsw.obstacle_positions_at(jc, t)
        got = tsw.obstacle_positions_at(tc, t)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=_ulps("float64", np.abs(want).max()))


def test_lane_dodge_and_rows_match_jax(dtype_name):
    """Agents scattered through a moving ring: lane dodge, d_o and the
    attached slab (exact obstacle rows, priority tier) on the same input."""
    jc, tc = _configs(dtype_name, n=400, n_obstacles=8)
    rng = np.random.default_rng(4)
    x = rng.uniform(-2.0, 2.0, (400, 2)).astype(dtype_name)
    ob = np.array(jsw.obstacle_states_at(jc, 13, jc.dtype))
    dodge_j, d_j = (np.asarray(a) for a in jsw.lane_dodge(
        jnp.asarray(x), jnp.asarray(ob), jc.safety_distance))
    dodge_t, d_t = (a.numpy() for a in tsw.lane_dodge(
        torch.from_numpy(x), torch.from_numpy(ob), tc.safety_distance))
    atol = 1e-6 if dtype_name == "float32" else 1e-12
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=atol)
    np.testing.assert_allclose(dodge_t, dodge_j, rtol=0, atol=atol)
    assert np.abs(dodge_t).sum() > 0                 # agents were in a lane

    k = 5
    slab = rng.normal(size=(400, k, 4)).astype(dtype_name)
    mask = rng.uniform(size=(400, k)) < 0.5
    got = tsw.attach_obstacle_rows(torch.from_numpy(slab),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(ob),
                                   torch.from_numpy(np.array(d_j)),
                                   tc.safety_distance)
    want = jsw.attach_obstacle_rows(jnp.asarray(slab), jnp.asarray(mask),
                                    jnp.asarray(ob), jnp.asarray(d_j),
                                    jc.safety_distance)
    for name, a, b in zip(("obs", "mask", "priority"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert got[2].shape == (400, k + 8) and got[1][:, k:].any()


@pytest.mark.parametrize("n,m,seed,layout", [(256, 12, 3, "orbit"),
                                             (96, 8, 2, "orbit"),
                                             (300, 9, 7, "scatter")])
def test_spawn_repair_matches_jax(n, m, seed, layout, dtype_name):
    jc, tc = _configs(dtype_name, n=n, n_obstacles=m, seed=seed,
                      obstacle_layout=layout)
    x0 = np.array(jsw.spawn_positions(jc, seed))
    want = np.asarray(jsw.clear_obstacle_spawn(jc, jnp.asarray(x0)))
    got = tsw.clear_obstacle_spawn(tc, torch.from_numpy(x0)).numpy()
    assert np.abs(want - x0).max() > 0.1             # the repair did work
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_ulps(dtype_name, np.abs(want).max()))


def test_spawn_repair_rows_sliced_alike(monkeypatch):
    """The pairwise repair's row slicing does not change a row's sum."""
    cfg = tsw.Config(n=300, n_obstacles=9, seed=1)
    x0 = tsw.spawn_positions(cfg, 1, device="cpu")
    whole = tsw.clear_obstacle_spawn(cfg, x0)
    monkeypatch.setattr(tsw, "_REPAIR_ROWS", 37)
    assert torch.equal(tsw.clear_obstacle_spawn(cfg, x0), whole)


def test_spawn_clears_obstacle_disks():
    """test_obstacles.py's spawn check on the port's own spawn."""
    cfg = tsw.Config(n=1024, steps=1, n_obstacles=12, seed=5)
    x0 = tsw.initial_state(cfg, device="cpu").x.numpy()
    opos = tsw.obstacle_positions_at(cfg, 0.0)
    do = np.linalg.norm(x0[:, None] - opos[None], axis=-1)
    assert do.min() >= 0.25 - 1e-5
    d = np.linalg.norm(x0[:, None] - x0[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    assert d.min() > 0.249
    assert torch.equal(tsw.clear_obstacle_spawn(
        dataclasses.replace(cfg, n_obstacles=0), torch.from_numpy(x0)),
        torch.from_numpy(x0))


def test_obstacles_switch_barrier_and_tiers_like_jax():
    for kw in ({"n_obstacles": 4}, {"n_obstacles": 0},
               {"n_obstacles": 4, "barrier": "continuous"}):
        jc, tc = _configs("float32", n=16, **kw)
        fj, gj, dj = jsw.barrier_dynamics(jc, jnp.float32)
        ft, gt, dt = tsw.barrier_dynamics(tc, torch.float32, device="cpu")
        assert dt == dj
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
        mask = jnp.ones((16, 3), bool)
        assert (tsw.relax_tiers(tc, torch.ones((16, 3), dtype=torch.bool),
                                None)[1]
                == jsw.relax_tiers(jc, mask, None)[1])


def _run_both(jcfg):
    s0, jstep = jsw.make(jcfg)
    jf, jo = jeng.rollout(jstep, s0, jcfg.steps)
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    tcfg = convert.config_from_fields(fields)
    _, tstep = tsw.make(tcfg, device="cpu")
    tf, to = teng.rollout(tstep, convert.state_from_numpy(
        np.asarray(s0.x), np.asarray(s0.v), device="cpu",
        dtype=tcfg.dtype), tcfg.steps)
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=name)
    assert int(to.filter_active_count.max()) > jcfg.n // 2
    return jf, jo, tf, to


def test_obstacle_ring_banded_matches_jax():
    """test_obstacles.py's ring on the banded path, float32, 300 steps."""
    jf, jo, tf, to = _run_both(jsw.Config(
        n=96, steps=300, k_neighbors=6, n_obstacles=8, seed=2,
        gating="banded", gating_window_blocks=2))
    np.testing.assert_array_equal(to.gating_overflow_count.numpy(),
                                  np.asarray(jo.gating_overflow_count))
    np.testing.assert_allclose(to.min_pairwise_distance.numpy(),
                               np.asarray(jo.min_pairwise_distance),
                               rtol=1e-6)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), atol=1e-5)
    np.testing.assert_allclose(tf.v.numpy(), np.asarray(jf.v), atol=1e-5)
    assert float(to.min_pairwise_distance.min()) > 0.13


@pytest.mark.parametrize("omega", [0.5, 2.0])
def test_obstacle_ring_dense_f64_matches_jax(x64, omega):
    """gating="jnp" in float64; at omega=2 the obstacles outrun the agents
    ~10x and the relax-cap tier engages (max relax rounds >= 1)."""
    jf, jo, tf, to = _run_both(jsw.Config(
        n=96, steps=300, k_neighbors=6, n_obstacles=8, seed=2,
        gating="jnp", obstacle_omega=omega, dtype=jnp.float64))
    assert to.gating_overflow_count == ()
    np.testing.assert_allclose(to.min_pairwise_distance.numpy(),
                               np.asarray(jo.min_pairwise_distance),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tf.v.numpy(), np.asarray(jf.v), rtol=0,
                               atol=1e-10)
    if omega == 2.0:
        assert float(to.max_relax_rounds.max()) >= 1.0


def test_obstacle_min_distance_includes_obstacles():
    """One agent parked next to a static obstacle: the step's min distance
    is the agent-obstacle gap, and only that agent's filter engages."""
    cfg = tsw.Config(n=2, steps=1, n_obstacles=1, obstacle_layout="static",
                     obstacle_orbit_frac=0.0, spawn_half_width_override=3.0)
    step = tsw.make(cfg, device="cpu")[1]
    x = torch.tensor([[0.3, 0.0], [5.0, 5.0]])
    _, out = step(tsw.State(x=x, v=torch.zeros_like(x)), 0)
    assert float(out.min_pairwise_distance) == pytest.approx(0.3)
    assert int(out.filter_active_count) == 1


@pytest.mark.parametrize("override", [{"dynamics": "double"},
                                      {"rta": True},
                                      {"gating_rebuild_skin": 0.1}])
def test_queue_a5_knobs_with_obstacles_match_jax(override):
    """The Queue A5 knobs among obstacles (they raised OutOfSliceError
    before they were ported): the port's rollout holds the JAX package's
    with test_torch_swarm.py's float32 tolerances (the Verlet cache has no
    float64 reference: its rebuild cond does not trace under x64)."""
    jcfg = jsw.Config(n=16, steps=20, n_obstacles=2, gating="jnp",
                      spawn_half_width_override=0.6, **override)
    s0, jstep = jsw.make(jcfg)
    jf, jo = jeng.rollout(jstep, s0, jcfg.steps)
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = "float32"
    tcfg = convert.config_from_fields(fields)
    _, tstep = tsw.make(tcfg, device="cpu")
    tf, to = teng.rollout(tstep, convert.state_from_reference(
        s0, device="cpu", dtype=torch.float32), tcfg.steps)
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=name)
    assert int(to.filter_active_count.max()) > 0
    np.testing.assert_allclose(to.min_pairwise_distance.numpy(),
                               np.asarray(jo.min_pairwise_distance),
                               rtol=1e-6)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), atol=1e-5)
    np.testing.assert_allclose(tf.v.numpy(), np.asarray(jf.v), atol=1e-5)
