"""The port's reference scenarios (cbf_tpu_torch.scenarios.meet_at_center,
.cross_and_rescue, .antipodal) against the JAX package's, and the port's
copy of the SLSQP oracle.

Each scenario runs in both packages from the same numpy state (the JAX
``State`` carried across by ``convert.scenario_state_from_reference``);
their "weights", the consensus and adjacency matrices, are built by each
package's ``make`` from the same Config, and are held equal here.
Tolerances: float64 poses (and obstacle positions, velocities) atol 1e-9,
min distances and certificate residuals atol 1e-9, every count exact. The
compiled rollout on the CPU runs the body a CUDA graph captures on the
card, uncaptured: it must equal ``engine.eager_rollout`` bit for bit, and
the body must make no host traffic. The golden anchor replays
meet_at_center in float64 numpy through the port's oracle (atol 5e-5, as
tests/test_scenarios.py holds the JAX package).
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cbf_tpu.oracle import OracleCBF as JaxOracle
from cbf_tpu.rollout import engine as jeng
from cbf_tpu.scenarios import antipodal as jant
from cbf_tpu.scenarios import cross_and_rescue as jcar
from cbf_tpu.scenarios import meet_at_center as jmac
from cbf_tpu.sim import graph as jgr
from cbf_tpu_torch import convert
from cbf_tpu_torch.oracle import OracleCBF
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.scenarios import antipodal as tant
from cbf_tpu_torch.scenarios import cross_and_rescue as tcar
from cbf_tpu_torch.scenarios import meet_at_center as tmac
from cbf_tpu_torch.sim import graph as tgr

COUNTS = ("filter_active_count", "infeasible_count", "max_relax_rounds",
          "gating_dropped_count")
FLOATS = ("min_pairwise_distance", "certificate_residual", "trajectory")
# name -> (JAX module, port module, horizon field, parity steps, fields).
SCENARIOS = {
    # meet_at_center's filter first engages (and relaxes) at step 51.
    "meet_at_center": (jmac, tmac, "iterations", 80, {}),
    "cross_and_rescue": (jcar, tcar, "iterations", 30, {}),
    "antipodal": (jant, tant, "steps", 100, {"n": 16}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(name, steps, dtype_name):
    jmod, tmod, field, _, fields = SCENARIOS[name]
    jcfg = jmod.Config(**fields, **{field: steps},
                       dtype=getattr(jnp, dtype_name))
    tcfg = convert.config_from_fields(
        {**dataclasses.asdict(jcfg), "dtype": dtype_name}, cls=tmod.Config)
    return jcfg, tcfg


def _port(name, tcfg):
    tmod = SCENARIOS[name][1]
    state0, step = tmod.make(tcfg, device="cpu")
    return state0, step


def _leaves(v):
    """A StepOutputs field's arrays: a tensor or array, or a flat tuple of
    them (cross_and_rescue's recorded robots and obstacles)."""
    return list(v) if isinstance(v, tuple) else [v]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_weights_equal(name):
    """The consensus and adjacency matrices each package builds."""
    cfg = SCENARIOS[name][0].Config()
    if name == "meet_at_center":
        laps = [jgr.cycle_gl(cfg.n_obstacles), jgr.complete_gl(cfg.n_free)]
    elif name == "cross_and_rescue":
        np.testing.assert_array_equal(tcar.L2_GOAL, jcar.L2_GOAL)
        laps = [jgr.cycle_gl(cfg.n_obstacles), jcar.L2_GOAL]
    else:
        np.testing.assert_array_equal(
            tant.goals(tant.Config(), device="cpu").numpy(),
            np.asarray(jant.goals(jant.Config())))
        laps = []
    for L in laps:
        np.testing.assert_array_equal(
            tgr.adjacency_from_laplacian(L).numpy(),
            np.asarray(jgr.adjacency_from_laplacian(L)))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_rollout_matches_jax_f64(name, x64):
    jmod, tmod, field, steps, _ = SCENARIOS[name]
    jcfg, tcfg = _configs(name, steps, "float64")
    js0, jstep = jmod.make(jcfg)
    jf, jo = jeng.rollout(jstep, js0, steps)
    _, tstep = _port(name, tcfg)
    ts0 = convert.scenario_state_from_reference(
        js0, tmod.State, device="cpu", dtype=torch.float64)
    tf, to = teng.rollout(tstep, ts0, steps)
    for leaf in tmod.State._fields:
        np.testing.assert_allclose(getattr(tf, leaf).numpy(),
                                   np.asarray(getattr(jf, leaf)),
                                   rtol=0, atol=1e-9, err_msg=leaf)
    for field_name in COUNTS + FLOATS:
        got, want = getattr(to, field_name), getattr(jo, field_name)
        assert isinstance(got, tuple) == isinstance(want, tuple), field_name
        for g, w in zip(_leaves(got), _leaves(want)):
            if field_name in COUNTS:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=field_name)
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                           atol=1e-9, err_msg=field_name)
    # The runs must exercise what they hold: the filter engages.
    assert int(to.filter_active_count.sum()) > 0


def _same(a, b, what):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), what


@pytest.mark.parametrize("name,steps,rounds",
                         [("meet_at_center", 20, None),
                          ("meet_at_center", 60, 0),
                          ("cross_and_rescue", 4, None),
                          ("antipodal", 20, None)])
def test_compiled_rollout_equals_eager(name, steps, rounds):
    """float32 on the CPU; R=0 on meet_at_center's step forces the chunk's
    eager redo where a step relaxes."""
    _, tcfg = _configs(name, steps, "float32")
    state0, step = _port(name, tcfg)
    if rounds is not None:
        step.relax_rounds = rounds
    redos = teng.COUNTS["redos"]
    final, outs = teng.rollout(step, state0, steps)
    want_final, want = teng.eager_rollout(step, state0, steps)
    _same(final, want_final, "final state")
    for field_name, a, b in zip(teng.StepOutputs._fields, outs, want):
        _same(a, b, field_name)
    if rounds == 0:
        assert float(want.max_relax_rounds.max()) > 0
        assert teng.COUNTS["redos"] == redos + 1


def _raise(what):
    def fail(*a, **k):
        raise AssertionError(f"{what} inside the captured body")
    return fail


@contextlib.contextmanager
def _no_host_traffic():
    """What a CUDA graph capture refuses or cannot record, patched to
    raise (as tests/test_torch_rollout.py's probe)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "tensor", _raise("torch.tensor"))
        mp.setattr(torch, "as_tensor", _raise("torch.as_tensor"))
        for name in ("item", "__bool__", "cpu", "__float__", "__int__",
                     "__index__", "tolist", "numpy"):
            mp.setattr(torch.Tensor, name, _raise(f"Tensor.{name}"))
        yield


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_capture_body_makes_no_host_traffic(name):
    """The engine's program for 3 steps: the first body runs as the
    warm-up a capture follows, the next two as one body under the
    patches, and the result still equals the eager loop."""
    _, tcfg = _configs(name, 3, "float32")
    state0, step = _port(name, tcfg)
    prog = teng._program(step, state0, 3, unroll=2)
    prog.load(state0)
    prog.start(0)
    prog.body(step, 1)
    with _no_host_traffic():
        prog.body(step, 2)
    assert not bool(prog.flag)
    want_final, want = teng.eager_rollout(step, state0, 3)
    _same(prog.carry, want_final, "carry")
    for field_name, a, b in zip(teng.StepOutputs._fields, prog.outs, want):
        _same(a, b, field_name)


def test_golden_anchor_through_the_ports_oracle():
    """meet_at_center in float64 against the numpy replay with the port's
    own OracleCBF (the JAX package's test_meet_at_center_trace_oracle_
    parity), atol 5e-5 at every step (chip_smoke.py phase 13d on the
    card)."""
    worst = chip_smoke.golden_anchor(
        tmac, tmac.Config(iterations=5, dtype=torch.float64), 5,
        device="cpu")
    assert worst <= 5e-5


def test_oracle_equals_jax_packages(rng):
    """The port's copy of the oracle gives the JAX package's controls, rows
    and relax counts on random filter problems, infeasible ones included
    (obstacles rushing inward force relax rounds)."""
    fx = 0.1 * np.zeros((4, 4))
    gx = 0.1 * np.array([[1.0, 0], [0, 1.0], [0, 0], [0, 0]])
    ours, theirs = OracleCBF(15.0), JaxOracle(15.0)
    relaxed = 0
    for case in range(16):
        m = int(rng.integers(1, 6))
        robot = rng.uniform(-1, 1, 4)
        obs = robot[None, :] + rng.uniform(-0.15, 0.15, (m, 4))
        if case % 4 == 0:
            obs[:, 2:] = -20.0 * (robot[None, :2] - obs[:, :2])
        u0 = rng.uniform(-0.2, 0.2, 2)
        np.testing.assert_array_equal(
            ours.get_safe_control(robot, obs, fx, gx, u0),
            theirs.get_safe_control(robot, obs, fx, gx, u0))
        assert ours.last_relax_rounds == theirs.last_relax_rounds
        relaxed += ours.last_relax_rounds > 0
        for a, b in zip(ours.barrier_rows(robot, obs, fx, gx, u0),
                        theirs.barrier_rows(robot, obs, fx, gx, u0)):
            np.testing.assert_array_equal(a, b)
    assert relaxed > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_entry_points_need_the_card_unless_asked(name):
    """No fallback: make and run without ``device`` mean the card, and
    raise without one."""
    tmod = SCENARIOS[name][1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmod.make(tmod.Config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmod.run(tmod.Config())
