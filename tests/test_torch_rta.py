"""The port's runtime assurance (cbf_tpu_torch.rta and the ladder wired
into cbf_tpu_torch.scenarios.swarm behind Config.rta, driven by the
injectors of cbf_tpu_torch.utils.faults) against the JAX package's.

- rta/core function by function against cbf_tpu.rta.core, and the
  monitor's transitions and events against cbf_tpu.rta.monitor's;
- the rung-3 (NaN-poisoned agent) and rung-1 (teleported clump among
  obstacles) scenarios of tests/test_rta.py at their N, through both
  packages: the rta_mode series equal, every count equal, final states
  within float32 atol 1e-5 (float64 atol 1e-10);
- armed but healthy: bit-equal to rta=False on x, v and every count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.rollout import engine as jeng
from cbf_tpu.rta import core as jcore
from cbf_tpu.rta import monitor as jmon
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.utils import faults as jfaults
from cbf_tpu_torch import convert, rta as trta
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.rta import core as tcore
from cbf_tpu_torch.rta import monitor as tmon
from cbf_tpu_torch.scenarios import swarm as tsw
from cbf_tpu_torch.utils import faults as tfaults

COUNTS = ("filter_active_count", "infeasible_count", "gating_dropped_count",
          "max_relax_rounds", "rta_mode")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- rta/core -----------------------------------------------------------------

def test_constants_and_exports_match_jax():
    import cbf_tpu.rta as jrta

    for name in jrta.__dict__:
        if name.isupper() or name in ("HEALTH_BIT_NAMES",
                                      "EMITTED_EVENT_TYPES"):
            assert getattr(trta, name) == getattr(jrta, name), name
    public = sorted(n for n in vars(jrta) if not n.startswith("_")
                    and n not in ("core", "monitor"))
    assert public == sorted(n for n in vars(trta) if not n.startswith("_")
                            and n not in ("core", "monitor"))


def test_core_functions_match_jax():
    rng = np.random.default_rng(0)
    n = 40
    flags = {name: rng.uniform(size=n) < 0.2 for name in
             ("infeasible", "carry_reset", "actuation_deficit",
              "state_nonfinite", "control_nonfinite")}
    for kw in (flags, {"cert_residual": True, "infeasible":
                       flags["infeasible"]}, {}):
        want = np.asarray(jcore.health_word(
            n, **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                  for k, v in kw.items()}))
        got = tcore.health_word(
            n, **{k: (torch.as_tensor(v) if isinstance(v, np.ndarray)
                      else v) for k, v in kw.items()})
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tcore.demanded_rung(got).numpy(),
            np.asarray(jcore.demanded_rung(jnp.asarray(want))))
    # Every word of the six bits.
    words = np.arange(64, dtype=np.int32)
    got = tcore.demanded_rung(torch.as_tensor(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcore.demanded_rung(jnp.asarray(words))))
    # The latch over random demand sequences.
    jm = js = jnp.zeros((n,), jnp.int32)
    tm = ts = torch.zeros((n,), dtype=torch.int32)
    for _ in range(60):
        d = rng.choice(4, size=n, p=[0.7, 0.1, 0.1, 0.1]).astype(np.int32)
        jm, js = jcore.latch_update(jm, js, jnp.asarray(d), 4)
        tm, ts = tcore.latch_update(tm, ts, torch.as_tensor(d), 4)
        assert tm.dtype == ts.dtype == torch.int32
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # finite_rows and the backup controller.
    x = rng.normal(size=(n, 2)).astype(np.float32)
    x[3, 1] = np.nan
    th = rng.normal(size=n).astype(np.float32)
    th[7] = np.inf
    np.testing.assert_array_equal(
        tcore.finite_rows(torch.as_tensor(x), torch.as_tensor(th),
                          ()).numpy(),
        np.asarray(jcore.finite_rows(jnp.asarray(x), jnp.asarray(th), ())))
    with pytest.raises(ValueError):
        tcore.finite_rows((), ())
    v = rng.normal(size=(n, 2)).astype(np.float32) * 3
    m = np.arange(n) < 13
    for dyn in ("single", "unicycle", "double", "mixed"):
        kw = {"dynamics_mask": m} if dyn == "mixed" else {}
        want = jcore.backup_control(jnp.asarray(v), dynamics=dyn,
                                    **{k: jnp.asarray(a)
                                       for k, a in kw.items()})
        got = tcore.backup_control(torch.as_tensor(v), dynamics=dyn,
                                   **{k: torch.as_tensor(a)
                                      for k, a in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="dynamics_mask"):
        tcore.backup_control(torch.as_tensor(v), dynamics="mixed")
    seed = tcore.rta_seed(torch.as_tensor(x), torch.zeros(n, 2))
    assert [tuple(a.shape) for a in seed[:4]] == [(n,), (n,), (n, 2), (n, 2)]
    assert seed[0].dtype == seed[1].dtype == torch.int32 and seed[4] == ()


def test_monitor_matches_jax():
    class Counter:
        def __init__(self):
            self.total = 0

        def add(self, n):
            self.total += n

    class Registry:
        def __init__(self):
            self.counters = {}

        def counter(self, name):
            return self.counters.setdefault(name, Counter())

    class Sink:
        def __init__(self, with_registry):
            self.events = []
            self.registry = Registry() if with_registry else None

        def event(self, kind, payload):
            self.events.append((kind, payload))

    for series in ([0, 1, 1, 3, 0, 2, 0], [0, 0], [2, 2, 1, 0, 0, 3], []):
        arr = np.asarray(series, np.int32)
        assert tmon.rta_transitions(torch.as_tensor(arr)) == \
            jmon.rta_transitions(arr)
        for with_registry in (True, False):
            ts, js = Sink(with_registry), Sink(with_registry)
            got = tmon.emit_rta_events(ts, torch.as_tensor(arr),
                                       step_offset=100)
            want = jmon.emit_rta_events(js, arr, step_offset=100)
            assert got == want and ts.events == js.events
            if with_registry:
                assert ({k: c.total for k, c in ts.registry.counters.items()}
                        == {k: c.total
                            for k, c in js.registry.counters.items()})
    assert tmon.rta_transitions(()) == []
    assert tmon.emit_rta_events(None, ()) == jmon.emit_rta_events(None, ())


# -- the ladder in the step -----------------------------------------------------

def _port_config(jcfg):
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    return convert.config_from_fields(fields)


def _run_both(jcfg, wrap):
    s0, jstep = jsw.make(jcfg)
    jf, jo = jeng.rollout(wrap(jfaults, jstep), s0, jcfg.steps)
    tcfg = _port_config(jcfg)
    _, tstep = tsw.make(tcfg, device="cpu")
    ts0 = convert.state_from_reference(s0, device="cpu", dtype=tcfg.dtype)
    tstep = wrap(tfaults, tstep)
    before = dict(teng.COUNTS)
    tf, to = teng.rollout(tstep, ts0, tcfg.steps)
    redos = teng.COUNTS["redos"] - before["redos"]
    atol = 1e-10 if tcfg.dtype == torch.float64 else 1e-5
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=name)
    for got, want in zip(teng._leaves(tf), (
            np.asarray(a) for a in jax.tree_util.tree_leaves(jf))):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    return to, redos


@pytest.fixture(params=["float32", "float64"])
def dtype_name(request):
    if request.param == "float64":
        request.getfixturevalue("x64")
    return request.param


def test_rung3_poison_matches_jax(dtype_name):
    """tests/test_rta.py's rung-3 acceptance: the poisoned row is scrubbed
    at step 30 and the latch releases after the hysteresis window."""
    jcfg = jsw.Config(n=16, steps=80, rta=True, rta_recover_steps=10,
                      dtype=getattr(jnp, dtype_name))
    to, _ = _run_both(jcfg, lambda F, s: F.poison_agent_at_step(s, 30,
                                                                agent=0))
    modes = to.rta_mode.numpy()
    assert modes[30] == tcore.RUNG_SCRUB and modes[-1] == 0


def test_rung1_clump_matches_jax(dtype_name):
    """tests/test_rta.py's rung-1 acceptance: a sub-floor clump near the
    obstacle ring engages the boosted re-solve, which the compiled body
    leaves to the eager redo (one redo here), and is released."""
    jcfg = jsw.Config(n=16, steps=120, n_obstacles=4, rta=True,
                      rta_recover_steps=10, dtype=getattr(jnp, dtype_name))
    to, redos = _run_both(jcfg, lambda F, s: F.teleport_clump_at_step(
        s, 10, agents=tuple(range(8)), spacing=0.01))
    modes = to.rta_mode.numpy()
    assert tcore.RUNG_RESOLVE in modes and modes[-1] == 0
    assert redos == 1


@pytest.mark.parametrize("family", ["single", "double", "unicycle",
                                    "mixed"])
def test_armed_healthy_equals_rta_off(family):
    extra = {"n_double": 20} if family == "mixed" else {}
    cfg = tsw.Config(n=64, steps=30, dynamics=family, **extra)
    s_off, step_off = tsw.make(cfg, device="cpu")
    s_on, step_on = tsw.make(dataclasses.replace(cfg, rta=True),
                             device="cpu")
    f_off, o_off = teng.rollout(step_off, s_off, cfg.steps)
    f_on, o_on = teng.rollout(step_on, s_on, cfg.steps)
    assert torch.equal(f_on.x, f_off.x) and torch.equal(f_on.v, f_off.v)
    for name, a, b in zip(teng.StepOutputs._fields, o_on, o_off):
        if name == "rta_mode":
            assert b == () and int(a.max()) == 0
        elif isinstance(a, tuple):
            assert b == ()
        else:
            assert torch.equal(a, b), name
    assert f_off.rta == () and len(f_on.rta) == 5


def test_rta_knob_checks_match_jax():
    for bad in ({"rta_recover_steps": 0}, {"rta_residual_gate": 0.0},
                {"rta_deficit_gate": -1.0}, {"rta_boost_budget": 0}):
        with pytest.raises(ValueError):
            jsw.make(jsw.Config(n=8, rta=True, **bad))
        with pytest.raises(ValueError):
            tsw.make(tsw.Config(n=8, rta=True, **bad), device="cpu")


def test_fault_wrappers_forward_the_step():
    cfg = tsw.Config(n=32, steps=4, n_obstacles=2, rta=True)
    state0, step = tsw.make(cfg, device="cpu")
    for wrapped in (tfaults.poison_agent_at_step(step, -1),
                    tfaults.teleport_clump_at_step(step, -1, agents=[0, 1])):
        assert wrapped.relax_rounds == step.relax_rounds
        assert wrapped.host_inputs is step.host_inputs
        # A fault that never fires leaves the run bit-equal.
        fa, oa = teng.rollout(wrapped, state0, 4)
        fb, ob = teng.rollout(step, state0, 4)
        for a, b in zip(teng._leaves((fa, oa)), teng._leaves((fb, ob))):
            assert torch.equal(a, b)
    # The clump lands where JAX puts it.
    x = torch.zeros((10, 2))
    seen = {}

    def probe(state, t, inputs=None):
        seen["x"] = state.x
        return state, None

    tfaults.teleport_clump_at_step(probe, 3, agents=range(2, 6),
                                   spacing=0.02, center=(1.0, -1.0))(
        tsw.State(x=x, v=x), 3)
    want = jfaults.teleport_clump_at_step(
        lambda s, t: (s, None), 3, agents=range(2, 6), spacing=0.02,
        center=(1.0, -1.0))(jsw.State(x=jnp.zeros((10, 2)),
                                      v=jnp.zeros((10, 2))), 3)[0].x
    np.testing.assert_array_equal(seen["x"].numpy(), np.asarray(want))
