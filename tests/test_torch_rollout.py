"""The port's compiled rollout (cbf_tpu_torch.rollout.engine) and the
guarded relax rounds it captures (cbf_tpu_torch.solvers.exact2d), on the
CPU.

On the card ``rollout``/``rollout_chunked`` capture the step as a CUDA
graph and replay it; on the CPU the engine runs the very body that is
captured (static buffers, the step clock as a device tensor, obstacle rows
gathered from a device table, guarded relax rounds, the redo path) and
only skips the capture. Held here:

- ``relax_guarded`` bit for bit equal to the host-guarded ``_relax_loop``
  wherever its pending flag stays clear, and the flag set exactly where
  the loop runs more rounds than the guard (float32 and float64, at and
  beyond ``max_relax``, under caps with an uncapped row and with every
  relaxable row capped);
- the compiled ``rollout``/``rollout_chunked`` bit for bit equal to the
  eager loop (``eager_rollout``) on the dense, kernel-plain, streaming and
  banded paths, the obstacle orbit — with R = 0 there, which forces the
  redo path — the double, unicycle and mixed dynamics (the mixed swarm's
  per-agent filter lanes under the guard, and at R = 0), the Verlet cache
  (the rebuild picked on the device), RTA (the poisoned lane's scrub;
  the clump's boosted re-solve, which the body hands to the redo) and the
  joint certificate (sparse, dense, fused with its Verlet cache, and warm
  with the adaptive budget at B = 1 guarded block, which forces the
  redo), for every ``unroll``, and leaving ``state0`` untouched;
- the same runs against the JAX package's ``rollout_chunked`` with the
  tolerances tests/test_torch_swarm.py and tests/test_torch_obstacles.py
  state: float32 min distance rtol 1e-6, x and v atol 1e-5; float64 atol
  1e-10; every count exact;
- ``plan_chunks(pad=)`` and ``stack_host_chunks(axis=)`` equal to JAX's;
- the capture body makes no host read and no host-to-device copy: one
  body runs with ``torch.tensor``, ``torch.as_tensor`` and the Tensor
  methods that read a device value on the host patched to raise.
"""

import contextlib
import dataclasses
import inspect
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.rollout import engine as jeng
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu_torch import convert
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.scenarios import swarm as tsw
from cbf_tpu_torch.solvers import exact2d as tqp
from cbf_tpu_torch.utils import faults

COUNTS = ("filter_active_count", "infeasible_count", "gating_dropped_count",
          "max_relax_rounds")
# The obstacle ring of tests/test_torch_obstacles.py at omega=2: its QPs
# relax from step 5 on, so R = 0 forces a redo.
ORBIT = dict(n=96, k_neighbors=6, n_obstacles=8, seed=2,
             obstacle_omega=2.0, gating="jnp")
PATHS = {
    "dense": dict(n=64, steps=12, gating="jnp", record_trajectory=True),
    "kernel": dict(n=128, steps=12),
    "streaming": dict(n=128, steps=12, gating="streaming"),
    "banded": dict(n=256, steps=12, gating="banded",
                   gating_window_blocks=2),
    "orbit": dict(steps=30, **ORBIT),
    "orbit R=0": dict(steps=30, **ORBIT),
    "double": dict(n=64, steps=12, dynamics="double"),
    "unicycle": dict(n=64, steps=12, dynamics="unicycle"),
    "mixed": dict(n=64, steps=12, dynamics="mixed", n_double=20),
    # Packed: the per-agent lanes relax from the first step.
    "mixed R=0": dict(n=16, steps=12, dynamics="mixed", n_double=8,
                      spawn_half_width_override=0.25),
    "verlet": dict(n=128, steps=12, gating_rebuild_skin=0.1),
    "verlet dense": dict(n=64, steps=12, gating="jnp",
                         gating_rebuild_skin=0.1),
    "rta poison": dict(n=16, steps=12, rta=True,
                       spawn_half_width_override=0.5),
    "rta clump": dict(n=16, steps=30, n_obstacles=4, rta=True),
    # The joint certificate on packed spawns, where it binds.
    "cert sparse": dict(n=64, steps=6, certificate=True,
                        certificate_backend="sparse",
                        spawn_half_width_override=0.8),
    # One guarded block of the adaptive budget (B = 1) where the solves
    # need three or four: the redo path.
    "cert warm tol B=1": dict(n=64, steps=6, certificate=True,
                              certificate_backend="sparse",
                              certificate_warm_start=True,
                              certificate_tol=1e-5,
                              spawn_half_width_override=0.8),
    "cert fused skin": dict(n=64, steps=6, certificate=True,
                            certificate_backend="sparse",
                            certificate_fused=True,
                            certificate_rebuild_skin=0.1,
                            spawn_half_width_override=0.8),
    "cert dense": dict(n=32, steps=6, certificate=True,
                       spawn_half_width_override=0.6),
}
# Fault injectors at step 1 (inside the capture probe's second body).
WRAPS = {
    "rta poison": lambda step: faults.poison_agent_at_step(step, 1),
    "rta clump": lambda step: faults.teleport_clump_at_step(
        step, 1, agents=range(8)),
}
# Paths whose chunks are redone: R = 0, the boosted re-solve, and B = 1.
REDONE = ("orbit R=0", "mixed R=0", "rta clump", "cert warm tol B=1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small tensors: torch's intra-op pool only spins cores that the rest
    # of a parallel test run is timing on.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(t):
    """Floats as their bit patterns (so -0.0 and 0.0 differ)."""
    if t.is_floating_point():
        return t.view(torch.int64 if t.dtype == torch.float64
                      else torch.int32)
    return t


def _assert_same(a, b, what=""):
    """Tensor trees equal bit for bit (numpy arrays taken as tensors);
    ``()`` fields ``()`` on both sides."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            name = a._fields[i] if hasattr(a, "_fields") else str(i)
            _assert_same(x, y, f"{what}.{name}")
        return
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(_bits(a), _bits(b)), what


# -- the guarded relax rounds ------------------------------------------------

def _strips(dtype, caps: str):
    """Random relaxable lanes (some infeasible until a few rounds) plus
    strips of width 1, 3, 5 and 20 in x (lanes 0-3), which a +1 round per
    side opens after 1, 2, 3 and 10 rounds. ``caps``: "none";
    "uncapped-row" (each strip's first row and random rows with b > 0
    capped at 0.25, so the strips open after 1, 3, 5 and 20 rounds of
    their uncapped row); "all" (every row capped at 0.25, so the strips
    never open: the loop spins to max_relax, the caller contract's case).
    Returns the agents-last lanes of exact2d: (At, bt, rt, ct, tol)."""
    rng = np.random.default_rng(21)
    B, M = 40, 8
    A = rng.normal(size=(B, M, 2))
    b = rng.normal(size=(B, M)) + 0.5
    relax = np.ones((B, M))
    for lane, gap in enumerate((1.0, 3.0, 5.0, 20.0)):
        A[lane, :2] = [[1.0, 0.0], [-1.0, 0.0]]
        b[lane, :2] = -gap / 2
    cap = None
    if caps == "uncapped-row":
        cap = np.where((rng.uniform(size=(B, M)) < 0.3) & (b > 0), 0.25,
                       np.inf)
        cap[:4, 0] = 0.25
    elif caps == "all":
        cap = np.full((B, M), 0.25)
    t = {np.float32: torch.float32, np.float64: torch.float64}[dtype]
    At, bt, rt, ct, dt = tqp._lanes(
        torch.as_tensor(A, dtype=t), torch.as_tensor(b, dtype=t),
        torch.as_tensor(relax, dtype=t),
        None if cap is None else torch.as_tensor(cap, dtype=t))
    return At, bt, rt, ct, tqp._feas_tol(dt)


@pytest.mark.parametrize("rounds", [0, 1, 2, 3, 9, 10, 20, 64, 80])
@pytest.mark.parametrize("max_relax", [3, 64])
@pytest.mark.parametrize("caps", ["none", "uncapped-row", "all"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_relax_guarded_matches_loop(dtype, caps, max_relax, rounds):
    At, bt, rt, ct, tol = _strips(dtype, caps)
    I, J = tqp._pairs(At.shape[0], At.device)
    want = tqp._relax_loop(At, bt, rt, ct, tol, I, J, max_relax)
    *got, pending = tqp.relax_guarded(At, bt, rt, ct, tol, I, J, max_relax,
                                      rounds)
    loop_rounds = float(want[2].max())
    assert pending.shape == () and pending.dtype == torch.bool
    assert bool(pending) == (loop_rounds > min(rounds, max_relax))
    if not bool(pending):
        _assert_same(tuple(got), tuple(want))
    if max_relax == 64 and caps != "all":
        assert loop_rounds == (10.0 if caps == "none" else 20.0)
    if caps == "all":
        assert loop_rounds == max_relax and not bool(want[1][:4].any())


@pytest.mark.parametrize("rounds", [2, 10])
def test_guarded_solvers_match_the_loop(rounds):
    """solve_qp_2d_batch and solve_qp_2d inside guarded_relax: equal to
    the loop while the flag stays clear, the flag raised (and kept) once a
    solve needs more rounds."""
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.normal(size=(30, 6, 2)))
    b = torch.as_tensor(rng.normal(size=(30, 6)) + 0.5)
    relax = torch.ones((30, 6), dtype=torch.float64)
    A[0, :2] = torch.tensor([[1.0, 0.0], [-1.0, 0.0]])
    b[0, :2] = -10.0                   # needs 10 rounds
    flag = torch.zeros((), dtype=torch.bool)
    with tqp.guarded_relax(rounds, flag):
        xg, ig = tqp.solve_qp_2d_batch(A, b, relax)
        xs, is_ = tqp.solve_qp_2d(A[1], b[1], relax[1])
    assert bool(flag) == (rounds < 10)
    x, info = tqp.solve_qp_2d_batch(A, b, relax)
    x1, info1 = tqp.solve_qp_2d(A[1], b[1], relax[1])
    _assert_same((xs, tuple(is_)), (x1, tuple(info1)))
    if rounds == 10:
        _assert_same((xg, tuple(ig)), (x, tuple(info)))
        assert float(info.relax_rounds[0]) == 10.0
    with pytest.raises(ValueError):
        with tqp.guarded_relax(-1, flag):
            pass


# -- the compiled rollout against the eager loop -----------------------------

def _make(path: str):
    cfg = tsw.Config(**PATHS[path])
    state0, step = tsw.make(cfg, device="cpu")
    if path in WRAPS:
        step = WRAPS[path](step)
    if path.endswith("R=0"):
        step.relax_rounds = 0
    if path.endswith("B=1"):
        step.admm_blocks = 1
    return cfg, state0, step


@pytest.mark.parametrize("path", sorted(PATHS))
def test_rollout_equals_the_eager_loop(path):
    cfg, state0, step = _make(path)
    want_final, want = teng.eager_rollout(step, state0, cfg.steps)
    before = dict(teng.COUNTS)
    final, outs = teng.rollout(step, state0, cfg.steps)
    redos = teng.COUNTS["redos"] - before["redos"]
    _assert_same(final, want_final, "final")
    _assert_same(outs, want, "outs")
    final_c, outs_c, start = teng.rollout_chunked(step, state0, cfg.steps,
                                                  chunk=7)
    assert start == 0
    _assert_same(final_c, want_final, "chunked final")
    _assert_same(outs_c, want, "chunked outs")
    assert int(want.filter_active_count.max()) > 0
    # R = 0 redoes every chunk that relaxed, the boosted re-solve every
    # chunk that needs it; the steps' own R none here.
    assert (redos > 0) == (path in REDONE)
    assert ((teng.COUNTS["redo_steps"] > before["redo_steps"])
            == (redos > 0))
    if path.startswith("orbit") or path.endswith("R=0"):
        assert float(want.max_relax_rounds.max()) >= 1.0
    if path.startswith("rta"):
        assert int(want.rta_mode.max()) > 0
    if path == "banded":
        assert want.gating_overflow_count.shape == (cfg.steps,)
    if path.startswith("cert"):
        assert float(want.certificate_residual.max()) < 1e-4
    if path.endswith("B=1"):
        assert int(want.certificate_iterations.min()) > 10


@pytest.mark.parametrize("unroll", [1, 3, 8, True])
def test_unroll_is_bit_identical(unroll):
    """The obstacle orbit (host inputs, guarded rounds, redo at R = 0)
    with ``unroll`` steps per body, whole and in chunks of 7 (a partial
    body and a partial chunk each)."""
    for path in ("orbit", "orbit R=0"):
        cfg, state0, step = _make(path)
        steps = 20
        want_final, want = teng.eager_rollout(step, state0, steps)
        final, outs = teng.rollout(step, state0, steps, unroll=unroll)
        _assert_same((final, outs), (want_final, want), f"{path} rollout")
        final_c, outs_c, _ = teng.rollout_chunked(step, state0, steps,
                                                  chunk=7, unroll=unroll)
        _assert_same((final_c, outs_c), (want_final, want),
                     f"{path} rollout_chunked")


@pytest.mark.parametrize("donate", [None, True, False])
def test_donate_carry_leaves_state0_untouched(donate):
    cfg, state0, step = _make("orbit")
    copy0 = tsw.State(x=state0.x.clone(), v=state0.v.clone())
    want_final, want = teng.eager_rollout(step, state0, 16)
    final, outs, _ = teng.rollout_chunked(step, state0, 16, chunk=5,
                                          donate_carry=donate)
    _assert_same(state0, copy0, "state0")
    _assert_same((final, outs), (want_final, want))
    # The returned state is the caller's: a later run does not write it.
    kept = tsw.State(x=final.x.clone(), v=final.v.clone())
    teng.rollout_chunked(step, final, 16, chunk=5, donate_carry=donate)
    teng.rollout(step, state0, 5)
    _assert_same(final, kept, "returned state")


def test_programs_are_cached_on_the_step():
    cfg, state0, step = _make("kernel")
    teng.rollout(step, state0, 4)
    teng.rollout(step, state0, 4)
    assert len(step._rollout_programs) == 1
    teng.rollout(step, state0, 4, unroll=2)
    # Chunks of 4, 4 and 2 steps: the 4-step program again, and a 2-step.
    teng.rollout_chunked(step, state0, 10, chunk=4)
    assert len(step._rollout_programs) == 3
    assert teng.rollout(step, state0, 0) == (state0, None)


def test_engine_arguments_follow_jax(tmp_path):
    """The engine's signatures are JAX's, and the telemetry and cost-model
    knobs run: the values of the run without them, a heartbeat every
    ``telemetry_every`` steps, one measured capture and one execute."""
    from cbf_tpu_torch import obs

    for name in ("rollout", "rollout_chunked", "plan_chunks",
                 "stack_host_chunks"):
        want = inspect.signature(getattr(jeng, name)).parameters
        got = inspect.signature(getattr(teng, name)).parameters
        assert list(got) == list(want), name
        assert [p.default for p in got.values()] == [
            p.default for p in want.values()], name
    cfg, state0, step = _make("kernel")
    with pytest.raises(ValueError, match="unroll"):
        teng.rollout(step, state0, 2, unroll=0)
    f1, o1 = teng.rollout(step, state0, 3, telemetry_every=7,
                          cost_label="x")
    f2, o2, _ = teng.rollout_chunked(step, state0, 3, chunk=2, resume=False,
                                     telemetry_every=7, cost_label="x")
    _assert_same((f1, o1), (f2, o2))
    sink = obs.TelemetrySink(str(tmp_path))
    _assert_same(teng.rollout(step, state0, 3, telemetry=sink,
                              telemetry_every=2), (f1, o1), "telemetry")
    assert [e["step"] for e in obs.read_events(str(tmp_path))] == [0, 2]
    model = obs.CostModel()
    _assert_same(teng.rollout(step, state0, 3, cost_model=model,
                              cost_label="x"), (f1, o1), "cost model")
    assert model.entries["x"]["compiles"] == 1
    assert model.entries["x"]["executes"] == 1


class _Metrics(NamedTuple):
    a: object
    b: object
    c: object = ()


def test_plan_chunks_and_stack_host_chunks_match_jax():
    for args in [(0, 10, 3), (4, 10, 3), (0, 9, 3), (0, 0, 5), (2, 3, 8)]:
        for pad in (False, True):
            assert (teng.plan_chunks(*args, pad=pad)
                    == jeng.plan_chunks(*args, pad=pad))
    rng = np.random.default_rng(4)
    parts = [_Metrics(rng.normal(size=(3, n)),
                      rng.integers(0, 9, size=(3, n, 2)))
             for n in (4, 2, 5)]
    for axis in (0, 1):
        sub = parts if axis == 1 else [
            _Metrics(p.a.T, p.b.transpose(1, 0, 2)) for p in parts]
        got = teng.stack_host_chunks(sub, axis=axis)
        want = jeng.stack_host_chunks(sub, axis=axis)
        assert type(got) is _Metrics and got.c == ()
        np.testing.assert_array_equal(got.a, np.asarray(want.a))
        np.testing.assert_array_equal(got.b, np.asarray(want.b))


# -- against the JAX package --------------------------------------------------

JAX_CASES = {
    # JAX's interpret-mode fused kernel against the port's "auto" (the
    # kernel contract's plain version on the CPU).
    "kernel": (dict(n=128, steps=12, gating="pallas"), {"gating": "auto"},
               5),
    "banded": (dict(n=256, steps=10, gating="banded",
                    gating_window_blocks=2), {}, 4),
    # float64 obstacle orbit with R = 0: every chunk that relaxes is redone.
    "orbit f64 R=0": (dict(steps=30, dtype=jnp.float64, **ORBIT), {}, 10),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_rollout_chunked_matches_jax(case, request):
    jkw, override, chunk = JAX_CASES[case]
    f64 = jkw.get("dtype") == jnp.float64
    if f64:
        request.getfixturevalue("x64")
    jcfg = jsw.Config(**jkw)
    s0, jstep = jsw.make(jcfg)
    jf, jo, jstart = jeng.rollout_chunked(jstep, s0, jcfg.steps,
                                          chunk=chunk)
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    fields.update(override)
    tcfg = convert.config_from_fields(fields)
    _, tstep = tsw.make(tcfg, device="cpu")
    if case.endswith("R=0"):
        tstep.relax_rounds = 0
    before = teng.COUNTS["redos"]
    tf, to, tstart = teng.rollout_chunked(
        tstep, convert.state_from_numpy(np.asarray(s0.x), np.asarray(s0.v),
                                        device="cpu", dtype=tcfg.dtype),
        tcfg.steps, chunk=chunk)
    assert tstart == jstart == 0
    if case.endswith("R=0"):
        assert teng.COUNTS["redos"] > before
    names = COUNTS + (("gating_overflow_count",) if case == "banded"
                      else ())
    for name in names:
        np.testing.assert_array_equal(getattr(to, name),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=name)
    atol = 1e-10 if f64 else 1e-5
    np.testing.assert_allclose(
        to.min_pairwise_distance, np.asarray(jo.min_pairwise_distance),
        **({"rtol": 0, "atol": atol} if f64 else {"rtol": 1e-6}))
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(tf.v.numpy(), np.asarray(jf.v), rtol=0,
                               atol=atol)


# -- capture safety ----------------------------------------------------------

def _raise(name):
    def fn(*args, **kwargs):
        raise AssertionError(f"{name} inside the capture body")
    return fn


@contextlib.contextmanager
def _no_host_traffic():
    """What a CUDA graph capture refuses or cannot record, patched to
    raise: host data copied to the device (torch.tensor, torch.as_tensor)
    and device values read on the host."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "tensor", _raise("torch.tensor"))
        mp.setattr(torch, "as_tensor", _raise("torch.as_tensor"))
        for name in ("item", "__bool__", "cpu", "__float__", "__int__",
                     "__index__", "tolist", "numpy"):
            mp.setattr(torch.Tensor, name, _raise(f"Tensor.{name}"))
        yield


@pytest.mark.parametrize("path", ["dense", "kernel", "streaming", "banded",
                                  "orbit", "double", "unicycle", "mixed",
                                  "verlet", "verlet dense", "rta poison",
                                  "rta clump", "cert sparse",
                                  "cert warm tol B=1", "cert fused skin",
                                  "cert dense"])
def test_capture_body_makes_no_host_traffic(path):
    """The engine's program for 3 steps: the first body runs as the
    warm-up before a capture does (it fills the kernels' and the
    constants' caches), the next two steps run as one body under the
    patches — and still equal the eager loop, or, for the clump and the
    certificate's one guarded block, raise the redo flag for what the
    body leaves out (the boosted re-solve, the budget's later blocks)."""
    cfg, state0, step = _make(path)
    prog = teng._program(step, state0, 3, unroll=2)
    prog.load(state0)
    prog.start(0)
    prog.body(step, 1)
    with _no_host_traffic():
        prog.body(step, 2)
    flagged = path in ("rta clump", "cert warm tol B=1")
    assert bool(prog.flag) == flagged
    if flagged:
        return
    want_final, want = teng.eager_rollout(step, state0, 3)
    _assert_same(prog.carry, want_final, "carry")
    _assert_same(prog.outs, want, "outs")
