"""The swarm main path of the port (cbf_tpu_torch.scenarios.swarm) against
the JAX package's, step by step, from the identical initial swarm carried
across with cbf_tpu_torch.convert (the two packages' spawn jitter streams
differ by design).

Tolerances: float32 — per-step min distance rtol 1e-6, final x and v
atol 1e-5 (the packages reduce the centroid mean in their own orders, and
XLA:CPU contracts the interpret-mode kernel's d^2 into an FMA, so
trajectories part by ulps); float64 — atol 1e-10; every count exact.
test_certificate_out_of_slice_paths_raise (rewritten from the raises it
pinned when the row-partitioned certificate was ported) holds the three
row-partitioned calls on a one-rank axis equal to the replicated ones.
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

COUNTS = ("filter_active_count", "infeasible_count", "gating_dropped_count",
          "max_relax_rounds")


def _port_config(jcfg, **override):
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    fields.update(override)
    return convert.config_from_fields(fields)


def _run_both(jcfg, **port_override):
    """JAX rollout of ``jcfg`` and the port's rollout on the CPU from the
    same initial state. Returns (jax_final, jax_outs, port_final,
    port_outs)."""
    s0, jstep = jsw.make(jcfg)
    jf, jo = jeng.rollout(jstep, s0, jcfg.steps)
    tcfg = _port_config(jcfg, **port_override)
    _, tstep = tsw.make(tcfg, device="cpu")
    ts0 = convert.state_from_reference(s0, device="cpu", dtype=tcfg.dtype)
    tf, to = teng.rollout(tstep, ts0, tcfg.steps)
    return jf, jo, tf, to


def _assert_counts(jo, to):
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=name)


def test_kernel_path_matches_jax_pallas_per_step():
    """JAX gating="pallas" (interpret mode) against the port's "auto",
    which on a CPU tensor runs the kernel contract's plain version."""
    jf, jo, tf, to = _run_both(jsw.Config(n=256, steps=20, gating="pallas"),
                               gating="auto")
    np.testing.assert_allclose(to.min_pairwise_distance.numpy(),
                               np.asarray(jo.min_pairwise_distance),
                               rtol=1e-6)
    _assert_counts(jo, to)
    assert int(to.filter_active_count.min()) > 0      # the filter engaged
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), atol=1e-5)
    np.testing.assert_allclose(tf.v.numpy(), np.asarray(jf.v), atol=1e-5)


@pytest.mark.parametrize("n,half", [(16, None), (256, None), (16, 0.25)])
def test_dense_path_f64_matches_jax(x64, n, half):
    """gating="jnp" in float64; the packed N=16 case (spawn box 0.25 m)
    engages the filter with relax rounds from the first step."""
    jcfg = jsw.Config(n=n, steps=20, gating="jnp", dtype=jnp.float64,
                      spawn_half_width_override=half)
    jf, jo, tf, to = _run_both(jcfg)
    np.testing.assert_allclose(to.min_pairwise_distance.numpy(),
                               np.asarray(jo.min_pairwise_distance),
                               rtol=0, atol=1e-10)
    _assert_counts(jo, to)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tf.v.numpy(), np.asarray(jf.v), rtol=0,
                               atol=1e-10)
    if half is not None:
        assert float(to.max_relax_rounds.max()) >= 1.0


@pytest.mark.parametrize("override", [
    {"barrier": "discrete", "spawn_half_width_override": 0.5},
    {"goal": "coverage", "spawn": "ring"},
    {"goal": "formation", "spawn": "clusters"},
])
def test_config_variants_f64_match_jax(x64, override):
    jcfg = jsw.Config(n=32, steps=12, gating="jnp", dtype=jnp.float64,
                      **override)
    jf, jo, tf, to = _run_both(jcfg)
    _assert_counts(jo, to)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), rtol=0,
                               atol=1e-10)


def test_streaming_and_auto_agree_on_cpu():
    cfg = tsw.Config(n=256, steps=8)
    state0, step_a = tsw.make(cfg, device="cpu")
    _, step_s = tsw.make(dataclasses.replace(cfg, gating="streaming"),
                         device="cpu")
    fa, oa = teng.rollout(step_a, state0, cfg.steps)
    fs, os_ = teng.rollout(step_s, state0, cfg.steps)
    assert torch.equal(fa.x, fs.x)
    for a, b in zip(oa, os_):
        if isinstance(a, tuple):
            assert b == ()
        else:
            assert torch.equal(a, b)


def test_entry_shaped_step_matches_jax():
    """One step of the flagship model as __graft_entry__.entry() shapes it
    (N=256). JAX's "auto" takes its jnp path on the CPU, the port's takes
    the kernel contract's plain version."""
    import jax

    import __graft_entry__

    fn, (x, v) = __graft_entry__.entry()
    jx, jv, jmd = jax.jit(fn)(x, v)
    cfg = tsw.Config(n=256)
    _, step = tsw.make(cfg, device="cpu")
    state, out = step(convert.state_from_numpy(
        np.asarray(x), np.asarray(v), device="cpu", dtype=torch.float32), 0)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(state.v.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(float(out.min_pairwise_distance), float(jmd),
                               rtol=1e-6)


def test_make_without_card_needs_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tsw.make(tsw.Config(n=16)),
                 lambda: tsw.run(tsw.Config(n=16, steps=1)),
                 lambda: tsw.make(tsw.Config(n=16), device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    state, step = tsw.make(tsw.Config(n=16), device="cpu")
    assert state.x.device.type == "cpu"


def _masked_steps_match_jax(jcfg, n_active, steps=3):
    """``_build_step(active=)`` of the port against JAX's, the first
    ``n_active`` agents real, from the same state (float32: final x and
    v atol 1e-5, min distance rtol 1e-6, counts exact)."""
    import jax

    state, _ = jsw.make(jcfg)
    active = np.arange(jcfg.n) < n_active
    jstep = jax.jit(jsw._build_step(jcfg, active=jnp.asarray(active)))
    tstep = tsw._build_step(_port_config(jcfg),
                            active=torch.as_tensor(active), device="cpu")
    ts = convert.state_from_reference(state, device="cpu",
                                      dtype=torch.float32)
    jouts, touts = [], []
    for t in range(steps):
        state, jo = jstep(state, t)
        ts, to = tstep(ts, t)
        jouts.append(jo)
        touts.append(to)
    _assert_counts(jax.tree.map(lambda *a: jnp.stack(a), *jouts),
                   teng._stack_steps(touts))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(state.x), atol=1e-5)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(state.v), atol=1e-5)
    return ts


@pytest.mark.parametrize("override,n_active", [
    # The Queue A5, A6 and A8 knobs build now (test_queue_a5_knobs_build_
    # and_match_jax, tests/test_torch_certificate.py,
    # test_unroll_relax_knobs_step_and_match_jax); the serving layer's
    # active mask (Queue A11's compute path, ported with the traced step)
    # builds on them too.
    ({"rta": True, "certificate": True}, 12),
])
def test_out_of_slice_knobs_raise(override, n_active):
    """The knob pairs that raised until their slice came — here the
    ``active`` mask with RTA and the certificate — build and hold JAX's
    step."""
    _masked_steps_match_jax(
        jsw.Config(n=16, gating="jnp", spawn_half_width_override=0.5,
                   **override), n_active)


@pytest.mark.parametrize("override,unroll", [
    # The knob pairs that raised until the differentiable slice: each now
    # builds, steps and differentiates through ``unroll`` relax rounds
    # like the JAX package's step (the Verlet cache steps too — the JAX
    # trainer and gradient engine reject it, tests/test_torch_learn.py).
    ({"dynamics": "double", "rta": True}, 2),
    ({"dynamics": "unicycle", "certificate": True}, 2),
    ({"dynamics": "mixed", "n_double": 4}, 1),
    ({"certificate": True}, 1),
    ({"gating_rebuild_skin": 0.1}, 2),
    ({}, 2),
])
def test_unroll_relax_knobs_step_and_match_jax(override, unroll):
    import jax

    override = {"certificate_backend": "sparse", "certificate_k": 4,
                **override} if override.get("certificate") else override
    jcfg = jsw.Config(n=16, gating="jnp", **override)
    js0, jstep = jsw.make(jcfg, unroll_relax=unroll)
    tcfg = tsw.Config(**{**_fields(jcfg), "dtype": torch.float32})
    _, tstep = tsw.make(tcfg, unroll_relax=unroll, device="cpu")
    ts0 = convert.state_from_reference(js0, device="cpu",
                                       dtype=torch.float32)
    want, jout = jstep(js0, 0)
    x = ts0.x.clone().requires_grad_()
    got, tout = tstep(ts0._replace(x=x), 0)
    np.testing.assert_allclose(got.x.detach().numpy(), np.asarray(want.x),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tout.min_pairwise_distance.detach()),
                               float(jout.min_pairwise_distance), atol=1e-5)
    gx, = torch.autograd.grad(torch.sum(got.x ** 2), x)
    jg = jax.grad(lambda x0: jax.numpy.sum(
        jstep(js0._replace(x=x0), 0)[0].x ** 2))(js0.x)
    assert bool(torch.isfinite(gx).all())
    np.testing.assert_allclose(gx.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-4)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _autograd_through_the_k_solve():
    """The sparse certificate's solver with row directions that need a
    gradient: its K solve carries the implicit gradient, so the solution
    differentiates with a finite gradient (held against JAX and finite
    differences in tests/test_torch_diff.py)."""
    from cbf_tpu_torch.solvers import sparse_admm
    N, k = 8, 2
    coef = torch.ones((N * k, 2), dtype=torch.float64, requires_grad=True)
    I = torch.arange(N).repeat_interleave(k)
    J = (I + 1) % N
    u, _ = sparse_admm.solve_pair_box_qp_admm(
        torch.linspace(-1, 1, 2 * N, dtype=torch.float64).reshape(N, 2), I,
        J, coef, torch.full((N * k,), 0.1, dtype=torch.float64),
        torch.full((N, 2), -1.0, dtype=torch.float64),
        torch.full((N, 2), 1.0, dtype=torch.float64), agent_k=k)
    g, = torch.autograd.grad(torch.sum(u ** 2), coef)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


@pytest.mark.parametrize("call,slice_name", [
    ("apply_certificate_sharded", "Queue A10"),
    ("axis_name", "Queue A10"),
    ("si_barrier_certificate_sparse_sharded", "Queue A10"),
])
def test_certificate_out_of_slice_paths_raise(call, slice_name):
    """The row-partitioned certificate (``slice_name`` names the queue
    item that ported it; these raised until then) runs on a one-rank
    ``sp`` axis and equals the replicated solve there exactly: the same
    rows, the same operator, an identity psum. (Across ranks:
    tests/test_torch_parallel.py.)"""
    from cbf_tpu_torch.parallel.mesh import make_mesh
    from cbf_tpu_torch.sim import certificates
    from cbf_tpu_torch.solvers import sparse_admm
    cfg = tsw.Config(n=16, certificate=True, certificate_backend="sparse",
                     dtype=torch.float64)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.uniform(-0.3, 0.3, (16, 2)))
    u = torch.as_tensor(rng.normal(0, 0.3, (16, 2)))
    sp = make_mesh(devices="cpu").axis("sp")
    I = torch.arange(4, dtype=torch.int64)
    J = torch.tensor([1, 2, 3, 0], dtype=torch.int64)
    qp = (u, I, J, torch.ones((4, 2), dtype=torch.float64),
          torch.full((4,), 0.1, dtype=torch.float64), u - 1.0, u + 1.0)
    calls = {
        "apply_certificate_sharded": (
            lambda: tsw.apply_certificate_sharded(cfg, u, x, sp),
            lambda: tsw.apply_certificate(cfg, u, x)),
        "axis_name": (
            lambda: sparse_admm.solve_pair_box_qp_admm(*qp, axis_name=sp),
            lambda: sparse_admm.solve_pair_box_qp_admm(*qp)),
        "si_barrier_certificate_sparse_sharded": (
            lambda: certificates.si_barrier_certificate_sparse_sharded(
                u.T, x.T, sp, k=8, with_info=True),
            lambda: certificates.si_barrier_certificate_sparse(
                u.T, x.T, k=8, with_info=True, neighbor_backend="jnp")),
    }
    got, want = (f() for f in calls[call])
    for a, b in zip(teng._leaves(got), teng._leaves(want)):
        assert torch.equal(a, b.to(a.dtype)), call


def test_certificate_k_solve_differentiates():
    """Autograd through the K solve, which raised until the
    differentiable slice, gives a finite nonzero gradient."""
    _autograd_through_the_k_solve()


@pytest.mark.parametrize("override", [
    {"dynamics": "double"}, {"dynamics": "unicycle"},
    {"dynamics": "mixed", "n_double": 4}, {"rta": True},
    {"gating_rebuild_skin": 0.1},
])
def test_queue_a5_knobs_build_and_match_jax(override):
    """Each knob that raised OutOfSliceError("Queue A5") before it was
    ported builds and holds the JAX package's step (float32, packed so the
    filter engages)."""
    jf, jo, tf, to = _run_both(jsw.Config(
        n=16, steps=8, gating="jnp", spawn_half_width_override=0.5,
        **override))
    _assert_counts(jo, to)
    assert int(to.filter_active_count.min()) > 0
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), atol=1e-5)


def test_serving_active_mask_is_out_of_slice():
    """The serving layer's active mask, once out of this slice, builds:
    the centroid over the active rows, pads with a zero nominal — held
    to JAX's ``_build_step(active=)``; an all-True mask is the unmasked
    step."""
    ts = _masked_steps_match_jax(
        jsw.Config(n=16, gating="jnp", spawn_half_width_override=0.5), 10)
    assert ts.x.shape == (16, 2)
    cfg = tsw.Config(n=16, spawn_half_width_override=0.5)
    s0, plain = tsw.make(cfg, device="cpu")
    masked = tsw._build_step(cfg, active=torch.ones(16, dtype=torch.bool),
                             device="cpu")
    a, _ = plain(s0, 0)
    b, _ = masked(s0, 0)
    np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), atol=1e-6)


@pytest.mark.parametrize("override", [
    {"gating": "bogus"}, {"dynamics": "bogus"}, {"spawn": "bogus"},
    {"goal": "bogus"}, {"barrier": "bogus"}, {"gating_rebuild_skin": -1.0},
    {"n_double": 3}, {"obstacle_layout": "static"},
])
def test_invalid_configs_raise_like_jax(override):
    with pytest.raises(ValueError):
        jsw.make(jsw.Config(n=16, **override))
    with pytest.raises(ValueError):
        tsw.make(tsw.Config(n=16, **override), device="cpu")


def test_config_carries_across_one_to_one():
    jf = {f.name: f.default for f in dataclasses.fields(jsw.Config)}
    tf = {f.name: f.default for f in dataclasses.fields(tsw.Config)}
    assert list(jf) == list(tf)
    for name in jf:
        if name != "dtype":
            assert jf[name] == tf[name], name
    cfg = _port_config(jsw.Config(n=48, gating="streaming",
                                  dtype=jnp.float32))
    assert cfg.n == 48 and cfg.gating == "streaming"
    assert cfg.dtype == torch.float32
    assert cfg.spawn_half_width == jsw.Config(n=48).spawn_half_width
    assert cfg.pack_radius == jsw.Config(n=48).pack_radius
    with pytest.raises(TypeError, match="unknown"):
        convert.config_from_fields({"n": 4, "no_such_field": 1})
    with pytest.raises(ValueError, match="dtype"):
        convert.config_from_fields({"dtype": "no_such_dtype"})


def test_cbf_params_carry_across():
    from cbf_tpu.core.filter import CBFParams as JParams

    p = convert.cbf_params_from_numpy(jsw.default_cbf(jsw.Config()))
    assert p == tsw.default_cbf(tsw.Config())
    assert convert.cbf_params_from_numpy(JParams()) == \
        convert.cbf_params_from_numpy(
            {"max_speed": 15.0, "dmin": 0.2, "k": 1.0, "gamma": 0.5})


@pytest.mark.parametrize("spawn", ["grid", "ring", "clusters", "corridor"])
@pytest.mark.parametrize("goal", ["rendezvous", "coverage", "formation",
                                  "corridor"])
def test_layouts_match_jax(spawn, goal):
    jcfg = jsw.Config(n=37, spawn=spawn, goal=goal)
    tcfg = tsw.Config(n=37, spawn=spawn, goal=goal)
    (jg, js), (tg, ts) = jsw.spawn_layout(jcfg), tsw.spawn_layout(tcfg)
    np.testing.assert_array_equal(tg, jg)
    assert ts == js
    jgoal, tgoal = jsw.goal_layout(jcfg), tsw.goal_layout(tcfg)
    assert (jgoal is None) == (tgoal is None)
    if jgoal is not None:
        np.testing.assert_array_equal(tgoal, jgoal)


def test_spawn_is_seeded_and_collision_free():
    cfg = tsw.Config(n=400)
    a = tsw.spawn_positions(cfg, 3, device="cpu")
    assert torch.equal(a, tsw.spawn_positions(cfg, 3, device="cpu"))
    assert not torch.equal(a, tsw.spawn_positions(cfg, 4, device="cpu"))
    grid, spacing = tsw.spawn_layout(cfg)
    jitter = a.double().numpy() - grid
    assert np.abs(jitter).max() <= 0.25 * spacing + 1e-6
    md = float(teng.min_pairwise_distance(a.T))
    assert md >= 0.5 * spacing - 1e-5


def test_rollout_chunked_matches_rollout():
    cfg = tsw.Config(n=64, steps=7, record_trajectory=True)
    state0, step = tsw.make(cfg, device="cpu")
    f1, o1 = teng.rollout(step, state0, cfg.steps)
    f2, o2, start = teng.rollout_chunked(step, state0, cfg.steps, chunk=3)
    assert start == 0 and torch.equal(f1.x, f2.x)
    assert o2.trajectory.shape == (7, 64, 2)
    for name, a, b in zip(teng.StepOutputs._fields, o1, o2):
        if isinstance(a, tuple):
            assert b == (), name
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("kw", [{"checkpoint_dir": "ckpt"},
                                {"telemetry": object()},
                                {"cost_model": object()},
                                {"durable_hook": print}])
def test_rollout_chunked_rejects_later_slices(kw, tmp_path):
    """The knobs of ``rollout_chunked`` that raised until the durability
    slice now run: each run equals the run without its knob and leaves
    its artefact (a restorable checkpoint, heartbeats, a measured
    capture per chunk size, the hook's boundaries)."""
    from cbf_tpu_torch import obs
    from cbf_tpu_torch.utils import checkpoint as ckpt

    (name,) = kw
    cfg = tsw.Config(n=16, steps=6)
    state0, step = tsw.make(cfg, device="cpu")
    want_final, want, _ = teng.rollout_chunked(step, state0, cfg.steps,
                                               chunk=4)
    seen = []
    live = {"checkpoint_dir": str(tmp_path / "ckpt"),
            "telemetry": obs.TelemetrySink(str(tmp_path / "run")),
            "cost_model": obs.CostModel(),
            "durable_hook": lambda t1, state, outs: seen.append(
                (t1, outs.min_pairwise_distance.shape[0]))}[name]
    extra = {"telemetry_every": 2} if name == "telemetry" else {}
    final, outs, start = teng.rollout_chunked(
        step, state0, cfg.steps, chunk=4, **{name: live}, **extra)
    assert start == 0 and torch.equal(final.x, want_final.x)
    for field, a, b in zip(teng.StepOutputs._fields, outs, want):
        if not isinstance(b, tuple):
            np.testing.assert_array_equal(a, b, err_msg=field)
    if name == "checkpoint_dir":
        assert ckpt.latest_step(live) == 6
        restored, at = ckpt.restore(live, state0)
        assert at == 6 and torch.equal(restored.x, final.x)
    elif name == "telemetry":
        assert [e["step"] for e in obs.read_events(live.run_dir)] == [0, 2, 4]
    elif name == "cost_model":
        entry = live.entries["rollout-c4-u1"]
        assert entry["compiles"] == 2 and entry["executes"] == 2
    else:
        assert seen == [(4, 4), (6, 2)]


def test_engine_helpers_match_jax():
    for args in [(0, 10, 3), (4, 10, 3), (0, 9, 3), (0, 0, 5)]:
        assert teng.plan_chunks(*args) == jeng.plan_chunks(*args)
    with pytest.raises(ValueError):
        teng.plan_chunks(0, 4, 0)
    pts = np.random.default_rng(2).uniform(-1, 1, (2, 50))
    np.testing.assert_allclose(
        float(teng.min_pairwise_distance(torch.as_tensor(pts))),
        float(jeng.min_pairwise_distance(jnp.asarray(pts, jnp.float32))),
        rtol=1e-6)
