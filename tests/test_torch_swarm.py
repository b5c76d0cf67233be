"""The swarm main path of the port (cbf_tpu_torch.scenarios.swarm) against
the JAX package's, step by step, from the identical initial swarm carried
across with cbf_tpu_torch.convert (the two packages' spawn jitter streams
differ by design).

Tolerances: float32 — per-step min distance rtol 1e-6, final x and v
atol 1e-5 (the packages reduce the centroid mean in their own orders, and
XLA:CPU contracts the interpret-mode kernel's d^2 into an FMA, so
trajectories part by ulps); float64 — atol 1e-10; every count exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.rollout import engine as jeng
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu_torch import convert
from cbf_tpu_torch.errors import OutOfSliceError
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


@pytest.mark.parametrize("override,make_kw,slice_name", [
    # The Queue A5 and A6 knobs build now (test_queue_a5_knobs_build_and_
    # match_jax, tests/test_torch_certificate.py); paired with a later
    # slice's knob, that one still raises.
    ({"dynamics": "double", "rta": True}, {"unroll_relax": 2}, "Queue A8"),
    ({"dynamics": "unicycle", "certificate": True}, {"unroll_relax": 2},
     "Queue A8"),
    ({"dynamics": "mixed", "n_double": 4}, {"unroll_relax": 1}, "Queue A8"),
    ({"certificate": True}, {"unroll_relax": 1}, "Queue A8"),
    ({"rta": True, "certificate": True}, {"active": True}, "Queue A11"),
    ({"gating_rebuild_skin": 0.1}, {"unroll_relax": 2}, "Queue A8"),
    ({}, {"unroll_relax": 2}, "Queue A8"),
])
def test_out_of_slice_knobs_raise(override, make_kw, slice_name):
    cfg = tsw.Config(n=16, **override)
    with pytest.raises(OutOfSliceError, match=slice_name):
        if make_kw.get("active"):
            # The serving layer's mask reaches the step factory only.
            tsw._build_step(cfg, active=torch.ones(16, dtype=torch.bool),
                            device="cpu")
        else:
            tsw.make(cfg, device="cpu", **make_kw)


def _autograd_through_the_k_solve():
    """The sparse certificate's solver with row directions that need a
    gradient: its K solve's implicit gradient is the Queue A8 slice's."""
    from cbf_tpu_torch.solvers import sparse_admm
    N, k = 8, 2
    coef = torch.ones((N * k, 2), requires_grad=True)
    I = torch.arange(N).repeat_interleave(k)
    J = (I + 1) % N
    sparse_admm.solve_pair_box_qp_admm(
        torch.zeros((N, 2)), I, J, coef, torch.ones(N * k),
        torch.full((N, 2), -1.0), torch.full((N, 2), 1.0), agent_k=k)


@pytest.mark.parametrize("call,slice_name", [
    ("apply_certificate_sharded", "Queue A10"),
    ("axis_name", "Queue A10"),
    ("si_barrier_certificate_sparse_sharded", "Queue A10"),
    ("autograd through the K solve", "Queue A8"),
])
def test_certificate_out_of_slice_paths_raise(call, slice_name):
    from cbf_tpu_torch.sim import certificates
    from cbf_tpu_torch.solvers import sparse_admm
    cfg = tsw.Config(n=16, certificate=True, certificate_backend="sparse")
    u = torch.zeros((16, 2))
    calls = {
        "apply_certificate_sharded":
            lambda: tsw.apply_certificate_sharded(cfg, u, u, "sp"),
        "axis_name": lambda: sparse_admm.solve_pair_box_qp_admm(
            u, torch.zeros(4, dtype=torch.int64),
            torch.ones(4, dtype=torch.int64), torch.ones((4, 2)),
            torch.ones(4), u - 1.0, u + 1.0, axis_name="sp"),
        "si_barrier_certificate_sparse_sharded":
            lambda: certificates.si_barrier_certificate_sparse_sharded(
                u.T, u.T, "sp"),
        "autograd through the K solve": _autograd_through_the_k_solve,
    }
    with pytest.raises(OutOfSliceError, match=slice_name):
        calls[call]()


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
    with pytest.raises(OutOfSliceError, match="Queue A11"):
        tsw._build_step(tsw.Config(n=16), active=torch.ones(16, dtype=bool),
                        device="cpu")


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
def test_rollout_chunked_rejects_later_slices(kw):
    cfg = tsw.Config(n=16, steps=2)
    state0, step = tsw.make(cfg, device="cpu")
    with pytest.raises(OutOfSliceError, match="Queue A9"):
        teng.rollout_chunked(step, state0, cfg.steps, **kw)


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
