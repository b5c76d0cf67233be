"""The traced-config serving path of the port against the JAX package's,
on the CPU, from the same packed batch.

- The kernels' radius array (cbf_tpu_torch.ops.knn): the plain versions
  at B radii ``torch.equal`` to B single calls, member by member, and the
  stream models with it; dist within rtol 1e-6 of ``jax.vmap`` of the
  interpret-mode ``knn_neighbors`` over (x, radius) — XLA:CPU contracts
  the interpret-mode d^2 into an FMA, the port rounds each operation —
  with idx, count and mask exact; the same through ``knn_select`` under
  ``torch.func.vmap`` with a batched radius; the banded search refusing a
  per-member radius with the JAX package's words.
- ``swarm.make_step_traced(static)(state, t, traced)`` against JAX's on a
  request padded into its bucket (``serve.pack``: pads parked): float64
  to 1e-9, counts exact, per static config; float32 (atol 1e-5) where the
  JAX step cannot run in float64 (the Verlet cache's cond) or takes the
  kernels, whose distances are float32 anyway.
- ``_build_step(active=)`` against JAX's.
- ``lockstep_traced_rollout``/``_chunk`` at B = 3 heterogeneous requests
  (n, steps, radius, dt, gains) in one bucket of 64 against JAX's
  programs on the same packed batch: float64 to 1e-9, float32 to the
  reference test's atol 2e-4 (tests/test_serve.py), counts exact; the
  unicycle and the Verlet select under the member vmap, and RTA's
  boosted re-solve in a member's eager redo, against JAX's; the
  compiled program ``torch.equal`` to ``engine.eager_rollout`` of the
  same step; a second call with other traced values, horizons and clocks
  runs the same program; pads stay parked; a lane that joins at a chunk
  boundary equals the same lane run with every other lane vacant; and
  the capture probe on the traced chunk body.

Inputs come from the JAX package's spawn laws (seeded) and numpy seeds.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.ops import pallas_knn
from cbf_tpu.parallel import ensemble as jens
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.serve import buckets as jbuckets
from cbf_tpu.serve import pack as jpack
from cbf_tpu_torch import convert
from cbf_tpu_torch.ops import knn
from cbf_tpu_torch.parallel import ensemble as tens
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.scenarios import swarm as tsw
from cbf_tpu_torch.serve import pack as tpack

COUNTS = ("filter_active_count", "infeasible_count", "gating_dropped_count",
          "max_relax_rounds")
F64_ATOL, F32_ATOL, LOCK_F32_ATOL, MD_RTOL = 1e-9, 1e-5, 2e-4, 1e-6
RADII = [0.0, 0.4, 0.403, 0.412, 1.0]
BUCKET = 64
STEP_STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _points(n, seed, members=len(RADII)):
    """(B, N, 2) float32 positions: spawn-like spacing (~0.4 m), so the
    radii around 0.4 cut through the neighbour lists."""
    rng = np.random.default_rng(seed)
    half = max(1.0, 0.2 * np.sqrt(n))
    return rng.uniform(-half, half, (members, n, 2)).astype(np.float32)


def _port_config(jcfg):
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    return convert.config_from_fields(fields)


def _jax_traced(traced, dtype):
    return {k: jnp.asarray(v, jnp.int32 if k == "n_active" else dtype)
            for k, v in traced.items()}


# -- the radius array ---------------------------------------------------

@pytest.mark.parametrize("fn", ["fused", "blocked"])
@pytest.mark.parametrize("n", [1, 37, 300])
def test_radius_array_equals_single_calls(n, fn):
    plain = (knn.knn_neighbors_plain if fn == "fused"
             else knn.knn_neighbors_blocked_plain)
    x = torch.as_tensor(_points(n, n))
    radii = torch.tensor(RADII, dtype=torch.float32)
    got = plain(x, radii, 8)
    for b, r in enumerate(RADII):
        want = plain(x[b], r, 8)
        for name, g, w in zip(("idx", "dist", "nearest", "count"), got, want):
            assert torch.equal(g[b], w), (name, b)
    # A 0-dim radius serves every member; equal radii equal the float.
    same = plain(x, torch.tensor(0.403), 8)
    for g, w in zip(same, plain(x, 0.403, 8)):
        assert torch.equal(g, w)


def test_stream_models_take_the_radius_array():
    """The stream models at B radii equal their single-radius calls, and
    compose to the blocked plain version (300 columns, three ranges)."""
    n, cols, splits = 300, 128, 3
    x = torch.as_tensor(_points(n, 7))
    radii = torch.tensor(RADII, dtype=torch.float32)
    parts = knn.stream_partials_plain(x, radii, 8, cols, splits)
    lists = knn._warp_lists_model(x, radii, 8, 128, 256)
    for b, r in enumerate(RADII):
        for g, w in zip(parts, knn.stream_partials_plain(x[b], r, 8, cols,
                                                         splits)):
            assert torch.equal(g[b], w)
        for g, w in zip(lists, knn._warp_lists_model(x[b], r, 8, 128, 256)):
            assert torch.equal(g[b], w)
        merged = knn.stream_merge_plain(*(p[b] for p in parts))
        for g, w in zip(merged, knn.knn_neighbors_blocked_plain(x[b], r, 8)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("n", [37, 300])
def test_radius_array_matches_jax_vmap(n):
    """One member-batched call against jax.vmap of the interpret-mode
    kernel over (x, radius), and the same through knn_select under
    torch.func.vmap with a batched radius."""
    xs = _points(n, 100 + n)
    jidx, jdist, jnear, jcnt = jax.vmap(
        lambda x, r: pallas_knn.knn_neighbors(x, r, 8, interpret=True),
        in_axes=(0, 0))(jnp.asarray(xs), jnp.asarray(RADII, jnp.float32))
    x = torch.as_tensor(xs)
    radii = torch.tensor(RADII, dtype=torch.float32)
    for idx, dist, near, cnt in (
            knn.knn_neighbors_plain(x, radii, 8),
            torch.func.vmap(lambda xm, r: knn.knn_select(xm, r, 8))(x,
                                                                    radii)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        np.testing.assert_array_equal(np.isfinite(dist.numpy()),
                                      np.isfinite(np.asarray(jdist)))
        np.testing.assert_allclose(dist.numpy(), np.asarray(jdist),
                                   rtol=MD_RTOL)
        np.testing.assert_allclose(near.numpy(), np.asarray(jnear),
                                   rtol=MD_RTOL)


def test_select_vmap_over_the_radius_alone():
    """One swarm at B radii (x unbatched, radius batched) is the member
    axis at B copies of the swarm."""
    x = torch.as_tensor(_points(64, 3, members=1)[0])
    radii = torch.tensor(RADII, dtype=torch.float32)
    got = torch.func.vmap(lambda r: knn.knn_select(x, r, 8,
                                                   kernel="streaming"))(radii)
    want = knn.knn_neighbors_blocked_plain(x.expand(len(RADII), -1, -1),
                                           radii, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_banded_refuses_a_per_member_radius():
    x = torch.as_tensor(_points(64, 4))
    radii = torch.tensor(RADII, dtype=torch.float32)
    with pytest.raises(ValueError, match="banded"):
        torch.func.vmap(lambda xm, r: knn.knn_neighbors_banded(
            xm, r, 8, window_blocks=1))(x, radii)
    with pytest.raises(ValueError, match="banded"):
        knn.knn_neighbors_banded(x, radii, 8, window_blocks=1)
    with pytest.raises(ValueError, match="host float"):
        knn.knn_banded(x, torch.tensor(0.4), 8, window_blocks=1)
    with pytest.raises(ValueError, match="banded"):
        tsw.Config(n=32, gating="banded").split_static_traced()


# -- the traced step ----------------------------------------------------

# name -> (JAX Config fields, float64?). Every request is packed (the
# filter engages), has non-default traced values, and is padded from n=40
# into the bucket of 64.
STEP_CASES = {
    "single jnp": (dict(gating="jnp"), True),
    "single pallas": (dict(gating="pallas"), False),
    "streaming": (dict(gating="streaming"), False),
    "double": (dict(gating="jnp", dynamics="double", accel_limit=0.8,
                    sep_gain=0.7), True),
    "unicycle": (dict(gating="jnp", dynamics="unicycle",
                      projection_distance=0.04), True),
    "mixed": (dict(gating="jnp", dynamics="mixed", n_double=10,
                   vel_tracking_tau=0.25), True),
    "obstacles": (dict(gating="jnp", n_obstacles=4, obstacle_omega=2.0,
                       obstacle_orbit_frac=0.5), True),
    "sparse certificate": (dict(gating="jnp", certificate=True,
                                certificate_backend="sparse"), True),
    "rta": (dict(gating="jnp", rta=True), True),
    "verlet": (dict(gating="jnp", gating_rebuild_skin=0.1), False),
}


def _request(fields, dtype, n=40, steps=STEP_STEPS, seed=3):
    return jsw.Config(n=n, steps=steps, seed=seed, safety_distance=0.42,
                      dt=0.03, consensus_gain=1.3,
                      spawn_half_width_override=0.9, dtype=dtype, **fields)


def _assert_state(ts, js, atol):
    for name in ("x", "v", "theta"):
        j = getattr(js, name)
        if isinstance(j, tuple):
            continue
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(j),
                                   atol=atol, rtol=0, err_msg=name)


def _assert_outs(to, jo, atol):
    for name in COUNTS:
        np.testing.assert_array_equal(np.asarray(getattr(to, name)),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=name)
    np.testing.assert_allclose(np.asarray(to.min_pairwise_distance),
                               np.asarray(jo.min_pairwise_distance),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_traced_step_matches_jax(case):
    fields, f64 = STEP_CASES[case]
    jdt = jnp.float64 if f64 else jnp.float32
    with jax.enable_x64(f64):
        jcfg = _request(fields, jdt)
        key, traced = jbuckets.bucket_key(jcfg, sizes=(BUCKET,))
        js = jpack.padded_initial_state(jcfg, key)
        jstep = jax.jit(jsw.make_step_traced(key.static_cfg))
        tcfg = _port_config(key.static_cfg)
        tstep = tsw.make_step_traced(tcfg, device="cpu")
        ts = convert.state_from_reference(js, device="cpu", dtype=tcfg.dtype)
        ttr = convert.traced_from_reference(traced, device="cpu",
                                            dtype=tcfg.dtype)
        jtr = _jax_traced(traced, jdt)
        engaged = 0
        for t in range(STEP_STEPS):
            js, jo = jstep(js, t, jtr)
            ts, to = tstep(ts, t, ttr)
            _assert_outs(to, jo, F64_ATOL if f64 else F32_ATOL)
            _assert_state(ts, js, F64_ATOL if f64 else F32_ATOL)
            engaged += int(to.filter_active_count)
    assert engaged > 0
    # The pads never moved: parked, still.
    np.testing.assert_array_equal(
        ts.x[jcfg.n:].numpy(),
        tpack.parking_rows(BUCKET - jcfg.n, tcfg.dtype))
    assert not ts.v[jcfg.n:].any()


def test_active_mask_step_matches_jax(x64):
    """``_build_step(active=)`` — the mask the traced step builds from
    n_active — against JAX's on a bucket-padded state, float64."""
    jcfg = _request(dict(gating="jnp", n_obstacles=3), jnp.float64)
    key, _ = jbuckets.bucket_key(jcfg, sizes=(BUCKET,))
    js = jpack.padded_initial_state(jcfg, key)
    bcfg = dataclasses.replace(jcfg, n=BUCKET)
    active = np.arange(BUCKET) < jcfg.n
    jstep = jax.jit(jsw._build_step(bcfg, active=jnp.asarray(active)))
    tcfg = _port_config(bcfg)
    tstep = tsw._build_step(tcfg, active=torch.as_tensor(active),
                            device="cpu")
    ts = convert.state_from_reference(js, device="cpu", dtype=tcfg.dtype)
    for t in range(STEP_STEPS):
        js, jo = jstep(js, t)
        ts, to = tstep(ts, t)
        _assert_outs(to, jo, F64_ATOL)
        _assert_state(ts, js, F64_ATOL)


def test_traced_step_equals_make_at_the_request_values():
    """Unpadded (n_active = n), the traced step with a request's own
    values is the make() step of that request, bit for bit."""
    cfg = tsw.Config(n=32, seed=1, gating="jnp", safety_distance=0.45,
                     dt=0.025, consensus_gain=1.4,
                     spawn_half_width_override=0.8)
    static, traced = cfg.split_static_traced()
    tr = {k: torch.tensor(v, dtype=torch.int32 if k == "n_active"
                          else cfg.dtype) for k, v in traced.items()}
    s_a, step_a = tsw.make(cfg, device="cpu")
    step_b = tsw.make_step_traced(static, device="cpu")
    s_b = s_a
    for t in range(3):
        s_a, o_a = step_a(s_a, t)
        s_b, o_b = step_b(s_b, t, tr)
        assert torch.equal(s_a.x, s_b.x) and torch.equal(s_a.v, s_b.v)
        for name in COUNTS:
            assert torch.equal(getattr(o_a, name), getattr(o_b, name))


# -- the lockstep programs ----------------------------------------------

def _mixed_requests(dtype, steps=(30, 22, 17)):
    """tests/test_serve.py's heterogeneous batch: different n, steps,
    radius, dt and gains, one bucket of 64, one horizon (64)."""
    common = dict(gating="jnp", record_trajectory=True,
                  spawn_half_width_override=1.0, dtype=dtype)
    return [jsw.Config(n=50, steps=steps[0], seed=3, safety_distance=0.42,
                       consensus_gain=1.2, **common),
            jsw.Config(n=64, steps=steps[1], seed=4, dt=0.028, **common),
            jsw.Config(n=40, steps=steps[2], seed=5, consensus_gain=0.8,
                       sep_gain=0.5, **common)]


def _jax_batch(cfgs, max_batch=3):
    keyed = [jbuckets.bucket_key(c, sizes=(BUCKET,)) for c in cfgs]
    key = keyed[0][0]
    assert all(k == key for k, _ in keyed)
    return key, jpack.stack_batch(key, cfgs, [t for _, t in keyed],
                                  max_batch=max_batch)


@pytest.fixture(scope="module")
def lockstep_runs():
    """JAX's rollout and chunk programs on the mixed batch, float64 and
    float32, with the port's batch carried across."""
    runs = {}
    for f64 in (True, False):
        jdt = jnp.float64 if f64 else jnp.float32
        with jax.enable_x64(f64):
            key, batch = _jax_batch(_mixed_requests(jdt))
            jf, jo = jens.lockstep_traced_rollout(
                key.static_cfg, key.horizon, donate_states=False)(*batch)
            t0 = jnp.asarray([0, 32, 0], jnp.int32)
            jcf, jco = jens.lockstep_traced_chunk(key.static_cfg, 32)(
                *batch, t0)
            tcfg = _port_config(key.static_cfg)
            runs[f64] = dict(
                key=key, tcfg=tcfg, jax=(jf, jo), jax_chunk=(jcf, jco),
                t0=np.array(t0),
                batch=convert.batch_from_reference(*batch, device="cpu",
                                                   dtype=tcfg.dtype))
    return runs


def _assert_lockstep(tf, to, jf, jo, atol):
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(tf.v.numpy(), np.asarray(jf.v), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(to.trajectory.numpy(),
                               np.asarray(jo.trajectory), atol=atol, rtol=0)
    _assert_outs(to, jo, atol)


@pytest.mark.parametrize("f64", [True, False], ids=["float64", "float32"])
def test_lockstep_rollout_matches_jax(lockstep_runs, f64):
    run = lockstep_runs[f64]
    states, traced, steps = run["batch"]
    tf, to = tens.lockstep_traced_rollout(
        run["tcfg"], run["key"].horizon, donate_states=False)(
            states, traced, steps)
    assert tuple(to.min_pairwise_distance.shape) == (3, run["key"].horizon)
    _assert_lockstep(tf, to, *run["jax"],
                     F64_ATOL if f64 else LOCK_F32_ATOL)
    assert int(to.filter_active_count.min()) > 0


@pytest.mark.parametrize("f64", [True, False], ids=["float64", "float32"])
def test_lockstep_chunk_matches_jax(lockstep_runs, f64):
    run = lockstep_runs[f64]
    states, traced, steps = run["batch"]
    tf, to = tens.lockstep_traced_chunk(run["tcfg"], 32)(
        states, traced, steps, torch.as_tensor(run["t0"]))
    assert tuple(to.min_pairwise_distance.shape) == (3, 32)
    _assert_lockstep(tf, to, *run["jax_chunk"],
                     F64_ATOL if f64 else LOCK_F32_ATOL)


def test_compiled_program_equals_eager_and_is_reused(lockstep_runs):
    """The program (the engine's body, uncaptured on the CPU) equals
    engine.eager_rollout of the same step; a second call with other
    traced values, horizons and clocks runs the same program; donation
    writes the result into the caller's states."""
    run = lockstep_runs[False]
    tcfg = run["tcfg"]
    states, traced, steps = run["batch"]
    program = tens._traced_program(tcfg, None, torch.device("cpu"))
    t0 = torch.as_tensor(run["t0"])
    tf, to = tens.lockstep_traced_chunk(tcfg, 32)(states, traced, steps, t0)
    lanes = tens._lanes(states, traced, steps, t0)
    (ef, _), eo = teng.eager_rollout(program, (states, lanes), 32)
    assert teng._leaves(tf) and all(
        torch.equal(a, b) for a, b in zip(teng._leaves(tf),
                                          teng._leaves(ef)))
    for a, b in zip(teng._leaves(to), teng._leaves(eo)):
        assert torch.equal(a, torch.swapaxes(b, 0, 1))
    programs = dict(program._rollout_programs)
    other = dict(traced, safety_distance=traced["safety_distance"] * 1.05,
                 dt=traced["dt"] * 0.9)
    tens.lockstep_traced_chunk(tcfg, 32)(
        states, other, torch.tensor([40, 3, 0], dtype=torch.int32),
        torch.tensor([32, 0, 5], dtype=torch.int32))
    assert program._rollout_programs == programs
    mine = teng._tree_map(torch.clone, states)
    before = mine.x
    fin, _ = tens.lockstep_traced_rollout(tcfg, run["key"].horizon)(
        mine, traced, steps)
    assert fin.x is before
    ref, _ = tens.lockstep_traced_rollout(
        tcfg, run["key"].horizon, donate_states=False)(states, traced, steps)
    assert torch.equal(fin.x, ref.x)


# name -> (request fields, float64?): step paths under the member vmap
# that the mixed batch above does not take — the unicycle and the Verlet
# select (the obstacle ring per member and clock: the RTA test below).
LOCK_FAMILIES = {
    "unicycle": (dict(gating="jnp", dynamics="unicycle"), True),
    # JAX's traced step cannot take the skin on its kernels (ROADMAP.md,
    # findings on the reference), so the select form on the dense path.
    "verlet": (dict(gating="jnp", gating_rebuild_skin=0.1), False),
}


def _lockstep_pair(fields, f64, horizon, edit=None):
    """JAX's and the port's lockstep_traced_rollout on one packed batch of
    two requests (n 30 and 24, different radius and dt) in bucket 32;
    ``edit(x)`` rewrites the stacked positions first."""
    jdt = jnp.float64 if f64 else jnp.float32
    with jax.enable_x64(f64):
        cfgs = [jsw.Config(n=n, steps=st, seed=seed, safety_distance=sd,
                           dt=dt, spawn_half_width_override=0.9, dtype=jdt,
                           **fields)
                for n, st, seed, sd, dt in ((30, horizon, 1, 0.41, 0.03),
                                            (24, horizon - 6, 2, 0.44,
                                             0.033))]
        keyed = [jbuckets.bucket_key(c, sizes=(32,)) for c in cfgs]
        key = keyed[0][0]
        states, traced, steps = jpack.stack_batch(
            key, cfgs, [t for _, t in keyed], max_batch=2)
        if edit is not None:
            states = states._replace(x=edit(states.x))
        jf, jo = jens.lockstep_traced_rollout(
            key.static_cfg, horizon, donate_states=False)(states, traced,
                                                          steps)
        tcfg = _port_config(key.static_cfg)
        batch = convert.batch_from_reference(states, traced, steps,
                                             device="cpu", dtype=tcfg.dtype)
        tf, to = tens.lockstep_traced_rollout(
            tcfg, horizon, donate_states=False)(*batch)
    return (jf, jo), (tf, to)


@pytest.mark.parametrize("family", list(LOCK_FAMILIES))
def test_lockstep_families_match_jax(family):
    fields, f64 = LOCK_FAMILIES[family]
    (jf, jo), (tf, to) = _lockstep_pair(fields, f64, 20)
    _assert_state(tf, jf, F64_ATOL if f64 else F32_ATOL)
    _assert_outs(to, jo, F64_ATOL if f64 else F32_ATOL)
    assert int(to.filter_active_count.min()) > 0


def test_lockstep_rta_resolve_in_the_member_redo(x64):
    """tests/test_rta.py's rung-1 clump (8 agents 0.01 m apart on the
    obstacle ring's centre) in member 0 of a lockstep batch: the body
    leaves the boosted re-solve to the redo, whose vmapped eager pass
    takes it for every row and selects per row (JAX's cond under vmap) —
    against JAX's program in float64, member 1 untouched."""
    from cbf_tpu_torch.rta.core import RUNG_RESOLVE

    def clump(x):
        line = jnp.stack([-0.035 + 0.01 * jnp.arange(8.0),
                          jnp.zeros(8)], axis=1).astype(x.dtype)
        return x.at[0, :8].set(line)

    teng.COUNTS["redos"] = 0
    (jf, jo), (tf, to) = _lockstep_pair(
        dict(gating="jnp", n_obstacles=4, rta=True, rta_recover_steps=10),
        True, 16, edit=clump)
    assert teng.COUNTS["redos"] >= 1
    assert RUNG_RESOLVE in to.rta_mode[0].tolist()
    np.testing.assert_array_equal(to.rta_mode.numpy(),
                                  np.asarray(jo.rta_mode))
    _assert_state(tf, jf, F64_ATOL)
    _assert_outs(to, jo, F64_ATOL)


def test_pads_stay_parked():
    """tests/test_serve.py::test_pads_stay_parked on the port."""
    cfg = tsw.Config(n=20, steps=30, seed=2, gating="jnp")
    from cbf_tpu_torch.serve import buckets as tbuckets

    key, traced = tbuckets.bucket_key(cfg, sizes=(32,))
    states, traced_b, steps_b = tpack.stack_batch(key, [cfg], [traced],
                                                  max_batch=1, device="cpu")
    final, _ = tens.lockstep_traced_rollout(
        key.static_cfg, key.horizon, donate_states=False)(
            states, traced_b, steps_b)
    np.testing.assert_array_equal(final.x[0, cfg.n:].numpy(),
                                  tpack.parking_rows(key.n - cfg.n,
                                                     cfg.dtype))
    assert not final.v[0, cfg.n:].any()


def test_join_midflight_equals_running_alone():
    """tests/test_serve_continuous.py:70's contract on the chunk program:
    a lane that joins a live table at a chunk boundary is bit-identical
    to the same lane run with every other lane vacant (steps = 0)."""
    from cbf_tpu_torch.serve import buckets as tbuckets

    chunk = 8
    long_cfg = tsw.Config(n=8, steps=32, seed=7, gating="jnp",
                          spawn_half_width_override=0.6)
    short_cfg = tsw.Config(n=8, steps=16, seed=3, gating="jnp",
                           safety_distance=0.45,
                           spawn_half_width_override=0.6)
    key, tr_long = tbuckets.bucket_key(long_cfg, sizes=(16,))
    _, tr_short = tbuckets.bucket_key(short_cfg, sizes=(16,))
    run = tens.lockstep_traced_chunk(key.static_cfg, chunk)

    def traced_of(lanes):
        return {k: torch.tensor([t[k] for t in lanes],
                                dtype=torch.int32 if k == "n_active"
                                else torch.float32) for k in lanes[0]}

    # Alone: the short request in lane 1, lanes 0 and 2 vacant.
    table = tpack.seed_lane_table(key, short_cfg, 3, device="cpu")
    tr3 = traced_of([tr_short] * 3)
    alone = []
    for c in range(2):
        table, outs = run(table, tr3,
                          torch.tensor([0, 16, 0], dtype=torch.int32),
                          torch.tensor([0, c * chunk, 0], dtype=torch.int32))
        alone.append(tpack.slice_lane_chunk(outs, 1, chunk))
    alone_final = table
    # Joined: the long request runs from chunk 0; the short one joins
    # lane 1 after the long one's first chunk.
    table = tpack.seed_lane_table(key, long_cfg, 3, device="cpu")
    tr3 = traced_of([tr_long, tr_short, tr_long])
    joined = []
    for c in range(3):
        if c == 1:
            table = tpack.join_lane(table, 1, tpack.padded_initial_state(
                short_cfg, key, device="cpu"))
        t_short = max(0, (c - 1) * chunk)
        table, outs = run(
            table, tr3,
            torch.tensor([32, 16 if c else 0, 0], dtype=torch.int32),
            torch.tensor([c * chunk, t_short, 0], dtype=torch.int32))
        if c >= 1:
            joined.append(tpack.slice_lane_chunk(outs, 1, chunk))
    for a, b in zip(alone, joined):
        for x, y in zip(_np_leaves(a), _np_leaves(b)):
            np.testing.assert_array_equal(x, y)
    assert torch.equal(alone_final.x[1], table.x[1])


def _np_leaves(tree):
    out = []
    tpack._tree(out.append, tree)
    return out


def _raise(name):
    def fn(*args, **kwargs):
        raise AssertionError(f"{name} inside the capture body")
    return fn


@contextlib.contextmanager
def _no_host_traffic():
    """tests/test_torch_rollout.py's probe: what a CUDA graph capture
    refuses or cannot record, patched to raise — host data copied to the
    device and device values read on the host."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "tensor", _raise("torch.tensor"))
        mp.setattr(torch, "as_tensor", _raise("torch.as_tensor"))
        for name in ("item", "__bool__", "cpu", "__float__", "__int__",
                     "__index__", "tolist", "numpy"):
            mp.setattr(torch.Tensor, name, _raise(f"Tensor.{name}"))
        yield


def test_traced_chunk_body_makes_no_host_traffic(lockstep_runs):
    """The chunk program's body under the capture probe of
    tests/test_torch_rollout.py: no host copy, no host read — and still
    the eager loop's result."""
    run = lockstep_runs[False]
    states, traced, steps = run["batch"]
    program = tens._traced_program(run["tcfg"], None, torch.device("cpu"))
    lanes = tens._lanes(states, traced, steps, torch.as_tensor(run["t0"]))
    carry = (states, lanes)
    prog = teng._program(program, carry, 3, unroll=2)
    prog.load(carry)
    prog.start(0)
    prog.body(program, 1)
    with _no_host_traffic():
        prog.body(program, 2)
    assert not bool(prog.flag)
    (want, _), outs = teng.eager_rollout(program, carry, 3)
    for a, b in zip(teng._leaves(prog.carry[0]), teng._leaves(want)):
        assert torch.equal(a, b)
    for a, b in zip(teng._leaves(prog.outs), teng._leaves(outs)):
        assert torch.equal(a, b)
