"""The serving layer's buckets and packer (cbf_tpu_torch.serve) against
the JAX package's (cbf_tpu.serve.buckets, cbf_tpu.serve.pack), on the CPU.

- tests/test_serve.py:48-100 on the port, each answer also held to the
  JAX function's: bucket equality across traced scalars, splits on the
  static signature, the size ladder and the horizon quantum, the banded
  and arena-override rejections, and the ``pack_spacing`` rescale that
  keeps a padded request's packing radius. The bucket keys and traced
  dicts carry across field for field.
- ``padded_initial_state``/``stack_batch``/``dummy_batch``/
  ``seed_lane_table`` equal to JAX's leaf for leaf (float32 bits, shapes,
  int32 carries), the certificate's Verlet cache and warm carry, the
  Verlet cache, the unicycle headings and the RTA carry included; the
  lane-table join and the result trims (``join_lane``,
  ``slice_lane_chunk``, ``assemble_lane_result``, ``trim_result``) equal
  to JAX's on the same arrays.
- The background tenant (``attach_background``) attaches and detaches
  (None), and a tenant whose ``next_unit`` raises is detached instead of
  crashing the scheduler; ``serve --lease`` without ``--journal`` exits 2
  with the JAX package's message (the lease fences the journal), and
  leaves no lease behind.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.serve import buckets as jbuckets
from cbf_tpu.serve import pack as jpack
from cbf_tpu_torch import convert
from cbf_tpu_torch.__main__ import main as tcli
from cbf_tpu_torch.scenarios import swarm as tsw
from cbf_tpu_torch.serve import bucket_horizon, bucket_key, bucket_n
from cbf_tpu_torch.serve import buckets as tbuckets
from cbf_tpu_torch.serve import pack as tpack


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port(jcfg):
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    return convert.config_from_fields(fields)


def _both_keys(jcfg, **kw):
    """(JAX key, JAX traced, port key, port traced), the port's from the
    same request carried across."""
    jkey, jtr = jbuckets.bucket_key(jcfg, **kw)
    tkey, ttr = tbuckets.bucket_key(_port(jcfg), **kw)
    return jkey, jtr, tkey, ttr


def _assert_key_equal(jkey, jtr, tkey, ttr):
    assert tkey.static_cfg == _port(jkey.static_cfg)
    assert tkey.horizon == jkey.horizon and tkey.n == jkey.n
    assert tkey.label() == jkey.label()
    assert ttr == jtr


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [tree]


def _assert_tree_equal(port, ref):
    """Every leaf equal, shape and kind included; ``()`` where JAX has
    ``()``."""
    lp, lr = _leaves(port), _leaves(ref)
    assert len(lp) == len(lr)
    for a, b in zip(lp, lr):
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                           a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ signatures --

def test_bucket_equality_across_traced_scalars():
    reqs = [jsw.Config(n=100, steps=90, seed=1, safety_distance=0.42,
                       dt=0.03, consensus_gain=1.3, gating="jnp"),
            jsw.Config(n=120, steps=128, seed=9, safety_distance=0.38,
                       dt=0.04, consensus_gain=0.9, gating="jnp")]
    keys = [_both_keys(r) for r in reqs]
    for k in keys:
        _assert_key_equal(*k)
    a, b = keys[0][2], keys[1][2]
    assert a == b                       # same bucket: n<=128, horizon 128
    assert a.n == 128 and a.horizon == 128
    assert "n128" in a.label() and "t128" in a.label()
    assert (tbuckets.chunk_label(a.static_cfg, 32)
            == jbuckets.chunk_label(keys[0][0].static_cfg, 32))


@pytest.mark.parametrize("variant", [
    dict(n=200), dict(steps=200), dict(dynamics="double"),
    dict(k_neighbors=12), dict(speed_limit=0.15)])
def test_bucket_splits_on_static_signature(variant):
    base = jsw.Config(n=100, steps=90, gating="jnp")
    k0 = _both_keys(base)
    kv = _both_keys(dataclasses.replace(base, **variant))
    _assert_key_equal(*kv)
    assert kv[2] != k0[2] and kv[0] != k0[0]


def test_bucket_ladder_and_horizon_quantum():
    assert bucket_n(1) == 16 and bucket_n(16) == 16 and bucket_n(17) == 32
    with pytest.raises(ValueError):
        bucket_n(10_000_000)
    assert bucket_horizon(1) == 64
    assert bucket_horizon(64) == 64
    assert bucket_horizon(65) == 128
    for n in (1, 16, 17, 100, 1000, 5000):
        assert bucket_n(n) == jbuckets.bucket_n(n)
    for steps in (1, 63, 64, 65, 1000):
        assert bucket_horizon(steps) == jbuckets.bucket_horizon(steps)
        assert (bucket_horizon(steps, 32)
                == jbuckets.bucket_horizon(steps, 32))
    assert tbuckets.DEFAULT_BUCKET_SIZES == jbuckets.DEFAULT_BUCKET_SIZES
    assert tbuckets.PARKING_ARENA_HALF == jbuckets.PARKING_ARENA_HALF


def test_traced_split_rejects_banded_and_cert_arena_override():
    with pytest.raises(ValueError, match="banded"):
        tsw.Config(n=32, gating="banded").split_static_traced()
    with pytest.raises(ValueError, match="arena_half_override"):
        bucket_key(tsw.Config(n=32, gating="jnp", certificate=True,
                              certificate_backend="sparse",
                              arena_half_override=50.0))
    # The certificate bucket forces the parking-containing arena.
    jcfg = jsw.Config(n=24, steps=40, gating="jnp", certificate=True,
                      certificate_backend="sparse")
    k = _both_keys(jcfg, sizes=(32,))
    _assert_key_equal(*k)
    assert k[2].static_cfg.arena_half_override == tbuckets.PARKING_ARENA_HALF


def test_pack_radius_preserved_through_bucket_padding():
    cfg = tsw.Config(n=100, steps=64, gating="jnp")
    key, traced = bucket_key(cfg)
    padded = traced["pack_spacing"] * np.sqrt(key.n)
    assert padded == pytest.approx(cfg.pack_radius, rel=1e-6)
    _assert_key_equal(*_both_keys(jsw.Config(n=100, steps=64,
                                             gating="jnp")))


def test_split_static_traced_matches_jax():
    jcfg = jsw.Config(n=48, steps=77, seed=5, dt=0.02, sep_gain=0.3,
                      obstacle_omega=1.5, dynamics="double", gating="jnp")
    jstatic, jtr = jcfg.split_static_traced()
    tstatic, ttr = _port(jcfg).split_static_traced()
    assert tstatic == _port(jstatic) and ttr == jtr
    assert tsw.TRACED_CONFIG_FIELDS == jsw.TRACED_CONFIG_FIELDS


# --------------------------------------------------------------- packing --

# name -> request fields: every structural carry the packer seeds.
PACK_CASES = {
    "single": dict(gating="jnp"),
    "unicycle": dict(gating="jnp", dynamics="unicycle"),
    "verlet": dict(gating="pallas", gating_rebuild_skin=0.1),
    "certificate": dict(gating="jnp", certificate=True,
                        certificate_backend="sparse",
                        certificate_rebuild_skin=0.1,
                        certificate_warm_start=True),
    "rta": dict(gating="jnp", rta=True),
    "obstacles": dict(gating="jnp", n_obstacles=3),
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_stack_batch_matches_jax(case):
    """Two requests of one bucket (different n, seeds and traced values)
    stacked into a batch of 3 — a pad slot cloning the first — equal to
    JAX's batch leaf for leaf; padded_initial_state too."""
    fields = PACK_CASES[case]
    reqs = [jsw.Config(n=20, steps=30, seed=2, safety_distance=0.41,
                       **fields),
            jsw.Config(n=27, steps=50, seed=6, dt=0.03, **fields)]
    keyed = [jbuckets.bucket_key(r, sizes=(32,)) for r in reqs]
    jkey = keyed[0][0]
    jstates, jtr, jsteps = jpack.stack_batch(jkey, reqs,
                                             [t for _, t in keyed], 3)
    treqs = [_port(r) for r in reqs]
    tkeyed = [tbuckets.bucket_key(r, sizes=(32,)) for r in treqs]
    tkey = tkeyed[0][0]
    tstates, ttr, tsteps = tpack.stack_batch(
        tkey, treqs, [t for _, t in tkeyed], 3, device="cpu")
    _assert_tree_equal(tstates, jstates)
    assert set(ttr) == set(jtr)
    for k in jtr:
        _assert_tree_equal(ttr[k], jtr[k])
    _assert_tree_equal(tsteps, jsteps)
    _assert_tree_equal(tpack.padded_initial_state(treqs[1], tkey,
                                                  device="cpu"),
                       jpack.padded_initial_state(reqs[1], jkey))


def test_dummy_batch_and_lane_table_match_jax():
    jcfg = jsw.Config(n=12, steps=10, seed=4, gating="jnp",
                      dynamics="unicycle")
    jkey, _ = jbuckets.bucket_key(jcfg, sizes=(16,))
    tcfg = _port(jcfg)
    tkey, _ = tbuckets.bucket_key(tcfg, sizes=(16,))
    for t_part, j_part in zip(tpack.dummy_batch(tkey, 2, device="cpu"),
                              jpack.dummy_batch(jkey, 2)):
        if isinstance(j_part, dict):
            for k in j_part:
                _assert_tree_equal(t_part[k], j_part[k])
        else:
            _assert_tree_equal(t_part, j_part)
    jtable = jpack.seed_lane_table(jkey, jcfg, 3)
    ttable = tpack.seed_lane_table(tkey, tcfg, 3, device="cpu")
    _assert_tree_equal(ttable, jtable)
    other = dataclasses.replace(jcfg, n=9, seed=8)
    jjoined = jpack.join_lane(jtable, 1, jpack.padded_initial_state(other,
                                                                    jkey))
    tjoined = tpack.join_lane(ttable, 1, tpack.padded_initial_state(
        _port(other), tkey, device="cpu"))
    _assert_tree_equal(tjoined, jjoined)
    _assert_tree_equal(ttable, jtable)     # the join made new tensors


def test_result_trims_match_jax():
    """trim_result, slice_lane_chunk and assemble_lane_result on the same
    (B, T, ...) arrays as JAX's functions."""
    from cbf_tpu.rollout.engine import StepOutputs as JOuts
    from cbf_tpu_torch.rollout.engine import StepOutputs as TOuts

    rng = np.random.default_rng(0)
    B, T, N, n_active = 3, 12, 16, 11
    x = rng.normal(size=(B, N, 2)).astype(np.float32)
    v = rng.normal(size=(B, N, 2)).astype(np.float32)
    traj = rng.normal(size=(B, T, N, 2)).astype(np.float32)
    md = rng.uniform(size=(B, T)).astype(np.float32)
    cnt = rng.integers(0, 9, size=(B, T)).astype(np.int32)
    jouts = JOuts(jnp.asarray(md), jnp.asarray(cnt), jnp.asarray(cnt),
                  jnp.asarray(cnt), jnp.asarray(traj))
    touts = TOuts(torch.as_tensor(md), torch.as_tensor(cnt),
                  torch.as_tensor(cnt), torch.as_tensor(cnt),
                  torch.as_tensor(traj))
    jfinal = jsw.State(x=jnp.asarray(x), v=jnp.asarray(v))
    tfinal = tsw.State(x=torch.as_tensor(x), v=torch.as_tensor(v))
    for got, want in zip(tpack.trim_result(tfinal, touts, 1, n_active, 9),
                         jpack.trim_result(jfinal, jouts, 1, n_active, 9)):
        _assert_tree_equal(got, want)
    tparts = [tpack.slice_lane_chunk(touts, 2, d) for d in (4, 4, 3)]
    jparts = [jpack.slice_lane_chunk(jouts, 2, d) for d in (4, 4, 3)]
    for a, b in zip(tparts, jparts):
        _assert_tree_equal(a, b)
    for got, want in zip(
            tpack.assemble_lane_result(tfinal, tparts, 2, n_active),
            jpack.assemble_lane_result(jfinal, jparts, 2, n_active)):
        _assert_tree_equal(got, want)


def test_parking_rows_match_jax():
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.float64, np.float64)):
        got = tpack.parking_rows(5, dtype)
        want = jpack.parking_rows(5, jdtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_serve_out_of_slice_parts_raise(tmp_path, capsys):
    from cbf_tpu.__main__ import main as jcli
    import time

    from cbf_tpu_torch.serve import ServeEngine

    class Broken:
        pulls = 0

        def next_unit(self):
            Broken.pulls += 1
            raise RuntimeError("tenant fault")

        def on_preempt(self, queue_depth):
            pass

    for continuous in (False, True):
        engine = ServeEngine(continuous=continuous, device="cpu")
        tenant = object()
        engine.attach_background(tenant)
        assert engine._bg_tenant is tenant
        engine.attach_background(None)
        assert engine._bg_tenant is None
        engine.start()
        try:
            engine.attach_background(Broken())
            deadline = time.monotonic() + 10
            while engine._bg_tenant is not None \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            assert engine._bg_tenant is None
            assert engine._thread.is_alive()
        finally:
            engine.stop()
    assert Broken.pulls == 2
    requests = tmp_path / "requests.json"
    requests.write_text('[{"steps": 8, "overrides": {"n": 10}}]')
    lease = str(tmp_path / "lease")
    capsys.readouterr()
    assert jcli(["serve", str(requests), "--lease", lease]) == 2
    want = capsys.readouterr()
    assert tcli(["serve", str(requests), "--device", "cpu",
                 "--lease", lease]) == 2
    got = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    assert "--lease requires --journal" in got.err
    assert not os.path.exists(lease)
