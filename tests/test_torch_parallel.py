"""The port's execution across ranks (cbf_tpu_torch/parallel/) held to the
JAX package's ``shard_map`` on the 8 virtual CPU devices, from the same
seeds and inputs.

The JAX side runs in this process; the port's side runs in worlds of 2
and 4 ranks (:func:`cbf_tpu_torch.parallel.launch.run_world`: fresh
processes that never import jax, gloo over a file store, one torch thread
each). One module-scoped job per world size computes every case and
returns numpy arrays.

Cases and tolerances:

- ``ring_knn`` and ``all_gather_knn`` at sp = 4, N = 64, K = 6 (float64)
  against JAX's: the mask and the dropped count exact, the sorted
  neighbour distances to 1e-12; ``exchange_knn`` on its all-gather and
  (threshold 0) ring branches; ``k`` above the global agent count.
- ``sharded_swarm_rollout`` at (1, 2), (2, 2) and (1, 4) against JAX's at
  the same mesh: final states to 1e-10 in float64 and to JAX's own 2e-5
  in float32 (tests/test_parallel.py), the nearest distance to the same
  bounds, the engaged, infeasible and dropped counts equal; the port's
  (2, 2) run against its own (1, 1) run to the same bounds.
- The row-partitioned certificate at sp = 2 (``apply_certificate_sharded``
  and the rollout with the certificate at (1, 2)) against JAX's: the
  certified commands, residuals and states to 1e-10 in float64, the
  dropped count equal.
- The trainer at (2, 2): loss and gradients against JAX's
  ``make_loss_and_grad_fn`` to 1e-10 in float64 (both are (dp * sp)
  times the one-device gradient, ``cbf_tpu_torch/learn/tuning.py``).
- The falsifier at dp = 2: the batch's margins to 1e-12 and the random
  search's verdict (found, property, rounds, evaluated exact; margin and
  delta to 1e-12) equal to JAX's at dp = 2; only rank 0 writes its state
  file and emits events.

:mod:`cbf_tpu_torch.parallel.multihost` is held in
tests/test_torch_multihost.py, the spatial partition in
tests/test_torch_spatial.py.
"""

import os

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
MODULE = os.path.splitext(os.path.basename(__file__))[0]
STRICT, F32_ATOL, KNN_ATOL, FALSIFY_ATOL = 1e-10, 2e-5, 1e-12, 1e-12
ROLL = dict(n=16, steps=40)
SEEDS = [0, 1]
CERT = dict(n=32, steps=3, certificate=True, certificate_backend="sparse")
TRAIN = dict(n=16, steps=2, pack_spacing=0.01)
FALSIFY = dict(n=16, steps=60, k_neighbors=4, gating="jnp")
WEAK = dict(max_speed=15.0, dmin=0.16, k=0.0, gamma=0.5)
SEARCH = dict(budget=8, batch=4, seed=3)


def _search_states(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                           rng.normal(0, 0.1, (n, 2))], axis=1)


def _tiny_states():
    return np.asarray([[0.0, 0.0, 0, 0], [0.1, 0.0, 0, 0],
                       [0.0, 0.1, 0, 0], [5.0, 5.0, 0, 0]], np.float64)


def _grid_x0():
    lin = np.linspace(-0.375, 0.375, 4)
    gx, gy = np.meshgrid(lin, lin)
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
    return np.stack([grid, grid * 1.01])                     # (2, 16, 2)


def _cert_inputs():
    rng = np.random.default_rng(11)
    x = rng.uniform(-0.6, 0.6, (CERT["n"], 2))
    u = rng.normal(0, 0.2, (CERT["n"], 2))
    return u, x


# ------------------------------------------------------------ rank side --

def _np(tree):
    if isinstance(tree, (tuple, list)):
        return [_np(t) for t in tree]
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def _roll(mesh, dtype):
    from cbf_tpu_torch.parallel import sharded_swarm_rollout
    from cbf_tpu_torch.scenarios import swarm

    cfg = swarm.Config(**ROLL, dtype=dtype)
    (x, v), m = sharded_swarm_rollout(cfg, mesh, seeds=SEEDS)
    return _np([x, v]) + [_np(list(m))]


def _world4():
    """Every 4-rank case on one rank (this rank's results)."""
    from cbf_tpu_torch import convert
    from cbf_tpu_torch.learn import tuning
    from cbf_tpu_torch.parallel import alltoall, make_mesh, ring_knn
    from cbf_tpu_torch.scenarios import swarm

    out = {}
    mesh = make_mesh(1, 4, devices="cpu")
    ax = mesh.axis("sp")
    s = torch.as_tensor(_search_states(64, 5))
    loc = s[ax.index * 16:(ax.index + 1) * 16]
    out["ring"] = _np(ring_knn(loc, 6, 0.6, ax, True, True))
    out["gather"] = _np(alltoall.all_gather_knn(loc, 6, 0.6, "sp", True,
                                                True))
    out["exchange"] = _np(alltoall.exchange_knn(loc, 6, 0.6, ax, True,
                                                with_dropped=True))
    limit = alltoall.ALL_GATHER_MAX_SLAB_BYTES
    alltoall.ALL_GATHER_MAX_SLAB_BYTES = 0
    try:
        out["exchange_ring"] = _np(alltoall.exchange_knn(
            loc, 6, 0.6, ax, True, with_dropped=True))
    finally:
        alltoall.ALL_GATHER_MAX_SLAB_BYTES = limit
    tiny = torch.as_tensor(_tiny_states())[ax.index:ax.index + 1]
    out["k_over"] = _np(alltoall.all_gather_knn(tiny, 8, 0.5, ax, True))
    out["k_over_ring"] = _np(ring_knn(tiny, 8, 0.5, ax, True))
    for shape in ((1, 4), (2, 2)):
        m = make_mesh(*shape, devices="cpu")
        for dtype in (torch.float64, torch.float32):
            out[(shape, str(dtype))] = _roll(m, dtype)
    m = make_mesh(2, 2, devices="cpu")
    cfg = swarm.Config(**TRAIN, dtype=torch.float64)
    tc = tuning.TrainConfig(steps=2)
    x0 = torch.as_tensor(_grid_x0())
    params = tuning.init_params(device="cpu")
    params = tuning.TunableParams(*(p.double() for p in params))
    loss, grads = tuning.make_loss_and_grad_fn(cfg, m, tc)(
        params, x0, torch.zeros_like(x0))
    out["train"] = (float(loss), [float(g) for g in grads])
    block = convert.rank_block(_grid_x0(), m)
    out["roundtrip"] = convert.global_from_blocks(block, m)
    return out


def _world2(state_root):
    """Every 2-rank case on one rank (this rank's results)."""
    from cbf_tpu_torch import verify
    from cbf_tpu_torch.core.filter import CBFParams
    from cbf_tpu_torch.parallel import make_mesh, multihost
    from cbf_tpu_torch.scenarios import swarm

    out = {}
    rank = multihost.process_info()[0]
    m = make_mesh(1, 2, devices="cpu")
    for dtype in (torch.float64, torch.float32):
        out[((1, 2), str(dtype))] = _roll(m, dtype)
    # The row-partitioned certificate, alone and in the rollout.
    cfg = swarm.Config(**CERT, dtype=torch.float64)
    u, x = (torch.as_tensor(a) for a in _cert_inputs())
    out["cert"] = _np(swarm.apply_certificate_sharded(cfg, u, x,
                                                      m.axis("sp")))
    from cbf_tpu_torch.parallel import sharded_swarm_rollout

    (xf, vf), met = sharded_swarm_rollout(cfg, m, seeds=SEEDS)
    out["cert_roll"] = _np([xf, vf]) + [_np(list(met))]
    # The falsifier over dp = 2; each rank is given its own directories.
    mine = os.path.join(state_root, f"rank{rank}")
    tcfg = swarm.Config(**FALSIFY, dtype=torch.float64)
    a = verify.make_adapter("swarm", tcfg, cbf=CBFParams(**WEAK),
                            device="cpu")
    deltas = 0.04 * torch.as_tensor(
        np.random.default_rng(2).normal(size=(4, 16, 2)))
    out["margins"] = _np(verify.make_eval_batch(
        a, verify.SearchSettings(**SEARCH), mesh=(2, 1))(deltas))
    sink = _ListSink()
    r = verify.random_search(a, verify.SearchSettings(**SEARCH),
                             mesh=(2, 1), telemetry=sink,
                             state_dir=os.path.join(mine, "state"))
    out["search"] = (r.found, r.property, r.rounds, r.evaluated, r.margin,
                     np.asarray(r.delta))
    out["events"] = [kind for kind, _ in sink.events]
    return out


class _ListSink:
    def __init__(self):
        self.events = []

    def event(self, kind, payload):
        self.events.append((kind, payload))


def _trainer(dp, sp, n):
    """The port's loss and gradients on this rank's (dp, sp) slot
    (tests/test_torch_learn.py's sharded case; float64)."""
    from cbf_tpu_torch.learn import tuning
    from cbf_tpu_torch.scenarios import swarm

    cfg = swarm.Config(n=n, steps=2, pack_spacing=0.01, dtype=torch.float64)
    x0 = torch.as_tensor(_grid_x0())
    params = tuning.TunableParams(*(p.double() for p in
                                    tuning.init_params(device="cpu")))
    loss, grads = tuning.make_loss_and_grad_fn(
        cfg, (dp, sp), tuning.TrainConfig(steps=2))(
        params, x0, torch.zeros_like(x0))
    return float(loss), [float(g) for g in grads]


# ------------------------------------------------------------ test side --

def _run(fn, n, *args):
    from cbf_tpu_torch.parallel.launch import run_world

    return run_world(f"{MODULE}:{fn}", n, args, sys_path=(HERE,),
                     timeout_s=600)


@pytest.fixture(scope="module")
def world4():
    return _run("_world4", 4)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("world2"))
    return _run("_world2", 2, root), root


def _jax_mesh(dp, sp):
    import jax

    from cbf_tpu.parallel import make_mesh

    return make_mesh(n_dp=dp, n_sp=sp, devices=jax.devices()[:dp * sp])


def _jax_knn(fn, states, k, radius, sp=4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cbf_tpu.parallel.ensemble import shard_map

    f = shard_map(lambda s: fn(s, k, radius, "sp", True, True),
                  _jax_mesh(1, sp), in_specs=P("sp", None),
                  out_specs=(P("sp", None, None), P("sp", None),
                             P("sp", None), P("sp")))
    return [np.asarray(a) for a in jax.jit(f)(jnp.asarray(states))]


def _cat(world, key):
    """A per-rank tuple of row blocks joined in rank order."""
    return [np.concatenate([r[key][i] for r in world])
            for i in range(len(world[0][key]))]


def _sorted_dist(states, obs, mask):
    d = np.linalg.norm(obs[:, :, :2] - states[:, None, :2], axis=-1)
    d[~mask] = np.inf
    return np.sort(d, axis=1)


@pytest.mark.parametrize("key,fn", [("ring", "ring_knn"),
                                    ("gather", "all_gather_knn"),
                                    ("exchange", "exchange_knn"),
                                    ("exchange_ring", "exchange_knn")])
def test_search_matches_jax(world4, key, fn, x64):
    from cbf_tpu.parallel import alltoall, ring

    states = _search_states(64, 5)
    jfn = {"ring_knn": ring.ring_knn, "all_gather_knn":
           alltoall.all_gather_knn, "exchange_knn": alltoall.exchange_knn}[fn]
    if key == "exchange_ring":
        # JAX's own ring branch: its exchange at threshold 0 is the ring.
        jfn = ring.ring_knn
    if fn == "exchange_knn" and key == "exchange":
        jfn = alltoall.all_gather_knn
    jobs, jmask, jd, jdrop = _jax_knn(jfn, states, 6, 0.6)
    obs, mask, d, drop = _cat(world4, key)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(drop, jdrop)
    np.testing.assert_allclose(d, jd, rtol=0, atol=KNN_ATOL)
    np.testing.assert_allclose(_sorted_dist(states, obs, mask),
                               _sorted_dist(states, jobs, jmask), rtol=0,
                               atol=KNN_ATOL)


def test_k_above_total(world4, x64):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cbf_tpu.parallel.alltoall import all_gather_knn
    from cbf_tpu.parallel.ensemble import shard_map

    f = shard_map(lambda s: all_gather_knn(s, 8, 0.5, "sp", True),
                  _jax_mesh(1, 4), in_specs=P("sp", None),
                  out_specs=(P("sp", None, None), P("sp", None),
                             P("sp", None)))
    jobs, jmask, jd = (np.asarray(a) for a in
                       jax.jit(f)(jnp.asarray(_tiny_states())))
    for key in ("k_over", "k_over_ring"):
        obs, mask, d = _cat(world4, key)
        assert obs.shape == (4, 8, 4) and mask.shape == (4, 8)
        assert mask.sum(axis=1).tolist() == [2, 2, 2, 0]
        np.testing.assert_array_equal(mask, jmask)
        np.testing.assert_allclose(d, jd, rtol=0, atol=KNN_ATOL)


def _jax_roll(shape, dtype_name, fields=ROLL):
    import jax.numpy as jnp

    from cbf_tpu.parallel.ensemble import sharded_swarm_rollout
    from cbf_tpu.scenarios import swarm

    cfg = swarm.Config(**fields, dtype=getattr(jnp, dtype_name))
    (x, v), m = sharded_swarm_rollout(cfg, _jax_mesh(*shape), seeds=SEEDS)
    return np.asarray(x), np.asarray(v), [np.asarray(a) for a in m]


def _hold(got, want, atol):
    (x, v, m), (jx, jv, jm) = got, want
    np.testing.assert_allclose(x, jx, rtol=0, atol=atol)
    np.testing.assert_allclose(v, jv, rtol=0, atol=atol)
    near, jnear = m[0], jm[0]
    np.testing.assert_array_equal(np.isinf(near), np.isinf(jnear))
    fin = np.isfinite(jnear)
    np.testing.assert_allclose(near[fin], jnear[fin], rtol=0, atol=atol)
    for i in (1, 2, 3):                     # engaged, infeasible, dropped
        np.testing.assert_array_equal(m[i], jm[i])


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sharded_rollout_matches_jax(world2, world4, shape, dtype, x64):
    world = world2[0] if shape == (1, 2) else world4
    key = (shape, f"torch.{dtype}")
    got = world[0][key]
    for r in world[1:]:                     # every rank holds the whole
        for a, b in zip(_np(r[key][:2]), _np(got[:2])):
            np.testing.assert_array_equal(a, b)
    _hold(got, _jax_roll(shape, dtype),
          STRICT if dtype == "float64" else F32_ATOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_two_by_two_matches_one_rank(world4, dtype):
    from cbf_tpu_torch.parallel import make_mesh, sharded_swarm_rollout
    from cbf_tpu_torch.scenarios import swarm

    cfg = swarm.Config(**ROLL, dtype=dtype)
    (x, v), m = sharded_swarm_rollout(cfg, make_mesh(devices="cpu"), SEEDS)
    want = (x.numpy(), v.numpy(), [a.numpy() for a in m])
    _hold(world4[0][((2, 2), str(dtype))], want,
          STRICT if dtype == torch.float64 else F32_ATOL)


def test_sharded_certificate_matches_jax(world2, x64):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cbf_tpu.parallel.ensemble import shard_map
    from cbf_tpu.scenarios import swarm

    cfg = swarm.Config(**CERT, dtype=jnp.float64)
    u, x = (jnp.asarray(a) for a in _cert_inputs())
    f = shard_map(lambda uu, xx: swarm.apply_certificate_sharded(
        cfg, uu, xx, "sp"), _jax_mesh(1, 2), in_specs=(P(), P()),
        out_specs=(P(), P(), P(), P()))
    ju, jres, jdrop, jiters = (np.asarray(a) for a in jax.jit(f)(u, x))
    results = world2[0]
    for r in results:
        tu, tres, tdrop, titers = r["cert"]
        np.testing.assert_allclose(tu, ju, rtol=0, atol=STRICT)
        np.testing.assert_allclose(tres, jres, rtol=0, atol=STRICT)
        assert int(tdrop) == int(jdrop) and int(titers) == int(jiters)
    # The rollout with the certificate at (1, 2): row-partitioned.
    got = results[0]["cert_roll"]
    want = _jax_roll((1, 2), "float64", CERT)
    _hold(got, want, STRICT)
    np.testing.assert_allclose(got[2][4], want[2][4], rtol=0, atol=STRICT)
    np.testing.assert_array_equal(got[2][5], want[2][5])


def test_trainer_matches_jax(world4, x64):
    import jax.numpy as jnp

    from cbf_tpu.learn import TrainConfig, TunableParams, init_params
    from cbf_tpu.learn import make_loss_and_grad_fn
    from cbf_tpu.scenarios import swarm

    cfg = swarm.Config(**TRAIN, dtype=jnp.float64)
    params = TunableParams(*(jnp.asarray(p, jnp.float64)
                             for p in init_params()))
    x0 = jnp.asarray(_grid_x0())
    loss, grads = make_loss_and_grad_fn(cfg, _jax_mesh(2, 2),
                                        TrainConfig(steps=2))(
        params, x0, jnp.zeros_like(x0))
    for r in world4:
        tloss, tgrads = r["train"]
        assert abs(tloss - float(loss)) <= STRICT
        np.testing.assert_allclose(tgrads, [float(g) for g in grads],
                                   rtol=0, atol=STRICT)
    # The converters' round trip of a global (E, N, 2) array.
    np.testing.assert_array_equal(world4[0]["roundtrip"], _grid_x0())


def test_falsifier_dp2_matches_jax(world2, x64):
    import jax.numpy as jnp

    from cbf_tpu import verify as JV
    from cbf_tpu.core.filter import CBFParams
    from cbf_tpu.scenarios import swarm

    results, root = world2
    jcfg = swarm.Config(**FALSIFY, dtype=jnp.float64)
    a = JV.make_adapter("swarm", jcfg, cbf=CBFParams(**WEAK))
    mesh = _jax_mesh(2, 1)
    deltas = 0.04 * np.random.default_rng(2).normal(size=(4, 16, 2))
    jm = np.asarray(JV.make_eval_batch(a, JV.SearchSettings(**SEARCH),
                                       mesh=mesh)(jnp.asarray(deltas)))
    rj = JV.random_search(a, JV.SearchSettings(**SEARCH), mesh=mesh)
    for r in results:
        np.testing.assert_allclose(r["margins"], jm, rtol=0,
                                   atol=FALSIFY_ATOL)
        found, prop, rounds, evaluated, margin, delta = r["search"]
        assert (found, prop, rounds, evaluated) == (
            rj.found, rj.property, rj.rounds, rj.evaluated)
        assert abs(margin - rj.margin) <= FALSIFY_ATOL
        np.testing.assert_allclose(delta, np.asarray(rj.delta), rtol=0,
                                   atol=FALSIFY_ATOL)

    def files(rank):
        d = os.path.join(root, f"rank{rank}")
        return sorted(os.path.relpath(os.path.join(p, f), d)
                      for p, _, fs in os.walk(d) for f in fs)

    assert files(1) == [] and results[1]["events"] == []
    assert any(f.startswith("state") for f in files(0))
    assert results[0]["events"][-1] == "verify.margin"
