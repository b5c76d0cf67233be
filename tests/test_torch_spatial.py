"""The port's spatial partition (cbf_tpu_torch/parallel/spatial.py) held to
the JAX package's (cbf_tpu/parallel/spatial.py, tests/test_spatial.py).

The port's tiles are ranks: one module-scoped job runs every 4-tile case
in a world of 4 (:func:`cbf_tpu_torch.parallel.launch.run_world`, gloo
over a file store, one torch thread per rank, no jax in a rank).

Cases and tolerances:

- PARITY: ``partition="spatial"`` over 4 tiles against the port's flat
  one-rank rollout at N in {256, 1024}, and with the certificate at
  N = 256, to JAX's pinned 1e-5 (float32 summation order); the engaged
  counts equal; and against JAX's own spatial run at the same bound.
- BOUNDARY CROSSING: at the first step an agent changes tiles, the
  spatial neighbour sets equal the dense all-pairs reference for every
  agent.
- OVERFLOW: a saturated tile raises :class:`SpatialOverflowError`
  ("tile capacity"), a saturated halo raises it ("halo"); the counted
  fallback keeps every agent in a real slot and counts the spills.
- REJECTIONS: ``plan_tiles`` and the rollout's ValueErrors carry the JAX
  package's text word for word, and the plan itself equals JAX's.
- BINNING: the binning pass equals JAX's slot for slot, spills included;
  ``convert.slab_to_agents``/``agents_to_slab`` carry slabs to agent
  order and back.
- CLI: ``scenario run swarm --partition spatial --tiles 2`` prints JAX's
  record, key for key and value for value.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
MODULE = os.path.splitext(os.path.basename(__file__))[0]
ATOL = 1e-5
PARITY = {256: dict(n=256, steps=4, k_neighbors=4),
          1024: dict(n=1024, steps=4, k_neighbors=4)}
CERT = dict(n=256, steps=3, k_neighbors=4, certificate=True,
            certificate_backend="sparse", certificate_iters=4,
            certificate_cg_iters=4)
CROSS = dict(n=64, steps=1, k_neighbors=4)
# A spawn box (|x| <= 0.5) astride the tile-1|tile-2 face of an 8 m arena
# cut into 4 strips: a hand-shrunk capacity saturates deterministically.
PACKED = dict(n=32, steps=2, k_neighbors=4, spawn_half_width_override=0.5,
              arena_half_override=8.0)


# ------------------------------------------------------------ rank side --

def _world4():
    from cbf_tpu_torch.parallel import make_mesh, sharded_swarm_rollout
    from cbf_tpu_torch.parallel import spatial
    from cbf_tpu_torch.scenarios import swarm

    mesh = make_mesh(1, 4, devices="cpu")
    out = {}
    for key, fields in (*PARITY.items(), ("cert", CERT)):
        (x, v), m = sharded_swarm_rollout(swarm.Config(**fields), mesh, [0],
                                          partition="spatial")
        out[key] = (x.numpy(), v.numpy(), [np.asarray(a) for a in m])

    # The first tile crossing, then the neighbour sets there.
    cfg = swarm.Config(**CROSS)
    spec = spatial.plan_tiles(cfg, 4, rebin_every=1)
    width = 2.0 * spec.half / 4
    x = swarm.clear_obstacle_spawn(cfg, swarm.spawn_positions(cfg, cfg.seed,
                                                              device="cpu"))
    v = torch.zeros_like(x)

    def tile_of(p):
        return np.clip(np.floor((p[:, 0] + spec.half) / width), 0,
                       3).astype(int)

    for k in range(40):
        before = tile_of(x.numpy())
        (x, v), _, rep = spatial.spatial_swarm_rollout(
            cfg, mesh, steps=1, initial_state=(x, v), t0=k, spec=spec)
        assert rep.overflow_total == 0 and rep.halo_dropped_total == 0
        moved = np.where(tile_of(x.numpy()) != before)[0]
        if moved.size:
            out["crossing"] = (k, moved, x.numpy().copy(),
                               spatial.spatial_knn_sets(cfg, mesh, x,
                                                        spec=spec))
            break

    cfg = swarm.Config(**PACKED)
    small = spatial.plan_tiles(cfg, 4, rebin_every=1)._replace(
        capacity=8, block_rows=8, halo_capacity=8)
    thin_halo = spatial.plan_tiles(cfg, 4, rebin_every=1)._replace(
        halo_capacity=8)
    for key, spec in (("tile", small), ("halo", thin_halo)):
        try:
            spatial.spatial_swarm_rollout(cfg, mesh, spec=spec)
        except spatial.SpatialOverflowError as e:
            out[f"raise_{key}"] = str(e)
        (x, _), _, rep = spatial.spatial_swarm_rollout(
            cfg, mesh, spec=spec, on_overflow="fallback")
        out[f"fallback_{key}"] = (x.numpy(), dataclasses.asdict(rep))
    return out


# ------------------------------------------------------------ test side --

@pytest.fixture(scope="module")
def world4():
    from cbf_tpu_torch.parallel.launch import run_world

    return run_world(f"{MODULE}:_world4", 4, sys_path=(HERE,),
                     timeout_s=600)


def _flat(fields):
    from cbf_tpu_torch.parallel import make_mesh, sharded_swarm_rollout
    from cbf_tpu_torch.scenarios import swarm

    (x, v), m = sharded_swarm_rollout(swarm.Config(**fields),
                                      make_mesh(devices="cpu"), [0])
    return x.numpy(), v.numpy(), [np.asarray(a) for a in m]


def _jax_spatial(fields):
    import jax

    from cbf_tpu.parallel.ensemble import sharded_swarm_rollout
    from cbf_tpu.parallel.mesh import make_mesh
    from cbf_tpu.scenarios import swarm

    mesh = make_mesh(n_dp=1, n_sp=4, devices=jax.devices()[:4])
    (x, v), m = sharded_swarm_rollout(swarm.Config(**fields), mesh, [0],
                                      partition="spatial")
    return np.asarray(x), np.asarray(v), [np.asarray(a) for a in m]


@pytest.mark.parametrize("key", [256, 1024, "cert"])
def test_spatial_parity(world4, key):
    fields = CERT if key == "cert" else PARITY[key]
    x, v, m = world4[0][key]
    for r in world4[1:]:                    # every rank holds the swarm
        np.testing.assert_array_equal(r[key][0], x)
    for want in (_flat(fields), _jax_spatial(fields)):
        wx, wv, wm = want
        assert x.shape == wx.shape == (1, fields["n"], 2)
        np.testing.assert_allclose(x, wx, rtol=0, atol=ATOL)
        np.testing.assert_allclose(v, wv, rtol=0, atol=ATOL)
        np.testing.assert_allclose(m[0], wm[0], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(m[1], wm[1])
        np.testing.assert_allclose(m[4], wm[4], rtol=0, atol=ATOL)


def test_boundary_crossing_keeps_knn_identical(world4):
    assert "crossing" in world4[0], \
        "no agent crossed a tile boundary in 40 steps — test is vacuous"
    k, moved, x, sets = world4[0]["crossing"]
    x = x.astype(np.float32)
    d = np.linalg.norm(x[:, None, :] - x[None, :, :], axis=-1)
    ref = []
    for a in range(CROSS["n"]):
        elig = np.where((d[a] < 0.4) & (d[a] > 0))[0]
        order = elig[np.argsort(d[a][elig], kind="stable")]
        ref.append({int(i) for i in order[:CROSS["k_neighbors"]]})
    assert sets == ref, f"crossing agents {moved.tolist()} at step {k}"
    assert all(r["crossing"][3] == sets for r in world4[1:])


def test_overflow_raises_typed_and_fallback_counts(world4):
    out = world4[0]
    assert "tile capacity" in out["raise_tile"]
    assert "halo" in out["raise_halo"]
    x, rep = out["fallback_tile"]
    assert rep["overflow_total"] > 0         # counted, never silent
    assert x.shape == (PACKED["n"], 2) and np.all(np.isfinite(x))
    # Every agent was integrated from a real slot, not left parked.
    assert np.all(np.abs(x) < 1.0e6 / 2)
    assert out["fallback_halo"][1]["halo_dropped_total"] > 0


@pytest.mark.parametrize("fields,tiles,capacity", [
    (dict(n=256), 4, None),
    (PACKED, 4, 8),                 # saturated tiles: the spill path
])
def test_binning_matches_jax(fields, tiles, capacity):
    """The binning pass equals JAX's slot for slot (slabs, validity,
    slot_of_agent, overflow, occupancy), and the slab converters carry the
    slabs back to agent order and out again."""
    import jax.numpy as jnp

    from cbf_tpu.parallel import spatial as jsp
    from cbf_tpu.scenarios import swarm as jsw
    from cbf_tpu_torch import convert
    from cbf_tpu_torch.parallel import spatial as tsp
    from cbf_tpu_torch.scenarios import swarm as tsw

    spec = tsp.plan_tiles(tsw.Config(**fields), tiles)
    C = capacity or spec.capacity
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (fields["n"], 2)).astype(np.float32)
    v = rng.normal(0, 0.1, (fields["n"], 2)).astype(np.float32)
    got = tsp._bin(torch.as_tensor(x), torch.as_tensor(v), spec.half, tiles,
                   C)
    want = jsp._bin_executable(fields["n"], tiles, C)(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(spec.half, jnp.float32))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (int(got[4]) > 0) == (capacity is not None)
    x_slab, v_slab, _, slot = (a.numpy() for a in got[:4])
    np.testing.assert_array_equal(convert.slab_to_agents(x_slab, slot), x)
    np.testing.assert_array_equal(convert.slab_to_agents(v_slab, slot), v)
    np.testing.assert_array_equal(
        convert.agents_to_slab(x, slot, tiles * C, fill=tsp.PARK), x_slab)
    np.testing.assert_array_equal(
        convert.agents_to_slab(v, slot, tiles * C), v_slab)


def _same_error(jcall, tcall):
    with pytest.raises(ValueError) as jerr:
        jcall()
    with pytest.raises(ValueError) as terr:
        tcall()
    assert str(terr.value) == str(jerr.value)


def test_plans_and_rejections_match_jax():
    import jax

    from cbf_tpu.parallel import ensemble as jens
    from cbf_tpu.parallel import spatial as jsp
    from cbf_tpu.parallel.mesh import make_mesh as jmesh
    from cbf_tpu.scenarios import swarm as jsw
    from cbf_tpu_torch.parallel import ensemble as tens
    from cbf_tpu_torch.parallel import spatial as tsp
    from cbf_tpu_torch.parallel.mesh import Mesh
    from cbf_tpu_torch.scenarios import swarm as tsw

    for fields, tiles, kw in ((dict(n=1024), 4, {}),
                              (dict(n=256, certificate=True), 2,
                               dict(rebin_every=4, slack=1.5)),
                              (PACKED, 4, dict(rebin_every=1))):
        assert tuple(tsp.plan_tiles(tsw.Config(**fields), tiles, **kw)) == \
            tuple(jsp.plan_tiles(jsw.Config(**fields), tiles, **kw))
    for kw in (dict(n_tiles=64), dict(n_tiles=0), dict(n_tiles=2, slack=0.5),
               dict(n_tiles=2, rebin_every=0),
               dict(n_tiles=2, halo_capacity=10**6),
               dict(n_tiles=2, block_rows=0)):
        _same_error(lambda: jsp.plan_tiles(jsw.Config(n=256), **kw),
                    lambda: tsp.plan_tiles(tsw.Config(n=256), **kw))
    j2 = jmesh(n_dp=1, n_sp=2, devices=jax.devices()[:2])
    j22 = jmesh(n_dp=2, n_sp=2, devices=jax.devices()[:4])
    t2 = Mesh(1, 2, torch.device("cpu"))
    t22 = Mesh(2, 2, torch.device("cpu"))
    _same_error(lambda: jsp.spatial_swarm_rollout(
        jsw.Config(n=32), j2, on_overflow="ignore"),
        lambda: tsp.spatial_swarm_rollout(tsw.Config(n=32), t2,
                                          on_overflow="ignore"))
    _same_error(lambda: jens.sharded_swarm_rollout(
        jsw.Config(n=32), j2, [0, 1], partition="spatial"),
        lambda: tens.sharded_swarm_rollout(tsw.Config(n=32), t2, [0, 1],
                                           partition="spatial"))
    _same_error(lambda: jens.sharded_swarm_rollout(
        jsw.Config(n=32), j22, [0], partition="spatial"),
        lambda: tens.sharded_swarm_rollout(tsw.Config(n=32), t22, [0],
                                           partition="spatial"))
    for fields in (dict(dynamics="double"), dict(n_obstacles=2),
                   dict(gating="pallas"), dict(gating_rebuild_skin=0.1),
                   dict(certificate=True, certificate_backend="dense"),
                   dict(certificate=True, certificate_backend="sparse",
                        certificate_tol=1e-5),
                   dict(certificate=True, certificate_backend="sparse",
                        certificate_fused=True),
                   dict(certificate=True, certificate_backend="sparse",
                        certificate_partition="replicate")):
        _same_error(lambda: jsp.spatial_swarm_rollout(
            jsw.Config(n=32, **fields), j2),
            lambda: tsp.spatial_swarm_rollout(tsw.Config(n=32, **fields),
                                              t2))
    _same_error(lambda: jens.sharded_swarm_rollout(
        jsw.Config(n=32), j2, [0], partition="spatial", chunk=2),
        lambda: tens.sharded_swarm_rollout(tsw.Config(n=32), t2, [0],
                                           partition="spatial", chunk=2))


def test_cli_scenario_run_spatial_matches_jax(capsys):
    from cbf_tpu.__main__ import main as jmain
    from cbf_tpu_torch.__main__ import main

    argv = ["scenario", "run", "swarm", "--partition", "spatial",
            "--tiles", "2", "--steps", "8"]
    assert main([*argv, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jmain([*argv, "--platform", "cpu"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    # A rejected plan: JAX's exit code 2 and its message.
    bad = ["scenario", "run", "swarm", "--partition", "spatial",
           "--tiles", "2", "--set", "dynamics=double", "--steps", "2"]
    assert main([*bad, "--device", "cpu"]) == 2
    terr = capsys.readouterr().err
    assert jmain([*bad, "--platform", "cpu"]) == 2
    assert terr == capsys.readouterr().err
