"""The port's multi-process layer (cbf_tpu_torch/parallel/multihost.py and
launch.py) held to the JAX package's multihost contract
(tests/test_multihost.py).

- ``initialize()`` with no world in the environment is a single-process
  no-op, twice; ``process_info`` is (0, 1) and the process is primary.
- In a 2-rank world (:func:`cbf_tpu_torch.parallel.launch.run_world`,
  gloo over a file store) ``initialize`` is idempotent, each rank knows
  its (index, count) and exactly one is primary, ``global_mesh`` builds
  the (dp, sp) mesh over both, ``gather_metrics`` concatenates every
  rank's block in rank order and ``shard_host_ensembles`` places each
  rank's block at its offset; a mesh beyond the world raises JAX's
  ValueError text (``cbf_tpu/parallel/mesh.py:38-43``).
- A rank that raises fails the world with its traceback, and the others
  are stopped.
"""

import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
MODULE = os.path.splitext(os.path.basename(__file__))[0]


def _rank_info():
    from cbf_tpu_torch.parallel import multihost

    multihost.initialize()                        # already joined: no-op
    multihost.initialize()
    rank, size = multihost.process_info()
    mesh = multihost.global_mesh(n_sp=2, devices="cpu")
    block, offset = multihost.shard_host_ensembles(
        multihost.global_mesh(devices="cpu"),
        np.full((3, 2), rank, np.float32))
    out = {"info": (rank, size, multihost.is_primary()),
           "mesh": (tuple(mesh), mesh.axis("sp").index),
           "gathered": multihost.gather_metrics(
               {"a": np.full((2,), rank, np.int32)})["a"],
           "feed": (tuple(block.shape), offset)}
    for kw, key in ((dict(n_dp=4), "too_big"), (dict(n_sp=3), "no_divide")):
        try:
            multihost.global_mesh(devices="cpu", **kw)
        except ValueError as e:
            out[key] = str(e)
    return out


def _rank_fails():
    from cbf_tpu_torch.parallel import multihost

    if multihost.process_info()[0] == 1:
        raise RuntimeError("rank one fails on purpose")
    import torch.distributed as dist

    dist.barrier()                   # rank 0 would wait here for ever


def test_initialize_noop_without_world(monkeypatch):
    from cbf_tpu_torch.parallel import multihost

    for name in ("RANK", "WORLD_SIZE", multihost.STORE_ENV):
        monkeypatch.delenv(name, raising=False)
    multihost.initialize()
    multihost.initialize()
    assert multihost.process_info() == (0, 1) and multihost.is_primary()
    assert tuple(multihost.global_mesh(devices="cpu")) == (1, 1)
    assert multihost.gather_metrics({"a": np.arange(3)})["a"].tolist() == \
        [0, 1, 2]
    with pytest.raises(ValueError, match="together"):
        multihost.initialize(coordinator_address="localhost:1")


def test_two_rank_world():
    from cbf_tpu_torch.parallel.launch import run_world

    results = run_world(f"{MODULE}:_rank_info", 2, sys_path=(HERE,),
                        timeout_s=300)
    for rank, r in enumerate(results):
        assert r["info"] == (rank, 2, rank == 0)
        assert r["mesh"] == ((1, 2), rank)
        assert r["gathered"].tolist() == [0, 0, 1, 1]
        assert r["feed"] == ((3, 2), 3 * rank)
        assert r["too_big"] == "mesh 4x1 exceeds 2 devices"
        assert r["no_divide"] == "n_sp=3 must divide device count 2"


def test_failed_rank_fails_the_world():
    from cbf_tpu_torch.parallel.launch import RankError, run_world

    with pytest.raises(RankError, match="rank one fails on purpose"):
        run_world(f"{MODULE}:_rank_fails", 2, sys_path=(HERE,),
                  timeout_s=300)
