"""The port's cost model (cbf_tpu_torch.obs.resource) on the CPU, against
the single-process cases of tests/test_obs_resource.py and the JAX
package's CostModel on the same observations.

Held here: a prepared program's measurements under JAX's keys (argument
and output bytes measured, ``None`` where the port measures nothing — on
the CPU the peak too), nulls for an object with none; the persistence
round trip; a snapshot from another environment dropped; drift tracking
equal to JAX's model on the same walls; ``fits`` scaling the per-agent
peak; the program prepared once per cache key; and ``rollout``,
``rollout_chunked`` and the falsifier's ``make_eval_batch`` with a cost
model bit-identical to the runs without one. The warm-path drift gate of
tests/test_obs_resource.py (a host-timing bound) is left to the card run,
which reports the drift.
"""

import json

import numpy as np
import pytest
import torch

from cbf_tpu.obs import resource as jres
from cbf_tpu_torch.obs import resource as res
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.scenarios import swarm as tsw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def prepared():
    cfg = tsw.Config(n=16, steps=6, record_trajectory=True)
    state0, step = tsw.make(cfg, device="cpu")
    prog = teng._program(step, state0, cfg.steps, 4)
    return prog.prepare(step, state0, 0), state0


def test_analyze_compiled_reports_measured_bytes(prepared):
    prog, state0 = prepared
    cost = res.analyze_compiled(prog)
    assert set(cost) == set(jres.analyze_compiled(object()))
    state_bytes = sum(v.numel() * v.element_size()
                      for v in teng._leaves(state0))
    assert cost["argument_bytes"] == state_bytes + 2 * 8 + 1
    # (6, 16, 2) float32 trajectory plus the per-step scalars.
    assert cost["output_bytes"] > 6 * 16 * 2 * 4
    for key in ("flops", "bytes_accessed", "transcendentals", "temp_bytes",
                "alias_bytes", "generated_code_bytes", "peak_bytes"):
        assert cost[key] is None, key
    # prepare() leaves the start state in the carry.
    assert torch.equal(prog.carry.x, state0.x)


def test_analyze_compiled_degrades_to_nulls():
    class Broken:
        analysis = "not measured"

    assert set(res.analyze_compiled(Broken()).values()) == {None}
    assert set(res.analyze_compiled(object()).values()) == {None}


def test_cost_model_persistence_roundtrip(prepared, tmp_path):
    prog, _ = prepared
    path = str(tmp_path / "costmodel.json")
    model = res.CostModel(path)
    model.record_compile("n16-t8-x", prog, 0.5)
    model.observe_execute("n16-t8-x", 0.01)
    with open(path) as fh:
        doc = json.load(fh)
    assert doc["resource_schema"] == res.RESOURCE_SCHEMA_VERSION
    assert doc["environment"] == res.environment()
    assert set(doc["environment"]) == {"torch", "cuda", "device", "git_sha"}
    model.save()
    reloaded = res.CostModel(path)
    assert reloaded.entries["n16-t8-x"]["compiles"] == 1
    assert reloaded.cost_of("n16-t8-x")["argument_bytes"] > 0
    assert reloaded.predict_execute("n16-t8-x") == 0.01


def test_cost_model_drops_snapshot_from_other_environment(tmp_path):
    path = str(tmp_path / "costmodel.json")
    stale = res.CostModel(path, env={"torch": "0.0", "cuda": "none",
                                     "device": "elsewhere",
                                     "git_sha": "dead"})
    stale.entries["n16-t8-x"] = {"compiles": 3, "compile_s": 1.0,
                                 "cost": {}, "execute_ewma_s": 0.1,
                                 "executes": 9, "drift_recent": []}
    stale.save()
    assert res.CostModel(path).entries == {}


def test_cost_model_drift_tracking_equals_jax():
    model, jmodel = res.CostModel(), jres.CostModel()
    walls = [0.10, 0.10, 0.20, 0.15, 0.01, 0.3]
    got = [model.observe_execute("lbl", w) for w in walls]
    assert got == [jmodel.observe_execute("lbl", w) for w in walls]
    assert got[0]["predicted_s"] is None and got[0]["drift"] is None
    assert got[2]["drift"] == pytest.approx(0.5)
    assert model.drift_summary() == jmodel.drift_summary()
    assert model.entries["lbl"] == jmodel.entries["lbl"]


def test_cost_model_fits_scales_per_agent_peak():
    model = res.CostModel()
    assert model.fits(10 ** 9)                 # nothing priced: fail open
    model.entries["n16-t8-x"] = {
        "compiles": 1, "compile_s": 0.1, "executes": 0,
        "execute_ewma_s": None, "drift_recent": [],
        "cost": {"peak_bytes": 16_000}}        # 1000 bytes/agent
    model.entries["rollout-s6-u1"] = {"cost": {"peak_bytes": None}}
    assert model.predict_peak_bytes(100) == 100_000
    assert model.fits(100, budget_bytes=200_000)
    assert not model.fits(300, budget_bytes=200_000)
    assert model.fits(10 ** 9)                 # no budget known: fail open


def test_compile_and_record_caches_the_program():
    cfg = tsw.Config(n=8, steps=4)
    state0, step = tsw.make(cfg, device="cpu")
    prog = teng._program(step, state0, cfg.steps, 1)
    model = res.CostModel()
    calls = []

    def prepare(*args):
        calls.append(args)
        return prog.prepare(*args)

    p1 = model.compile_and_record("lbl", prepare, (step, state0, 0),
                                  cache_key="k")
    p2 = model.compile_and_record("lbl", prepare, (step, state0, 0),
                                  cache_key="k")
    assert p1 is p2 is prog and len(calls) == 1
    assert model.entries["lbl"]["compiles"] == 1


def test_rollout_with_cost_model_is_bit_identical():
    cfg = tsw.Config(n=8, steps=6)
    state0, step = tsw.make(cfg, device="cpu")
    final_ref, outs_ref = teng.rollout(step, state0, cfg.steps)
    model = res.CostModel()
    for _ in range(2):
        final, outs = teng.rollout(step, state0, cfg.steps, cost_model=model)
        for a, b in zip(teng._leaves((final, outs)),
                        teng._leaves((final_ref, outs_ref))):
            assert torch.equal(a, b)
    (label,) = model.entries
    assert label == "rollout-s6-u1"
    e = model.entries[label]
    assert e["compiles"] == 1 and e["executes"] == 2
    assert len(e["drift_recent"]) == 1
    final_c, outs_c, _ = teng.rollout_chunked(step, state0, cfg.steps,
                                              chunk=4, cost_model=model)
    assert torch.equal(final_c.x, final_ref.x)
    np.testing.assert_array_equal(outs_c.min_pairwise_distance,
                                  outs_ref.min_pairwise_distance.numpy())
    assert model.entries["rollout-c4-u1"]["executes"] == 2


def test_eval_batch_with_cost_model_is_bit_identical():
    from cbf_tpu_torch import verify as TV

    cfg = tsw.Config(n=8, steps=5)
    a = TV.make_adapter("swarm", cfg, device="cpu")
    settings = TV.SearchSettings(batch=4)
    deltas = torch.zeros((4,) + tuple(a.state0.x.shape), dtype=torch.float32)
    deltas[1, 0, 0] = 0.01
    want = TV.make_eval_batch(a, settings)(deltas)
    model = res.CostModel()
    got = TV.make_eval_batch(a, settings, cost_model=model)(deltas)
    assert torch.equal(got, want)
    assert model.entries["verify-eval-b4-s5"]["executes"] == 1
