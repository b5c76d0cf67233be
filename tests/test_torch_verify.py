"""The port's falsifier (cbf_tpu_torch/verify/) held to the JAX package's
on the CPU: margins against JAX's and the NumPy twin, each engine's
first-round proposals bit-equal to JAX's and its verdict within
tolerance on a float64 config, the member-batched evaluation against
each candidate alone, the shrinker, the corpus replay against the JAX
package's replay today, campaign persistence and the CLI's exit codes.
(test_telemetry_events_and_out_of_slice was rewritten when the dp mesh
was ported: ``verify fleet --mesh-dp 2`` runs one round on 2 ranks, its
record the JAX package's.)

The checked-in corpus's 'violates' record holds a stale margin
(-0.008842539358781237): the JAX package itself replays it to
-0.010228727023062295 today (ROADMAP Queue C), so the port is held to the
JAX replay (float64, within CORPUS_ATOL) and the verdicts exactly — the
recorded number is reported, not taken as the baseline.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu import verify as JV
from cbf_tpu.core.filter import CBFParams as JParams
from cbf_tpu.rollout import engine as jeng
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu_torch import __main__ as tcli
from cbf_tpu_torch import verify as TV
from cbf_tpu_torch.core.filter import CBFParams as TParams
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.scenarios import swarm as tsw
from cbf_tpu_torch.utils import prng
from cbf_tpu_torch.verify import properties as tprops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "corpus", "violations.jsonl")
# float64 replays: the two packages run the same operations in other
# summation orders (antipodal's measured gap 2e-16).
CORPUS_ATOL = 1e-12
ENGINE_ATOL = 1e-12
CORPUS_CFG = dict(n=16, steps=140, k_neighbors=4, gating="jnp")
WEAK = dict(max_speed=15.0, dmin=0.16, k=0.0, gamma=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_rollout_margins_match_jax_and_numpy(x64):
    """Margins of one recorded swarm rollout (obstacles and a trajectory,
    so every property is live): the port's torch form equals JAX's on the
    same record and the NumPy twin; the closed-form longest run equals
    the loop."""
    cfg = jsw.Config(n=16, steps=12, n_obstacles=2, record_trajectory=True,
                     dtype=jnp.float64, pack_spacing=0.02)
    s0, step = jsw.make(cfg)
    final, outs = jeng.rollout(step, s0, cfg.steps)
    th = dataclasses.replace(JV.thresholds_for("swarm", cfg),
                             goal_radius=0.3, infeasible_streak_limit=3)
    want = JV.rollout_margins(
        th, outs, final.x, trajectory=outs.trajectory,
        obstacle_fn=lambda t: jsw.obstacle_states_at(cfg, t,
                                                     cfg.dtype)[:, :2])
    tcfg = tsw.Config(n=16, steps=12, n_obstacles=2, pack_spacing=0.02,
                      dtype=torch.float64)
    touts = teng.StepOutputs(*(
        () if isinstance(v, tuple) else torch.as_tensor(np.asarray(v))
        for v in outs))
    tth = TV.PropertyThresholds(**dataclasses.asdict(th))
    got = TV.rollout_margins(
        tth, touts, torch.as_tensor(np.asarray(final.x)),
        trajectory=touts.trajectory,
        obstacle_fn=lambda T: tsw.obstacle_table(tcfg, 0, T,
                                                 torch.float64)[..., :2])
    twin = TV.rollout_margins_np(
        tth, touts, np.asarray(final.x), trajectory=touts.trajectory,
        obstacle_fn_np=lambda t: tsw.obstacle_positions_at(tcfg, t))
    for name, g, w in zip(TV.PROPERTY_NAMES, got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=0, atol=1e-12)
        np.testing.assert_allclose(float(g), twin[name], rtol=0, atol=1e-12)
    flags = torch.tensor([1, 1, 0, 1, 1, 1, 0, 0, 1], dtype=torch.bool)
    assert int(tprops._longest_true_run(flags)) == 3
    assert int(tprops._longest_true_run(torch.zeros(4, dtype=bool))) == 0


def _adapters(steps=60):
    jcfg = jsw.Config(**{**CORPUS_CFG, "steps": steps}, dtype=jnp.float64)
    tcfg = tsw.Config(**{**CORPUS_CFG, "steps": steps}, dtype=torch.float64)
    aj = JV.make_adapter("swarm", jcfg, cbf=JParams(**WEAK))
    at = TV.make_adapter("swarm", tcfg, cbf=TParams(**WEAK), device="cpu")
    return aj, at


@pytest.mark.parametrize("engine", ["random", "cem", "grad"])
def test_engines_match_jax(engine, x64):
    """First-round proposals bit-equal to JAX's (same fold_in keys, same
    float64 normals); the engine's verdict within ENGINE_ATOL."""
    aj, at = _adapters()
    kw = dict(budget=8, batch=4, seed=3, cem_rounds=2, gd_iters=2,
              gd_candidates=3)
    if engine == "grad":
        aj = JV.make_adapter("swarm", aj.cfg, differentiable=True)
        at = TV.make_adapter("swarm", at.cfg, differentiable=True,
                             device="cpu")
    tag = {"random": 1, "grad": 2, "cem": 3}[engine]
    key = prng.fold_in(prng.prng_key(3), tag)
    shape = (3 if engine == "grad" else 4, 16, 2)
    import jax
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), tag)
    if engine != "grad":
        key, jkey = prng.fold_in(key, 0), jax.random.fold_in(jkey, 0)
    np.testing.assert_array_equal(
        (0.04 * prng.normal(key, shape, torch.float64)).numpy(),
        np.asarray(0.04 * jax.random.normal(jkey, shape, jnp.float64)))
    fn = {"random": "random_search", "cem": "cem_search",
          "grad": "gradient_search"}[engine]
    rj = getattr(JV, fn)(aj, JV.SearchSettings(**kw))
    rt = getattr(TV, fn)(at, TV.SearchSettings(**kw))
    assert (rt.found, rt.property, rt.rounds, rt.evaluated) == \
        (rj.found, rj.property, rj.rounds, rj.evaluated)
    assert abs(rt.margin - rj.margin) <= ENGINE_ATOL
    np.testing.assert_allclose(rt.delta, np.asarray(rj.delta), rtol=0,
                               atol=ENGINE_ATOL)


@pytest.mark.parametrize("scenario,override", [
    # tests/test_torch_rollout.py's orbit: its QPs relax from step 5 on.
    ("swarm", dict(n=96, steps=12, k_neighbors=6, n_obstacles=8, seed=2,
                   obstacle_omega=2.0, rta=True)),
    ("swarm", dict(n=16, steps=4, certificate=True,
                   certificate_backend="sparse", certificate_k=4)),
    ("antipodal", dict(n=8, steps=20)),
    ("meet_at_center", dict(iterations=20)),
    # A default fleet target: the dense certificate under the member axis.
    ("cross_and_rescue", dict(iterations=12)),
    ("cross_and_rescue", dict(iterations=12, dtype=torch.float64)),
])
def test_eval_batch_equals_each_candidate_alone(scenario, override):
    """The member-batched compiled evaluation (vmap of the capture-safe
    step, one kernel launch per step for the batch) equals each candidate
    run alone through the eager step, bit for bit on the CPU; a batch
    whose relax flag is set is redone candidate by candidate."""
    from cbf_tpu_torch.scenarios.platform import registry

    cfg = dataclasses.replace(registry.get(scenario).make_config(),
                              **override)
    a = TV.make_adapter(scenario, cfg, device="cpu")
    settings = TV.SearchSettings(perturb_norm=0.1)
    deltas = 0.04 * prng.normal(prng.prng_key(1), (3,) + a.delta_shape,
                                a.positions(a.state0).dtype)
    teng.COUNTS.update(dict.fromkeys(teng.COUNTS, 0))
    batched = TV.make_eval_batch(a, settings)(deltas)
    one = TV.make_eval_one(a, settings)
    for b in range(3):
        assert torch.equal(batched[b], one(deltas[b]))
    if scenario == "swarm" and cfg.rta:
        a.step.relax_rounds = 0            # every relax round now redoes
        redone = TV.make_eval_batch(a, settings)(deltas)
        assert teng.COUNTS["redos"] >= 1
        assert torch.equal(redone, batched)


def test_shrink_matches_jax(x64):
    """The shrinker's earliest step, horizon and scale equal JAX's on the
    corpus config's counterexample; its float64 margin within
    CORPUS_ATOL."""
    entry = TV.load_entries(CORPUS)[0]
    delta = np.asarray(entry["delta"])
    jcfg = jsw.Config(**CORPUS_CFG)
    tcfg = tsw.Config(**CORPUS_CFG)
    sj = JV.shrink("swarm", jcfg, delta, cbf=JParams(**WEAK),
                   bisect_iters=1)
    st = TV.shrink("swarm", tcfg, delta, cbf=TParams(**WEAK),
                   bisect_iters=1, device="cpu")
    assert (st.earliest_step, st.steps, st.scale, st.property,
            st.confirmed_x64) == (sj.earliest_step, sj.steps, sj.scale,
                                  sj.property, sj.confirmed_x64)
    assert abs(st.margin_x64 - sj.margin_x64) <= CORPUS_ATOL
    assert abs(st.margin - sj.margin) <= 1e-5


def test_corpus_replay_matches_jax_replay():
    """Every checked-in entry keeps its verdict, and its float64 margin
    equals the JAX package's replay today within CORPUS_ATOL."""
    for entry in TV.load_entries(CORPUS):
        got = TV.replay_entry(entry, device="cpu")
        want = JV.replay_entry(entry)
        assert TV.check_verdict(entry, got) == []
        assert got["violation"] == want["violation"]
        for name in TV.PROPERTY_NAMES:
            g, w = got["margins"][name], want["margins"][name]
            assert (g == w) or abs(g - w) <= CORPUS_ATOL, (name, g, w)


def test_campaign_state_resumes_and_rejects_drift(tmp_path):
    cfg = tsw.Config(n=16, steps=10)
    a = TV.make_adapter("swarm", cfg, device="cpu")
    s = TV.SearchSettings(budget=8, batch=4, seed=2)
    full = TV.random_search(a, s)
    TV.random_search(a, dataclasses.replace(s, budget=4),
                     state_dir=str(tmp_path))
    with pytest.raises(ValueError, match="budget"):
        TV.random_search(a, s, state_dir=str(tmp_path))
    TV.reset_campaign_state(str(tmp_path))
    TV.cem_search(a, s, state_dir=str(tmp_path))
    resumed = TV.cem_search(a, s, state_dir=str(tmp_path))
    assert resumed.evaluated == 8
    assert not full.found


class _Sink:
    def __init__(self):
        self.events = []

    def event(self, kind, payload):
        self.events.append((kind, payload))


def test_telemetry_events_and_out_of_slice(tmp_path, capsys):
    cfg = tsw.Config(n=16, steps=5)
    a = TV.make_adapter("swarm", cfg, device="cpu")
    sink = _Sink()
    TV.random_search(a, TV.SearchSettings(budget=4, batch=4), telemetry=sink)
    assert [k for k, _ in sink.events] == ["verify.round", "verify.margin"]
    json.dumps(sink.events)
    # A dp mesh outside a world asks for more ranks than there are (JAX's
    # text); --mesh-dp 2 starts two ranks and runs the fleet's round,
    # its record the JAX package's at a dp-2 mesh. (These raised until
    # the dp mesh was ported.)
    with pytest.raises(ValueError, match="mesh 2x1 exceeds 1 devices"):
        TV.make_eval_batch(a, TV.SearchSettings(), mesh=(2, 1))
    from cbf_tpu.__main__ import main as jmain

    argv = ["verify", "fleet", "--mesh-dp", "2", "--budget-rounds", "1",
            "--batch", "2", "--set", "batches_per_round=1",
            "--set", "generated_count=0", "--set", "include_rta=false",
            "--set", "max_steps=6", "--json"]
    capsys.readouterr()
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["rounds"] == 1
    assert jmain([*argv, "--platform", "cpu"]) == 0
    assert got == json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # verify --telemetry-dir (Queue A9) streams the sweep's events.
    from cbf_tpu_torch import obs

    run_dir = str(tmp_path / "x")
    assert tcli.main(["verify", "--device", "cpu", "--set", "n=8",
                      "--steps", "5", "--budget", "4", "--batch", "4",
                      "--engine", "random", "--json",
                      "--telemetry-dir", run_dir]) == 0
    assert json.loads(capsys.readouterr().out)["telemetry"] == run_dir
    assert [e["event"] for e in obs.read_events(run_dir)] == [
        "verify.round", "verify.margin", "summary"]


@pytest.mark.parametrize("weaken,want", [(["--weaken", "dmin=0.16"], 3),
                                         ([], 0)])
def test_cli_exit_codes(weaken, want, tmp_path, capsys):
    """``verify`` exits 3 on the weakened corpus config and 0 on the
    default, as the JAX package's CLI does."""
    from cbf_tpu import __main__ as jcli

    args = ["verify", "swarm", "--set", "n=16", "--set", "steps=140",
            "--set", "k_neighbors=4", "--set", "gating=jnp", "--budget",
            "8", "--batch", "8", "--no-shrink", "--json", *weaken]
    assert tcli.main([*args, "--device", "cpu"]) == want
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main([*args, "--platform", "cpu"]) == want
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for g, r in zip(got["results"], ref["results"]):
        assert (g["engine"], g["found"], g["property"]) == \
            (r["engine"], r["found"], r["property"])
        assert abs(g["margin"] - r["margin"]) <= 1e-5
