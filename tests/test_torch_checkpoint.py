"""The port's checkpoints (cbf_tpu_torch.utils.checkpoint, durable.
integrity) on the CPU, against tests/test_checkpoint.py's single-device
cases and the JAX package's own checkpoints.

Held here: chunked == monolithic; a resume after an interruption equals
the uninterrupted run (bit for bit) and, in float32 from the same numpy
state, JAX's resumed run within tests/test_torch_rollout.py's tolerances
(min distance rtol 1e-6, x and v atol 1e-5); ``resume=False`` ignores
checkpoints; a missing restore raises; the certificate's warm solver state
survives a resume; a corrupt newest step is walked back; a hand-truncated
step with no manifest fails closed ("refusing") — the contract of the
reference test's docstring, which the JAX package breaks on jax 0.9; the
durable resume skips a corrupt newest step and stays bit-exact; a template
that does not match, or a payload whose bytes differ from the manifest,
is CheckpointCorrupt. The manifests of the same float32 states are the
JAX package's, key for key and digest for digest.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.durable import integrity as jint
from cbf_tpu.rollout import engine as jeng
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.utils import checkpoint as jckpt
from cbf_tpu_torch import convert
from cbf_tpu_torch.durable import integrity as tint
from cbf_tpu_torch.durable import rollout as tdr
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.scenarios import swarm as tsw
from cbf_tpu_torch.utils import checkpoint as ckpt

FIELDS = dict(n=16, steps=12, k_neighbors=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scenario():
    cfg = tsw.Config(**FIELDS)
    state0, step = tsw.make(cfg, device="cpu")
    return cfg, state0, step


def _same(a, b):
    """Tensor trees equal bit for bit."""
    la, lb = teng._leaves(a), teng._leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _damage_step(directory, step):
    """Flip the first byte of the step's payload (tests/test_checkpoint.py's
    corruption model)."""
    path = os.path.join(directory, str(step), ckpt.DATA_NAME)
    with open(path, "r+b") as fh:
        b = fh.read(1)
        fh.seek(0)
        fh.write(bytes([b[0] ^ 0xFF]))


def test_chunked_matches_monolithic(scenario):
    cfg, state0, step = scenario
    ref_final, ref_outs = teng.rollout(step, state0, cfg.steps)
    final, outs, start = teng.rollout_chunked(step, state0, cfg.steps,
                                              chunk=5)
    assert start == 0
    _same(final, ref_final)
    np.testing.assert_array_equal(outs.min_pairwise_distance,
                                  ref_outs.min_pairwise_distance.numpy())


def test_resume_from_interruption(scenario, tmp_path):
    cfg, state0, step = scenario
    d = str(tmp_path / "ckpt")
    teng.rollout_chunked(step, state0, 8, chunk=4, checkpoint_dir=d)
    assert ckpt.latest_step(d) == 8
    final, outs, start = teng.rollout_chunked(step, state0, cfg.steps,
                                              chunk=4, checkpoint_dir=d)
    assert start == 8 and outs.min_pairwise_distance.shape[0] == 4
    ref_final, ref_outs = teng.rollout(step, state0, cfg.steps)
    _same(final, ref_final)
    np.testing.assert_array_equal(outs.min_pairwise_distance,
                                  ref_outs.min_pairwise_distance[8:].numpy())
    # A complete directory: nothing to run, the state restored as it is.
    final2, outs2, start2 = teng.rollout_chunked(step, state0, cfg.steps,
                                                 chunk=4, checkpoint_dir=d)
    assert start2 == cfg.steps and outs2 is None
    _same(final2, final)


def test_resume_false_ignores_checkpoints(scenario, tmp_path):
    cfg, state0, step = scenario
    d = str(tmp_path / "ckpt")
    teng.rollout_chunked(step, state0, 8, chunk=4, checkpoint_dir=d)
    _, outs, start = teng.rollout_chunked(step, state0, cfg.steps, chunk=6,
                                          checkpoint_dir=d, resume=False)
    assert start == 0 and outs.min_pairwise_distance.shape[0] == cfg.steps


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), {"a": np.zeros(2)})


def test_resumed_state_equals_jax(tmp_path):
    """The same float32 spawn through JAX's interrupted-and-resumed run and
    the port's: final state and the resumed outputs within the rollout
    tolerances, every count exact."""
    jcfg = jsw.Config(**FIELDS)
    jstate0, jstep = jsw.make(jcfg)
    jd = str(tmp_path / "jax")
    jeng.rollout_chunked(jstep, jstate0, 8, chunk=4, checkpoint_dir=jd)
    jfinal, jouts, jstart = jeng.rollout_chunked(jstep, jstate0, jcfg.steps,
                                                 chunk=4, checkpoint_dir=jd)
    cfg = tsw.Config(**FIELDS)
    _, step = tsw.make(cfg, device="cpu")
    state0 = convert.state_from_reference(jstate0, device="cpu",
                                          dtype=torch.float32)
    d = str(tmp_path / "port")
    teng.rollout_chunked(step, state0, 8, chunk=4, checkpoint_dir=d)
    final, outs, start = teng.rollout_chunked(step, state0, cfg.steps,
                                              chunk=4, checkpoint_dir=d)
    assert start == jstart == 8
    np.testing.assert_allclose(final.x.numpy(), np.asarray(jfinal.x),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(final.v.numpy(), np.asarray(jfinal.v),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(outs.min_pairwise_distance,
                               np.asarray(jouts.min_pairwise_distance),
                               rtol=1e-6)
    for name in ("filter_active_count", "infeasible_count",
                 "gating_dropped_count"):
        np.testing.assert_array_equal(getattr(outs, name),
                                      np.asarray(getattr(jouts, name)))


# Configurations whose states hold every kind of leaf: the plain state,
# the unicycle headings, the Verlet cache, the warm ADMM carry, RTA's.
DIGEST_CASES = {
    "plain": dict(n=16),
    "unicycle": dict(n=16, dynamics="unicycle"),
    "verlet": dict(n=16, gating_rebuild_skin=0.1),
    "warm certificate": dict(n=16, certificate=True,
                             certificate_backend="sparse",
                             certificate_warm_start=True),
    "rta": dict(n=16, rta=True),
}


@pytest.mark.parametrize("case", sorted(DIGEST_CASES))
def test_leaf_digests_and_manifest_equal_jax(case, tmp_path):
    """A float32 state carried across from JAX's digests to JAX's manifest:
    the same keys, shapes, dtypes and SHA-256 for every leaf, and the
    same manifest JSON; the port's committed manifest is that JSON."""
    jstate, _ = jsw.make(jsw.Config(**DIGEST_CASES[case]))
    state = convert.state_from_reference(jstate, device="cpu",
                                         dtype=torch.float32)
    want = jint.leaf_digests(jstate)
    assert tint.leaf_digests(state) == want
    assert tint.manifest_json(7, tint.leaf_digests(state)) == \
        jint.manifest_json(7, want)
    ckpt.save(str(tmp_path), 7, state)
    assert tint.read_manifest(str(tmp_path), 7)["leaves"] == want
    if case == "warm certificate":
        assert "certificate_solver_state/[0]" in want
        assert "certificate_solver_state/1" in want


def test_resume_preserves_certificate_warm_state(tmp_path):
    """The warm ADMM carry survives a checkpoint and resume bit for bit:
    the resumed tail's state and iteration counts equal the unbroken
    run's (a silent cold start would shift the counts)."""
    cfg = tsw.Config(n=64, steps=12, certificate=True,
                     certificate_backend="sparse",
                     certificate_warm_start=True, certificate_tol=1e-5,
                     spawn_half_width_override=0.8)
    state0, step = tsw.make(cfg, device="cpu")
    d = str(tmp_path / "ckpt")
    ref_final, ref_outs, _ = teng.rollout_chunked(step, state0, cfg.steps,
                                                  chunk=4)
    mid, _, _ = teng.rollout_chunked(step, state0, 8, chunk=4,
                                     checkpoint_dir=d)
    assert ckpt.latest_step(d) == 8
    assert any(float(a.abs().max()) > 0
               for a in mid.certificate_solver_state)
    final, outs, start = teng.rollout_chunked(step, state0, cfg.steps,
                                              chunk=4, checkpoint_dir=d)
    assert start == 8
    _same(final, ref_final)
    np.testing.assert_array_equal(outs.certificate_iterations,
                                  ref_outs.certificate_iterations[8:])


def test_corrupt_newest_step_walked_back(scenario, tmp_path):
    cfg, state0, step = scenario
    d = str(tmp_path / "ckpt")
    teng.rollout_chunked(step, state0, 8, chunk=4, checkpoint_dir=d)
    assert ckpt.latest_step(d) == 8
    _damage_step(d, 8)
    restored, found, skipped = ckpt.restore_intact(d, state0)
    assert found == 4 and skipped == [8]
    clean, _, _ = teng.rollout_chunked(step, state0, 4, chunk=4)
    _same(restored, clean)
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore(d, state0, step=8)


def test_hand_truncated_step_fails_closed(scenario, tmp_path):
    """Every file of a step truncated to 0 bytes, the manifest removed: the
    restore refuses with CheckpointCorrupt, and the walk back over
    nothing but damaged steps raises too — never fabricated state."""
    cfg, state0, step = scenario
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 4, state0)
    os.remove(os.path.join(d, "4", "integrity.json"))
    for dirpath, _, files in os.walk(os.path.join(d, "4")):
        for name in files:
            with open(os.path.join(dirpath, name), "w"):
                pass
    with pytest.raises(ckpt.CheckpointCorrupt, match="refusing"):
        ckpt.restore(d, state0, step=4)
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore(d, state0)


def test_template_and_digest_mismatches_are_corrupt(scenario, tmp_path):
    """A template of another shape, or a payload rewritten under a
    committed manifest (loadable, other bytes), is CheckpointCorrupt; a
    step saved without a manifest restores (nothing to verify)."""
    cfg, state0, step = scenario
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 3, state0)
    bad_like = tsw.State(x=torch.zeros(9, 2), v=torch.zeros(9, 2))
    with pytest.raises(ckpt.CheckpointCorrupt, match="template"):
        ckpt.restore(d, bad_like, step=3)
    path = os.path.join(d, "3", ckpt.DATA_NAME)
    payload = torch.load(path, weights_only=True)
    payload["x"] = payload["x"] + 1.0
    torch.save(payload, path)
    with pytest.raises(ckpt.CheckpointCorrupt, match="integrity"):
        ckpt.restore(d, state0, step=3)
    os.remove(os.path.join(d, "3", "integrity.json"))
    restored, _ = ckpt.restore(d, state0, step=3)
    assert torch.equal(restored.x, state0.x + 1.0)


def test_durable_resume_skips_corrupt_newest_bit_exact(scenario, tmp_path):
    import json

    cfg, state0, step = scenario
    d = str(tmp_path / "run")
    tdr.run_durable(d, scenario="swarm", cfg=cfg, chunk=4, device="cpu")
    ckpt_dir = os.path.join(d, "ckpt")
    committed = sorted(int(s) for s in os.listdir(ckpt_dir) if s.isdigit())
    assert committed == [8, 12]
    _damage_step(ckpt_dir, committed[-1])
    out = tdr.resume(d, device="cpu")
    assert out["resumed_from_step"] == committed[-2]
    assert out["corrupt_skipped"] == [committed[-1]]
    with open(os.path.join(d, "resume_log.jsonl")) as fh:
        entry = [json.loads(line) for line in fh][-1]
    assert entry["corrupt_skipped"] == [committed[-1]]
    ref_final, _ = teng.rollout(step, state0, cfg.steps)
    _same(out["final_state"], ref_final)
    for s in (s for s in os.listdir(ckpt_dir) if s.isdigit()):
        _damage_step(ckpt_dir, int(s))
    with pytest.raises(ckpt.CheckpointCorrupt):
        tdr.resume(d, device="cpu")
    shutil.rmtree(d)
