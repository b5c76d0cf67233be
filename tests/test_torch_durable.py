"""The port's durable rollout runs (cbf_tpu_torch.durable.rollout) and
process-level fault injectors on the CPU, against the rollout half of
tests/test_durable.py and the JAX package's run spec and kill schedule.

Held here: a durable run's stitched outputs are byte-identical to the
plain rollout and a resume of a complete directory is a pure restore;
mixed runs are refused; a ``python -m cbf_tpu_torch run ... --device cpu
--durable-dir`` SIGKILLed once its first checkpoint is committed resumes
from a step > 0 to outputs and a final state byte-identical to an
uninterrupted run (N=256, 400 steps, one torch thread); ``config_to_json``
equals JAX's for the same Config and a JAX spec's config gives the port's
Config; ``kill_schedule`` draws JAX's times for the same seed; the other
process injectors stop, resume and wait as JAX's do.
"""

import glob
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.durable import rollout as jdr
from cbf_tpu.scenarios import antipodal as jap
from cbf_tpu.scenarios import cross_and_rescue as jcar
from cbf_tpu.scenarios import meet_at_center as jmac
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.utils import faults as jfaults
from cbf_tpu_torch.durable import rollout as dr
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.scenarios import antipodal as tap
from cbf_tpu_torch.scenarios import cross_and_rescue as tcar
from cbf_tpu_torch.scenarios import meet_at_center as tmac
from cbf_tpu_torch.scenarios import swarm as tsw
from cbf_tpu_torch.utils import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaves_equal(a, b):
    """Trees of tensors or numpy arrays: equal byte for byte."""
    la = [np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
          for _, v in dr.integrity.tree_items(a)]
    lb = [np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
          for _, v in dr.integrity.tree_items(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_run_durable_matches_plain_and_resumes_complete(tmp_path):
    cfg = tsw.Config(n=16, steps=24, gating="jnp")
    d = str(tmp_path / "run")
    out = dr.run_durable(d, scenario="swarm", cfg=cfg, chunk=8,
                         device="cpu")
    assert out["steps"] == 24 and out["resumed_from_step"] == 0
    assert out["corrupt_skipped"] == []
    state0, step = tsw.make(cfg, device="cpu")
    ref_final, ref_outs = teng.rollout(step, state0, cfg.steps)
    _leaves_equal(out["outputs"], ref_outs)
    _leaves_equal(out["final_state"], ref_final)
    spec = dr.load_spec(d)
    assert spec["scenario"] == "swarm" and spec["steps"] == 24
    out2 = dr.resume(d, device="cpu")
    assert out2["resumed_from_step"] == 24
    _leaves_equal(out2["outputs"], out["outputs"])
    _leaves_equal(out2["final_state"], out["final_state"])


def test_run_durable_refuses_mixed_runs(tmp_path):
    d = str(tmp_path / "run")
    dr.run_durable(d, scenario="swarm",
                   cfg=tsw.Config(n=8, steps=8, gating="jnp"), chunk=4,
                   device="cpu")
    with pytest.raises(ValueError, match="different config"):
        dr.run_durable(d, scenario="swarm",
                       cfg=tsw.Config(n=16, steps=8, gating="jnp"),
                       device="cpu")
    with pytest.raises(ValueError, match="scenario"):
        dr.run_durable(d, scenario="antipodal", device="cpu")
    with pytest.raises(FileNotFoundError):
        dr.resume(str(tmp_path / "nowhere"), device="cpu")


def test_sigkill_midrun_resume_bit_exact(tmp_path):
    """SIGKILL the CLI once its first checkpoint is committed (the
    manifest is the commit marker), resume from the directory alone, and
    require byte-identical outputs and final state against an
    uninterrupted run of the same spec."""
    steps, chunk = 400, 50
    cfg = tsw.Config(n=256, steps=steps, gating="jnp")
    ref = dr.run_durable(str(tmp_path / "ref"), scenario="swarm", cfg=cfg,
                         chunk=chunk, device="cpu")
    kill_dir = str(tmp_path / "kill")
    argv = [sys.executable, "-m", "cbf_tpu_torch", "run", "swarm",
            "--durable-dir", kill_dir, "--device", "cpu", "--set", "n=256",
            "--set", "gating=jnp", "--steps", str(steps), "--chunk",
            str(chunk)]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))

    def first_commit_on_disk(_elapsed):
        return bool(glob.glob(os.path.join(kill_dir, "ckpt", "*",
                                           "integrity.json")))

    rc, killed, _ = faults.run_process_until(
        argv, first_commit_on_disk, poll_s=0.01, timeout_s=300.0, env=env)
    assert killed, f"process finished (rc={rc}) before the kill armed"
    res = dr.resume(kill_dir, device="cpu")
    assert 0 < res["resumed_from_step"] < steps
    _leaves_equal(res["outputs"], ref["outputs"])
    _leaves_equal(res["final_state"], ref["final_state"])
    with open(os.path.join(kill_dir, dr.RESUME_LOG_NAME)) as fh:
        entries = [json.loads(line) for line in fh]
    assert entries and entries[-1]["resumed_from_step"] > 0
    assert entries[-1]["recovery_s"] > 0


CONFIGS = {
    "swarm": (jsw.Config(), tsw.Config()),
    "swarm f64": (jsw.Config(n=64, dtype=jnp.float64, relax_cap=None,
                             certificate=True),
                  tsw.Config(n=64, dtype=torch.float64, relax_cap=None,
                             certificate=True)),
    "meet_at_center": (jmac.Config(), tmac.Config()),
    "cross_and_rescue": (jcar.Config(), tcar.Config()),
    "antipodal": (jap.Config(), tap.Config()),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_to_json_equals_jax(name):
    """The run spec's config is JAX's for the same Config, and a JAX
    spec's config gives the port's Config back."""
    jcfg, tcfg = CONFIGS[name]
    want = jdr.config_to_json(jcfg)
    assert dr.config_to_json(tcfg) == want
    assert dr.config_from_json(type(tcfg), json.loads(json.dumps(want))) \
        == tcfg


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_kill_schedule_equals_jax(seed):
    assert faults.kill_schedule(seed, 5, 0.5, 4.0) == \
        jfaults.kill_schedule(seed, 5, 0.5, 4.0)


def test_process_injectors(tmp_path):
    """run_until_killed kills a sleeper, a fast process finishes first,
    pause_after stops one and resume lets it finish, wait_for_file sees
    a file appear or times out."""
    sleeper = [sys.executable, "-c", "import time; time.sleep(30)"]
    rc, killed, elapsed = faults.run_until_killed(sleeper, 0.2, poll_s=0.02)
    assert killed and rc == -9 and elapsed < 10
    rc, killed, _ = faults.run_until_killed(
        [sys.executable, "-c", "pass"], 60.0, poll_s=0.02)
    assert rc == 0 and not killed
    flag = str(tmp_path / "ready")
    proc = faults.pause_after(
        [sys.executable, "-c",
         f"import time; time.sleep(0.3); open({flag!r}, 'w').close()"],
        0.05)
    assert proc.poll() is None
    assert not faults.wait_for_file(flag, timeout_s=0.6, poll_s=0.02)
    faults.resume(proc)
    assert faults.wait_for_file(flag, timeout_s=30.0, poll_s=0.02)
    assert proc.wait(timeout=30) == 0
    faults.resume(proc)                      # exited: a no-op
