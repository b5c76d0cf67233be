"""The port's CLI (``python -m cbf_tpu_torch``: ``run`` and ``list``),
in process on the CPU, against the JAX package's ``run`` (``--platform
cpu``): the same record keys (and config fields), values to the scenario
tolerance (float32: distances atol 1e-5, counts exact). The durable,
checked, telemetry and profiling options each run and leave their
artefact."""

import json

import numpy as np
import pytest
import torch

from cbf_tpu.__main__ import main as jax_main
from cbf_tpu_torch.__main__ import main
from cbf_tpu_torch.native import trajsink

CPU = ["--device", "cpu"]
SCENARIOS = ("antipodal", "cross_and_rescue", "meet_at_center", "swarm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _record(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_list(capsys):
    assert main(["list"]) == 0
    out = capsys.readouterr().out
    names = [line.split()[0] for line in out.splitlines()
             if line and not line.startswith(" ")]
    assert names == list(SCENARIOS)
    assert jax_main(["list"]) == 0
    jax_names = [line.split()[0] for line in capsys.readouterr().out
                 .splitlines() if line and not line.startswith(" ")]
    assert names == jax_names


def test_run_record_matches_jax(capsys):
    assert main(["run", "meet_at_center", "--steps", "20"] + CPU) == 0
    rec = _record(capsys)
    assert jax_main(["run", "meet_at_center", "--steps", "20",
                     "--platform", "cpu"]) == 0
    want = _record(capsys)
    assert rec.keys() == want.keys()
    assert rec["config"].keys() == want["config"].keys()
    for key, value in want["config"].items():
        if key != "dtype":
            assert rec["config"][key] == value, key
    for key, value in want.items():
        if key == "config":
            continue
        if isinstance(value, float):
            assert rec[key] == pytest.approx(value, abs=1e-5), key
        else:
            assert rec[key] == value, key


@pytest.mark.parametrize("scenario,extra", [
    ("antipodal", ["--steps", "4", "--set", "n=12"]),
    ("cross_and_rescue", ["--steps", "3", "--set", "dtype=float64"]),
    ("swarm", ["--steps", "5", "--set", "n=16", "--set", "k_neighbors=4",
               "--set", "certificate_pairs=none"]),
])
def test_run_outputs(scenario, extra, tmp_path, capsys):
    """Each scenario runs on the CPU; --traj streams the recorded
    positions through the native sink (agent-major on disk), --video
    writes a gif."""
    cbt, gif = str(tmp_path / "t.cbt"), str(tmp_path / "v.gif")
    assert main(["run", scenario, "--traj", cbt, "--video", gif]
                + extra + CPU) == 0
    rec = _record(capsys)
    assert open(gif, "rb").read()[:3] == b"GIF"
    assert rec["video"] == gif and rec["infeasible_agent_steps"] == 0
    steps = int(extra[1])
    n = {"antipodal": 12, "cross_and_rescue": 4, "swarm": 16}[scenario]
    if trajsink.available():
        assert rec["traj"] == cbt
        traj = trajsink.read_trajectory(cbt)
    else:
        assert rec["traj"] == cbt + ".npy"
        traj = np.load(cbt + ".npy")
    assert traj.shape == (steps, n, 2) and np.all(np.isfinite(traj))
    if scenario == "cross_and_rescue":
        assert rec["config"]["dtype"] == "torch.float64"
        assert rec["max_certificate_residual"] < 1e-3
    if scenario == "swarm":
        assert "knn_dropped_neighbor_steps" in rec


@pytest.mark.parametrize("flag", [
    ["--checkpoint-dir", "ck"], ["--durable-dir", "d"], ["--resume", "d"],
    ["--checked"], ["--telemetry-dir", "t"], ["--profile-dir", "p"],
    ["--stall-timeout", "1"]])
def test_out_of_slice_flags_raise(flag, tmp_path, monkeypatch, capsys):
    """Each durability and observability flag of ``run`` (all raised until
    Queue A9) runs on the CPU and leaves its artefact: a committed
    manifest, a durable run directory, a resumed run, a clean check, a
    heartbeat stream, a trace with the step's spans, a watchdog."""
    import os

    monkeypatch.chdir(tmp_path)
    base = ["run", "swarm", "--steps", "4", "--set", "n=8"] + CPU
    if flag[0] == "--resume":
        assert main(base + ["--durable-dir", "d", "--chunk", "2"]) == 0
        first = _record(capsys)
        import shutil
        shutil.rmtree(os.path.join("d", "ckpt", "4"))
    extra = ["--telemetry-dir", "w"] if flag[0] == "--stall-timeout" else []
    assert main(base + flag + extra) == 0
    rec = _record(capsys)
    if flag[0] == "--checkpoint-dir":
        assert os.path.isfile(os.path.join("ck", "4", "integrity.json"))
    elif flag[0] == "--durable-dir":
        assert rec["resumed_from_step"] == 0 and rec["steps"] == 4
        assert os.path.isfile(os.path.join("d", "run.json"))
    elif flag[0] == "--resume":
        assert rec["resumed_from_step"] == 2
        assert rec["min_pairwise_distance"] == first["min_pairwise_distance"]
    elif flag[0] == "--checked":
        assert rec["steps"] == 4 and np.isfinite(rec["min_pairwise_distance"])
    elif flag[0] == "--telemetry-dir":
        assert rec["telemetry_heartbeats"] == 1
        assert os.path.isfile(os.path.join("t", "events.jsonl"))
    elif flag[0] == "--profile-dir":
        with open(os.path.join("p", "trace.json")) as fh:
            trace = fh.read()
        assert all(span in trace for span in ("consensus", "gating",
                                              "filter", "integrate"))
    else:
        assert rec["telemetry_alerts"] == []


def test_bad_input(capsys):
    with pytest.raises(SystemExit):
        main(["run", "swarm", "--set", "bogus=1"] + CPU)
    with pytest.raises(SystemExit):
        main(["run", "swarm", "--set", "dtype=float7"] + CPU)
    with pytest.raises(SystemExit):
        main(["run", "meet_at_center", "--rta"] + CPU)
    assert main(["run"] + CPU) == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["run", "antipodal", "--steps", "2"])
