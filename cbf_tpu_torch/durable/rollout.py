"""Durable rollout runs: kill a chunked rollout at any moment, resume it
bit-exactly (counterpart: cbf_tpu/durable/rollout.py).

A durable run directory holds everything needed to go on after the
process dies:

- ``run.json`` — the run spec (scenario name, the full config as typed
  JSON, steps, chunk, telemetry cadence), written once, atomically;
  :func:`resume` rebuilds the step and the initial state from it;
- ``ckpt/`` — integrity-checked checkpoints at every chunk boundary
  (:mod:`cbf_tpu_torch.utils.checkpoint`): the carried state, the
  solver's warm carry included;
- ``outputs/chunk_<t0>.npz`` — each chunk's host StepOutputs, committed
  atomically before the boundary checkpoint (``rollout_chunked``'s
  ``durable_hook``), so an intact checkpoint at step t implies every
  output up to t is on disk;
- ``cursor.json`` — the progress cursor (next chunk start, the telemetry
  cadence);
- ``resume_log.jsonl`` — one line per resume: the restored step, the
  measured in-process recovery time (MTTR) and the corrupt steps skipped.

Completed chunks are never run again — their bytes are stitched as stored
— and the rest run from the restored carry through the same programs, so
a killed-and-resumed run's stitched outputs are byte-identical to the
uninterrupted run's. The device is a run-time argument, not part of the
spec.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import time

import numpy as np
import torch

from cbf_tpu_torch.durable import integrity

EMITTED_EVENT_TYPES = ("durable.resume",)

SPEC_SCHEMA_VERSION = 1
SPEC_NAME = "run.json"
CURSOR_NAME = "cursor.json"
RESUME_LOG_NAME = "resume_log.jsonl"
OUTPUTS_DIR = "outputs"
CKPT_DIR = "ckpt"


# ---------------------------------------------------------- run spec ----


def config_to_json(cfg) -> dict:
    """A scenario config as typed JSON, as the JAX package writes it: the
    ``dtype`` by its numpy name (``"float32"``), tuples as lists."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, torch.dtype):
            v = str(v).removeprefix("torch.")
        elif isinstance(v, tuple):
            v = list(v)
        out[f.name] = v
    return out


def config_from_json(config_cls, data: dict):
    """Invert :func:`config_to_json` against ``config_cls``'s defaults (a
    JAX ``run.json``'s config gives the port's Config)."""
    default = config_cls()
    updates = {}
    for f in dataclasses.fields(default):
        if f.name not in data:
            continue
        v = data[f.name]
        cur = getattr(default, f.name)
        if isinstance(cur, torch.dtype) and isinstance(v, str):
            v = getattr(torch, v)
        elif isinstance(cur, tuple) and isinstance(v, list):
            v = tuple(v)
        updates[f.name] = v
    return dataclasses.replace(default, **updates)


def _scenario(name: str):
    module = importlib.import_module(f"cbf_tpu_torch.scenarios.{name}")
    steps_field = "iterations" if hasattr(module.Config(), "iterations") \
        else "steps"
    return module, steps_field


def load_spec(directory: str) -> dict:
    path = os.path.join(directory, SPEC_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no durable run spec at {path}")
    with open(path) as fh:
        spec = json.load(fh)
    if spec.get("schema") != SPEC_SCHEMA_VERSION:
        raise ValueError(f"durable run spec schema {spec.get('schema')} != "
                         f"{SPEC_SCHEMA_VERSION} at {path}")
    return spec


def _write_spec(directory: str, scenario: str, cfg, *, steps_field: str,
                chunk: int, telemetry_every: int) -> dict:
    spec = {
        "schema": SPEC_SCHEMA_VERSION,
        "scenario": scenario,
        "config": config_to_json(cfg),
        "steps_field": steps_field,
        "steps": int(getattr(cfg, steps_field)),
        "chunk": int(chunk),
        "telemetry_every": int(telemetry_every),
    }
    integrity.write_atomic(os.path.join(directory, SPEC_NAME),
                           json.dumps(spec, sort_keys=True))
    return spec


# ------------------------------------------------------ chunk storage ----


def _chunk_path(directory: str, t0: int) -> str:
    return os.path.join(directory, OUTPUTS_DIR, f"chunk_{t0:010d}.npz")


def _save_chunk(directory: str, t0: int, t1: int, outs_host) -> None:
    """Persist one chunk's StepOutputs atomically: the leaves in tree
    order with their keys, so untracked ``()`` fields and tuple
    trajectories round-trip."""
    items = list(integrity.tree_items(outs_host))
    payload = {f"leaf_{i}": np.asarray(v) for i, (_, v) in enumerate(items)}
    integrity.write_npz_atomic(
        _chunk_path(directory, t0),
        {"t0": np.int64(t0), "t1": np.int64(t1),
         "keys": np.array([k for k, _ in items]), **payload})


def _outputs_from_keys(keys, leaves):
    """StepOutputs from :func:`_save_chunk`'s keys and leaves."""
    from cbf_tpu_torch.rollout.engine import StepOutputs

    fields: dict = dict.fromkeys(StepOutputs._fields, ())
    for key, leaf in zip(keys, leaves):
        name, _, sub = key.partition("/")
        if sub:
            fields[name] = [*fields[name], leaf]
        else:
            fields[name] = leaf
    return StepOutputs(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in fields.items()})


def _chunk_files(directory: str) -> dict[int, str]:
    d = os.path.join(directory, OUTPUTS_DIR)
    if not os.path.isdir(d):
        return {}
    return {int(name[len("chunk_"):-len(".npz")]): os.path.join(d, name)
            for name in os.listdir(d)
            if name.startswith("chunk_") and name.endswith(".npz")}


def _stitch_outputs(directory: str, steps: int):
    """Load every persisted chunk, check contiguous coverage of
    ``[0, steps)``, and concatenate along the time axis."""
    from cbf_tpu_torch.rollout.engine import stack_host_chunks

    files = _chunk_files(directory)
    parts = []
    expect = 0
    for t0 in sorted(files):
        if t0 != expect:
            raise ValueError(
                f"durable run under {directory} has a chunk-output gap: "
                f"expected chunk at step {expect}, found {t0}")
        with np.load(files[t0]) as z:
            t1 = int(z["t1"])
            keys = [str(k) for k in z["keys"]]
            leaves = [z[f"leaf_{i}"] for i in range(len(keys))]
        parts.append(_outputs_from_keys(keys, leaves))
        expect = t1
        if expect >= steps:
            break
    if expect != steps:
        raise ValueError(
            f"durable run under {directory} is missing chunk outputs: "
            f"covered [0, {expect}) of [0, {steps})")
    return stack_host_chunks(parts, axis=0) if parts else None


# ------------------------------------------------------------ running ----


def _append_jsonl(path: str, record: dict) -> None:
    with open(path, "a") as fh:
        fh.write(json.dumps(record, sort_keys=True) + "\n")
        fh.flush()
        os.fsync(fh.fileno())


def run_durable(directory: str, *, scenario: str | None = None, cfg=None,
                chunk: int = 1000, telemetry=None, telemetry_every: int = 50,
                donate_carry: bool | None = None, device=None) -> dict:
    """Start — or continue — a durable rollout run on ``device`` (None =
    the card).

    First call: ``scenario`` and ``cfg`` are required and the run spec is
    committed to ``directory``. Later calls (after a SIGKILL too) may omit
    them; passing them again is allowed only if they match the spec (a
    changed config raises ValueError instead of mixing two runs).

    Returns ``{"final_state", "outputs", "steps", "resumed_from_step",
    "recovery_s", "corrupt_skipped"}``; ``outputs`` are the full stitched
    StepOutputs over ``[0, steps)`` as numpy arrays, byte-identical
    whether or not the run was ever interrupted."""
    from cbf_tpu_torch.rollout.engine import rollout_chunked
    from cbf_tpu_torch.utils import checkpoint as ckpt

    os.makedirs(directory, exist_ok=True)
    if os.path.exists(os.path.join(directory, SPEC_NAME)):
        spec = load_spec(directory)
        if scenario is not None and scenario != spec["scenario"]:
            raise ValueError(
                f"durable run under {directory} was started for scenario "
                f"{spec['scenario']!r}, not {scenario!r}")
        module, steps_field = _scenario(spec["scenario"])
        if cfg is not None and config_to_json(cfg) != spec["config"]:
            raise ValueError(
                f"durable run under {directory} was started with a "
                "different config; refusing to mix runs (use a fresh "
                "directory or omit the config to continue)")
        cfg = config_from_json(module.Config, spec["config"])
        scenario = spec["scenario"]
        chunk = spec["chunk"]
        telemetry_every = spec["telemetry_every"]
    else:
        if scenario is None or cfg is None:
            raise FileNotFoundError(
                f"no durable run spec under {directory} — pass scenario= "
                "and cfg= to start one")
        module, steps_field = _scenario(scenario)
        spec = _write_spec(directory, scenario, cfg, steps_field=steps_field,
                           chunk=chunk, telemetry_every=telemetry_every)
    steps = spec["steps"]
    state0, step_fn = module.make(cfg, device=device)

    # The recovery probe: restore, verify, scan — the measured MTTR.
    ckpt_dir = os.path.join(directory, CKPT_DIR)
    t_rec = time.perf_counter()
    start, skipped = 0, []
    if ckpt.latest_step(ckpt_dir) is not None:
        _, start, skipped = ckpt.restore_intact(ckpt_dir, state0)
        for s in skipped:
            # A corrupt step must not shadow the resumed run's re-save.
            shutil.rmtree(os.path.join(ckpt_dir, str(s)),
                          ignore_errors=True)
    for t0, path in _chunk_files(directory).items():
        if t0 >= start:
            # Progress past the last committed checkpoint (killed between
            # the output write and the checkpoint commit): run again.
            os.unlink(path)
    recovery_s = time.perf_counter() - t_rec
    if start > 0 or skipped:
        _append_jsonl(os.path.join(directory, RESUME_LOG_NAME), {
            "resumed_from_step": int(start),
            "recovery_s": recovery_s,
            "corrupt_skipped": [int(s) for s in skipped],
            "t_wall": time.time(),
        })
        if telemetry is not None:
            telemetry.event("durable.resume", {
                "directory": os.path.abspath(directory),
                "resumed_from_step": int(start),
                "chunks_loaded": len(_chunk_files(directory)),
                "steps": int(steps),
            })

    def durable_hook(t1, state, outs_host):
        first = next(integrity.tree_items(outs_host))[1]
        _save_chunk(directory, int(t1 - first.shape[0]), int(t1), outs_host)
        integrity.write_atomic(
            os.path.join(directory, CURSOR_NAME),
            json.dumps({"next_t0": int(t1), "steps": int(steps),
                        "telemetry_every": int(telemetry_every)},
                       sort_keys=True))

    final, _, start2 = rollout_chunked(
        step_fn, state0, steps, chunk=chunk, checkpoint_dir=ckpt_dir,
        resume=True, telemetry=telemetry, telemetry_every=telemetry_every,
        donate_carry=donate_carry, durable_hook=durable_hook)
    return {
        "final_state": final,
        "outputs": _stitch_outputs(directory, steps),
        "steps": int(steps),
        "resumed_from_step": int(start2),
        "recovery_s": recovery_s,
        "corrupt_skipped": [int(s) for s in skipped],
    }


def resume(directory: str, *, telemetry=None,
           donate_carry: bool | None = None, device=None) -> dict:
    """Continue a killed durable run from its directory alone. Raises
    FileNotFoundError when ``directory`` holds no run spec."""
    load_spec(directory)
    return run_durable(directory, telemetry=telemetry,
                       donate_carry=donate_carry, device=device)
