"""Replayable violation corpus (counterpart: cbf_tpu/verify/corpus.py):
schema-versioned JSONL of minimized counterexamples, the same schema as
the JAX package's ``corpus/violations.jsonl``, and the replay gate over
it.

``replay_entry`` rebuilds an entry's rollout in float64 and recomputes its
margins; ``check_replay`` turns (entry, replay) into problems: a
``violates`` entry must still violate and reproduce its recorded float64
margin exactly (the JAX package's bit-replay contract — a port replays a
different program, so callers comparing packages hold the margins by a
stated tolerance and keep the verdict exact), a ``safe`` entry must not
violate.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from cbf_tpu_torch.verify.properties import PROPERTY_NAMES, PropertyThresholds
from cbf_tpu_torch.verify.search import (SearchSettings, make_adapter,
                                         make_eval_one)
from cbf_tpu_torch.verify.shrink import ShrinkResult

CORPUS_SCHEMA_VERSION = 1
CORPUS_FILENAME = "violations.jsonl"


def _config_cls(scenario: str):
    import importlib

    return importlib.import_module(
        f"cbf_tpu_torch.scenarios.{scenario}").Config


def config_overrides(cfg) -> dict:
    """JSON-able dict of ``cfg``'s non-default fields; ``dtype`` dropped
    (replay always runs float64)."""
    out = {}
    for f in dataclasses.fields(cfg):
        if f.name == "dtype":
            continue
        v = getattr(cfg, f.name)
        d = f.default
        if isinstance(v, tuple):
            v = list(v)
            d = list(d) if isinstance(d, tuple) else d
        if v != d:
            out[f.name] = v
    return out


def rebuild_config(scenario: str, overrides: dict):
    cls = _config_cls(scenario)
    fixed = {}
    for f in dataclasses.fields(cls):
        if f.name in overrides:
            v = overrides[f.name]
            if isinstance(f.default, tuple) and isinstance(v, list):
                v = tuple(v)
            fixed[f.name] = v
    unknown = set(overrides) - set(fixed)
    if unknown:
        raise ValueError(
            f"corpus entry overrides name unknown {scenario} Config "
            f"fields {sorted(unknown)} — schema drift; bump the entry or "
            "the config")
    return cls(**fixed)


def _thresholds_dict(th: PropertyThresholds) -> dict:
    return {f.name: getattr(th, f.name)
            for f in dataclasses.fields(th)
            if getattr(th, f.name) != f.default}


def _git_sha() -> str | None:
    """HEAD of the checkout this package lives in, or None."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                             capture_output=True, text=True, timeout=10,
                             check=False)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def _cbf_dict(cbf):
    return None if cbf is None else {k: float(v) for k, v in
                                     cbf._asdict().items()}


def entry_from(scenario: str, cfg, result: ShrinkResult, *, engine: str,
               settings: SearchSettings, cbf=None,
               thresholds: PropertyThresholds | None = None,
               expect: str = "violates") -> dict:
    """One archive entry from a shrunk counterexample."""
    if expect not in ("violates", "safe"):
        raise ValueError(f"expect must be violates|safe, got {expect!r}")
    return {
        "schema": CORPUS_SCHEMA_VERSION,
        "scenario": scenario,
        "overrides": config_overrides(cfg),
        "cbf": _cbf_dict(cbf),
        "thresholds": (_thresholds_dict(thresholds)
                       if thresholds is not None else {}),
        "seed": int(settings.seed),
        "perturb_norm": float(settings.perturb_norm),
        "engine": engine,
        "property": result.property,
        "delta": np.asarray(result.delta, np.float64).tolist(),
        "scale": float(result.scale),
        "steps": int(result.steps),
        "earliest_step": result.earliest_step,
        "margin": float(result.margin),
        "margin_x64": float(result.margin_x64),
        "confirmed_x64": bool(result.confirmed_x64),
        "expect": expect,
        "git_sha": _git_sha(),
        "created": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }


def near_miss_entry(scenario: str, cfg, delta, *, engine: str,
                    settings: SearchSettings, property: str,
                    margin: float, margin_x64: float, steps: int,
                    cbf=None,
                    thresholds: PropertyThresholds | None = None) -> dict:
    """One ``expect="safe"`` archive entry from a low-margin survivor."""
    if not np.isfinite(margin_x64) or margin_x64 < 0:
        raise ValueError(
            f"near_miss_entry is for survivors: margin_x64 "
            f"{margin_x64!r} must be finite and >= 0 (a violator "
            "belongs in entry_from via shrink)")
    return {
        "schema": CORPUS_SCHEMA_VERSION,
        "scenario": scenario,
        "overrides": config_overrides(cfg),
        "cbf": _cbf_dict(cbf),
        "thresholds": (_thresholds_dict(thresholds)
                       if thresholds is not None else {}),
        "seed": int(settings.seed),
        "perturb_norm": float(settings.perturb_norm),
        "engine": engine,
        "property": property,
        "delta": np.asarray(delta, np.float64).tolist(),
        "scale": 1.0,
        "steps": int(steps),
        "earliest_step": None,
        "margin": float(margin),
        "margin_x64": float(margin_x64),
        "confirmed_x64": False,
        "expect": "safe",
        "git_sha": _git_sha(),
        "created": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }


def corpus_path(dir_or_file: str) -> str:
    if os.path.isdir(dir_or_file) or not dir_or_file.endswith(".jsonl"):
        return os.path.join(dir_or_file, CORPUS_FILENAME)
    return dir_or_file


def append_entry(dir_or_file: str, entry: dict) -> str:
    """Append one entry (one JSON line); returns the path written."""
    path = corpus_path(dir_or_file)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(entry) + "\n")
    return path


def load_entries(dir_or_file: str) -> list[dict]:
    """Every entry; a malformed line or an unknown schema raises."""
    path = corpus_path(dir_or_file)
    entries = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            entry = json.loads(line)
            if entry.get("schema") != CORPUS_SCHEMA_VERSION:
                raise ValueError(
                    f"{path}:{i + 1}: corpus schema "
                    f"{entry.get('schema')!r} != supported "
                    f"{CORPUS_SCHEMA_VERSION}")
            entries.append(entry)
    return entries


def _rebuild_cbf(entry: dict):
    if entry.get("cbf") is None:
        return None
    from cbf_tpu_torch.core.filter import CBFParams

    return CBFParams(**entry["cbf"])


def _rebuild_thresholds(entry: dict) -> PropertyThresholds:
    return dataclasses.replace(PropertyThresholds(),
                               **entry.get("thresholds", {}))


def replay_entry(entry: dict, *, device=None) -> dict:
    """Rebuild the entry's rollout in float64 on ``device`` (None = the
    card) and recompute every margin. Returns ``{"margin", "margins",
    "violation", "property"}``."""
    scenario = entry["scenario"]
    cfg = rebuild_config(scenario, entry["overrides"])
    settings = SearchSettings(seed=int(entry.get("seed", 0)),
                              perturb_norm=float(entry["perturb_norm"]))
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    adapter = make_adapter(scenario, cfg64, cbf=_rebuild_cbf(entry),
                           thresholds=_rebuild_thresholds(entry),
                           steps=int(entry["steps"]), device=device)
    delta = torch.as_tensor(np.asarray(entry["delta"], np.float64))
    with torch.no_grad():
        margins = make_eval_one(adapter, settings)(delta)
    margins = margins.cpu().numpy().astype(np.float64)
    pi = PROPERTY_NAMES.index(entry["property"])
    return {
        "margin": float(margins[pi]),
        "margins": {n: float(v) for n, v in zip(PROPERTY_NAMES, margins)},
        "violation": bool(margins[pi] < 0),
        "property": entry["property"],
    }


def check_replay(entry: dict, replay: dict) -> list[str]:
    """Problems with one replayed entry (empty = the gate passes): the
    JAX package's rule, exact margin included."""
    problems = []
    expect = entry.get("expect", "violates")
    if expect == "violates":
        if not replay["violation"]:
            problems.append(
                f"{entry['scenario']}/{entry['property']}: archived "
                f"violation no longer reproduces (margin "
                f"{replay['margin']:.9g} >= 0) — the detection machinery "
                "or the dynamics changed out from under the corpus")
        if replay["margin"] != entry["margin_x64"]:
            problems.append(
                f"{entry['scenario']}/{entry['property']}: x64 replay "
                f"margin {replay['margin']!r} != recorded "
                f"{entry['margin_x64']!r} — the run is no longer "
                "bit-replayable from its corpus record")
    elif replay["violation"]:
        problems.append(
            f"{entry['scenario']}/{entry['property']}: 'safe' entry now "
            f"VIOLATES (margin {replay['margin']:.9g} < 0) — a change "
            "reintroduced a known violation into the certified default "
            "config")
    return problems


def check_verdict(entry: dict, replay: dict) -> list[str]:
    """The verdict half of :func:`check_replay` alone: a ``violates``
    entry still violates, a ``safe`` one does not."""
    want = entry.get("expect", "violates") == "violates"
    if replay["violation"] == want:
        return []
    return [f"{entry['scenario']}/{entry['property']}: expect "
            f"{entry.get('expect', 'violates')!r} but the replay margin "
            f"is {replay['margin']!r}"]


def replay_corpus(dir_or_file: str, *, device=None
                  ) -> list[tuple[dict, dict, list[str]]]:
    """Replay every entry: (entry, replay, problems) triples. An empty
    corpus is an error."""
    entries = load_entries(dir_or_file)
    if not entries:
        raise ValueError(f"{corpus_path(dir_or_file)}: empty corpus — "
                         "the replay gate would vacuously pass")
    out = []
    for entry in entries:
        replay = replay_entry(entry, device=device)
        out.append((entry, replay, check_replay(entry, replay)))
    return out
