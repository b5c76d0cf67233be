"""Host-side RTA auditor (counterpart: cbf_tpu/rta/monitor.py): the
recorded ``StepOutputs.rta_mode`` series -> ``rta.engage`` /
``rta.recover`` events and registry counters.

``emit_rta_events`` takes any object with ``.event(type, payload)`` and
an optional ``.registry`` (with ``.counter(name).add(n)``), so it needs
no telemetry module of its own."""

from __future__ import annotations

from typing import Any

import numpy as np

#: Event types this module emits.
EMITTED_EVENT_TYPES = ("rta.engage", "rta.recover")


def _series(rta_mode) -> np.ndarray:
    """The series as a flat numpy array (a tensor is copied to the host)."""
    if hasattr(rta_mode, "detach"):
        rta_mode = rta_mode.detach().cpu().numpy()
    return np.asarray(rta_mode).reshape(-1)


def rta_transitions(rta_mode) -> list[dict[str, Any]]:
    """Decode a recorded ``(steps,)`` rta_mode series into transition
    records: one ``rta.engage`` per rung rise (step, rung, prev_rung) and
    one ``rta.recover`` per return to nominal (step, peak_rung,
    engaged_steps). A disabled channel (``()``) or an empty series yields
    none."""
    if isinstance(rta_mode, tuple):
        return []
    out: list[dict[str, Any]] = []
    prev = 0
    peak = 0
    engaged_at = 0
    for step, mode in enumerate(int(m) for m in _series(rta_mode)):
        if mode > prev:
            if prev == 0:
                engaged_at = step
            out.append({"type": "rta.engage", "step": step,
                        "rung": mode, "prev_rung": prev})
            peak = max(peak, mode)
        elif mode == 0 and prev > 0:
            out.append({"type": "rta.recover", "step": step,
                        "peak_rung": peak,
                        "engaged_steps": step - engaged_at})
            peak = 0
        prev = mode
    return out


def emit_rta_events(telemetry, rta_mode, *, step_offset: int = 0
                    ) -> dict[str, Any]:
    """Emit the series' transitions through ``telemetry`` (any object
    with ``.event``; None only skips emission) and bump its registry's
    counters where it has one. Returns a summary dict: ``engagements``,
    ``recoveries``, ``peak_rung``, ``engaged_steps``. ``step_offset``
    shifts recorded step indices into a global frame."""
    transitions = rta_transitions(rta_mode)
    registry = getattr(telemetry, "registry", None)
    engagements = 0
    recoveries = 0
    for tr in transitions:
        payload = {k: v for k, v in tr.items() if k != "type"}
        payload["step"] = payload["step"] + step_offset
        if tr["type"] == "rta.engage":
            engagements += 1
            if telemetry is not None:
                telemetry.event("rta.engage", payload)
            if registry is not None:
                registry.counter("rta_engagements").add(1)
                registry.counter(f"rta_rung_{tr['rung']}").add(1)
        else:
            recoveries += 1
            if telemetry is not None:
                telemetry.event("rta.recover", payload)
            if registry is not None:
                registry.counter("rta_recoveries").add(1)
    series = (np.zeros(0, np.int32) if isinstance(rta_mode, tuple)
              else _series(rta_mode))
    peak = int(series.max()) if series.size else 0
    return {"engagements": engagements, "recoveries": recoveries,
            "peak_rung": peak, "engaged_steps": int((series > 0).sum())}
