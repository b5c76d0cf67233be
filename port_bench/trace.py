"""The traced stretch: ``torch.profiler`` (CPU and CUDA activity) over a
short fixed run of steady steps, reduced to what the per-layer metric
readers (``metrics/<name>.py``) read."""

from __future__ import annotations

import contextlib
from typing import Any

STRETCH = "port_bench.stretch"


class Trace:
    """A traced stretch.

    ``device``: (name, start_us, end_us) of every device op (kernels,
    copies, fills) inside the stretch; ``host``: the same of the CPU ops;
    ``window_us``: (start, end) of the stretch, from its first device op
    to its last; ``steps``: steps the stretch ran;
    ``launches``: the program's own launch counts over the stretch;
    ``work``: per kernel name, the (operations, bytes) each of its
    launches must do (``port_bench.work``); ``context``: what a reader
    that measures on its own needs (the program, a state the window
    reached)."""

    def __init__(self, device, host, window_us, steps: int,
                 launches: dict, work: dict, context: dict):
        self.device, self.host = device, host
        self.window_us = window_us
        self.steps, self.launches, self.work = steps, launches, work
        self.context = context

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device ops' intervals, merged and sorted."""
        spans = sorted((s, e) for _, s, e in self.device)
        merged: list[list[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernels(self, part: str) -> list[tuple[str, float, float]]:
        return [d for d in self.device if part in d[0]]

    def device_ops(self, top: int = 10) -> list[list]:
        """The device ops that took most time, by name, in seconds."""
        total: dict[str, float] = {}
        for name, s, e in self.device:
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], sec] for name, sec in ranked]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The longest idle gaps of the device inside the window, each
        named by the innermost host op running where it starts."""
        busy = self.busy_intervals()
        edges = [(busy[i][1], busy[i + 1][0])
                 for i in range(len(busy) - 1)]
        gaps = sorted(((e - s, s) for s, e in edges if e > s),
                      reverse=True)[:top]
        out = []
        for length, start in gaps:
            inside = [h for h in self.host if h[1] <= start < h[2]]
            name = (max(inside, key=lambda h: h[1])[0] if inside
                    else "host")
            out.append([name[:120], length / 1e6])
        return out


def collect(prof, steps: int, launches: dict, work: dict,
            context: dict) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile`` whose
    stretch ran inside :func:`stretch_range`."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, span = [], [], None
    for ev in prof.events():
        rng = (ev.time_range.start, ev.time_range.end)
        if ev.name == STRETCH and ev.device_type != cuda:
            span = rng
        elif ev.device_type == cuda:
            if not getattr(ev, "is_user_annotation", False):
                device.append((ev.name, *rng))
        else:
            host.append((ev.name, *rng))
    if span is None:
        raise RuntimeError("the traced stretch's host range is missing")
    device = [d for d in device if d[1] >= span[0]]
    if not device:
        return Trace([], host, span, steps, launches, work, context)
    # The steady steps: from the stretch's first device op to its last,
    # leaving out the profiler's own start and the host's set-up of the
    # call before anything reaches the device.
    window = (min(d[1] for d in device), max(d[2] for d in device))
    return Trace(device, host, window, steps, launches, work, context)


@contextlib.contextmanager
def stretch_range():
    """The host range the trace's window starts from."""
    import torch

    with torch.profiler.record_function(STRETCH):
        yield


def profile(device_type: str) -> Any:
    """A profiler over the CPU and, on the card, CUDA activity."""
    from torch.profiler import ProfilerActivity, profile as _profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return _profile(activities=acts)
