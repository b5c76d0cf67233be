"""Traffic kind ``sweep``: a Monte-Carlo batch of independent swarms run
as one ensemble (``cbf_tpu_torch.parallel.ensemble.sharded_swarm_rollout``
on the (1, 1) mesh) in fixed segments, batch after batch, each batch's
members from fresh spawns drawn from the run's seed.

Parameters (the cell's ``params``): ``batch_steps``, ``segment_steps``,
``check_probability`` (the chance, drawn from the seed,
that a segment after a batch's first is checked; every batch's first is),
``stretch_steps`` and ``swarm`` (``swarm.Config`` fields over the
configuration's). The configuration's ``members`` sets the batch.

The ensemble returns per-step metrics and the segment's final state, not
each step's positions. So the check follows the program from its own
state at the start of each checked segment: the reference steps every
member through the segment, and each step's metrics (nearest in-radius
distance, engaged, infeasible and dropped counts) and the final
positions are compared with the program's: the counts exactly, the
positions and distances at their 99.9th percentile over members (see
``Traffic.check``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import common
from port_bench.reference import swarm as ref
from port_bench.work.knn import candidates, search_work

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Traffic:
    def __init__(self, cell: dict, config: dict, seed: int, device):
        from cbf_tpu_torch.ops import knn
        from cbf_tpu_torch.parallel import ensemble
        from cbf_tpu_torch.scenarios import swarm

        self.swarm, self.ensemble, self.knn = swarm, ensemble, knn
        self.params = cell["params"]
        fields = common.program_fields(config, cell)
        self.cfg = swarm.Config(**fields)
        self.ref = ref.from_config({"swarm": fields})
        self.members = int(config["members"])
        self.seed = int(seed)
        self.device = torch.device(device)
        self.kept: list[dict] = []
        self.last = None

    def setup(self, trace: bool = False) -> None:
        from cbf_tpu_torch.parallel.mesh import make_mesh

        self.mesh = make_mesh(1, 1, devices=(
            "cpu" if self.device.type == "cpu" else None))
        self.spawner = common.Spawner(self.cfg.n, self.seed, self.device)
        self.labels = list(range(self.members))
        L = self.params["segment_steps"]
        state = self._fresh()
        for i in range(common.WARM_SEGMENTS):
            state, _ = self._segment(state, L, i * L)
        if trace:
            self._segment(state, self.params["stretch_steps"], 0)
        _sync(self.device)

    def _fresh(self):
        x = self.spawner.draw(self.members)
        return x, torch.zeros_like(x)

    def _segment(self, state, steps: int, t0: int):
        return self.ensemble.sharded_swarm_rollout(
            self.cfg, self.mesh, self.labels, steps=steps,
            initial_state=state, t0=t0)

    def window(self, seconds: float) -> tuple[dict, int]:
        L = self.params["segment_steps"]
        batch = self.params["batch_steps"]
        p = self.params["check_probability"]
        rng = np.random.default_rng(self.seed)
        state, t, steps, segments = self._fresh(), 0, 0, 0
        _sync(self.device)
        t0 = time.perf_counter()
        while True:
            new, mets = self._segment(state, L, t)
            if t == 0 or rng.random() < p:
                self.kept.append({"x": state[0], "v": state[1],
                                  "x_end": new[0], "mets": mets})
            _sync(self.device)
            steps += L
            segments += 1
            state, t = new, t + L
            self.last = (state, t)
            if t >= batch:
                state, t = self._fresh(), 0
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        return ({"agent_steps_per_s":
                 steps * self.members * self.cfg.n / wall}, segments)

    def stretch(self, profiler_run):
        (x, v), t = self.last
        S = self.params["stretch_steps"]
        before = dict(self.knn.LAUNCHES)

        def run():
            self._segment((x, v), S, t)
            _sync(self.device)

        profiler_run(run)
        launches = {k: self.knn.LAUNCHES[k] - before[k] for k in before}
        # The ensemble keeps no positions per step: the reference follows
        # the stretch from its start for the in-radius counts.
        work, xr, vr = [], x, v
        for _ in range(S):
            work.append(search_work(self.members, self.cfg.n, self.ref.k,
                                    candidates(xr, self.ref.radius)))
            o = ref.step(xr, vr, self.ref)
            xr, vr = o.x_new, o.u
        context = {"certificate": False}
        return S, launches, {"knn_fused": work}, context

    def release(self) -> None:
        self.last = None
        self.ensemble._cached_executable.cache_clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _follow(self, item, dtype):
        """The reference through a kept segment from the program's start
        state: per step (nearest, engaged, infeasible, dropped) per
        member, and the final positions."""
        x, v = item["x"].to(dtype), item["v"].to(dtype)
        per_step = []
        for _ in range(item["mets"].engaged_count.shape[1]):
            o = ref.step(x, v, self.ref)
            gated = torch.where(o.nearest < self.ref.radius, o.nearest,
                                torch.full_like(o.nearest, float("inf")))
            per_step.append((torch.amin(gated, dim=-1).double(),
                             torch.sum(o.engaged, dim=-1),
                             torch.sum(~o.feasible & o.engaged, dim=-1),
                             torch.sum(o.dropped, dim=-1)))
            x, v = o.x_new, o.u
        stacked = tuple(torch.stack(col, dim=1) for col in zip(*per_step))
        return stacked, x

    def check(self, control: bool = False) -> dict:
        """The compared numbers over the kept segments. Positions and
        nearest distances are followed over a whole segment, where float32
        rounding parts a rare member's trajectory from the reference's
        (a handful of 58,000 member-segments of 64 agents on an H100), so
        they are compared at their 99.9th percentile; the counts stay
        exact and are compared at their widest."""
        finals, nears = [], []
        count_gap, broken = 0, False
        for item in self.kept:
            (near, eng, inf, drop), x_end = self._follow(item, torch.float32)
            if control:
                got, x_got = self._follow(item, torch.bfloat16)
            else:
                m = item["mets"]
                got = (m.nearest_distance.double(), m.engaged_count,
                       m.infeasible_count, m.dropped_count)
                x_got = item["x_end"]
            # A NaN or infinite answer is wrong whatever the drift.
            broken |= bool(~torch.all(torch.isfinite(x_got))
                           | torch.any(torch.isnan(got[0])))
            finals.append(torch.amax(torch.abs(
                x_got.double() - x_end.double()), dim=(1, 2)))
            both_inf = torch.isinf(got[0]) & torch.isinf(near)
            nears.append(torch.where(both_inf, torch.zeros_like(near),
                                     torch.abs(got[0].double() - near))
                         .reshape(-1))
            dcount = (torch.abs(got[1].long() - eng.long())
                      + torch.abs(got[2].long() - inf.long())
                      + torch.abs(got[3].long() - drop.long()))
            count_gap = max(count_gap, int(torch.amax(dcount)))
        gaps = {"x_gap_q999_m": float("inf") if broken else _q999(finals),
                "nearest_gap_q999_m": _q999(nears), "count_gap": count_gap}
        return {k: (v if v == v else float("inf")) for k, v in gaps.items()}


def _q999(parts) -> float:
    """The 99.9th percentile of the concatenated gaps (inf counts as
    wider than any finite gap)."""
    if not parts:
        return 0.0
    g = torch.cat(parts).double()
    g = torch.where(torch.isfinite(g), g, torch.full_like(g, 1e300))
    return float(torch.quantile(g, 0.999))
