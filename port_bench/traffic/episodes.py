"""Traffic kind ``episodes``: one swarm driven through the compiled
rollout (``cbf_tpu_torch.rollout.engine.rollout_at`` over the step of
``cbf_tpu_torch.scenarios.swarm.make``) in fixed segments, episode after
episode, each from a fresh spawn drawn from the run's seed.

Parameters (the cell's ``params``): ``episode_steps``, ``segment_steps``,
``checks_per_segment`` (steps of every segment whose answer the check
compares, drawn from the seed), ``stretch_steps`` (the traced stretch),
and ``swarm`` (``swarm.Config`` fields over the configuration's).

The check follows the program step by step from its own state: for each
sampled step the program recorded x_t (its trajectory) and produced
x_{t+1}; the reference takes x_t (and the velocity the program applied
before it) and works the step out again — consensus, gating, the filter
with its relax rounds, the certificate where the cell runs one, the
integration — and the two are compared, with the step's own outputs
(nearest distance, engaged, dropped and infeasible counts, the
certificate's residual and uncovered pairs).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import common
from port_bench.reference import swarm as ref
from port_bench.work.knn import candidates, search_work

OUTPUT_FIELDS = ("min_pairwise_distance", "filter_active_count",
                 "infeasible_count", "gating_dropped_count",
                 "certificate_residual", "certificate_dropped_count")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Traffic:
    def __init__(self, cell: dict, config: dict, seed: int, device):
        from cbf_tpu_torch.ops import knn
        from cbf_tpu_torch.rollout import engine
        from cbf_tpu_torch.scenarios import swarm

        self.swarm, self.engine, self.knn = swarm, engine, knn
        self.params = cell["params"]
        fields = common.program_fields(config, cell)
        self.cfg = swarm.Config(**fields)
        if not self.cfg.record_trajectory:
            raise ValueError("the episodes check reads the trajectory: "
                             "the configuration records it")
        self.ref = ref.from_config({"swarm": fields})
        self.seed = int(seed)
        self.device = torch.device(device)
        self.kept: list[dict] = []
        self.last = None            # (state, step in episode) at the end

    def _fresh(self):
        x = self.spawner.draw()
        return self.swarm.State(x=x, v=torch.zeros_like(x))

    def setup(self, trace: bool = False) -> None:
        """Build the step, and capture its segment program (and with
        ``trace`` the stretch's) on warm-up segments."""
        self.spawner = common.Spawner(self.cfg.n, self.seed, self.device)
        _, self.step = self.swarm.make(self.cfg, device=self.device)
        L = self.params["segment_steps"]
        state = self._fresh()
        for i in range(common.WARM_SEGMENTS):
            state, _ = self.engine.rollout_at(self.step, state, L, i * L)
        if trace:
            self.engine.rollout_at(self.step, state,
                                   self.params["stretch_steps"], 0)
        _sync(self.device)

    def window(self, seconds: float) -> tuple[dict, int]:
        """Segments until ``seconds`` have passed; returns the end-to-end
        readings and the segments run."""
        L = self.params["segment_steps"]
        episode = self.params["episode_steps"]
        m = self.params["checks_per_segment"]
        rng = np.random.default_rng(self.seed)
        state, t_ep, steps, segments = self._fresh(), 0, 0, 0
        _sync(self.device)
        t0 = time.perf_counter()
        while True:
            new, outs = self.engine.rollout_at(self.step, state, L, t_ep)
            self._keep(state, new, outs,
                       np.sort(rng.choice(L, size=m, replace=False)))
            _sync(self.device)
            steps += L
            segments += 1
            state, t_ep = new, t_ep + L
            self.last = (state, t_ep)
            if t_ep >= episode:
                state, t_ep = self._fresh(), 0
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        return {"agent_steps_per_s": steps * self.cfg.n / wall}, segments

    def _keep(self, start, new, outs, offsets) -> None:
        """Keep the sampled steps' inputs and answers: x_t, the velocity
        applied before it, x_{t+1} and the step's outputs."""
        traj = outs.trajectory
        L = traj.shape[0]
        for i in (int(o) for o in offsets):
            self.kept.append({
                "x": traj[i].clone(),
                "x_prev": None if i == 0 else traj[i - 1].clone(),
                "v0": start.v.clone() if i == 0 else None,
                "x_next": (traj[i + 1] if i + 1 < L else new.x).clone(),
                "outs": {f: getattr(outs, f)[i] for f in OUTPUT_FIELDS
                         if not isinstance(getattr(outs, f), tuple)},
            })

    def searches(self) -> list[tuple[int, float]]:
        """The k-NN searches one step launches, as (k, radius): the
        gating's, and the certificate's where the cell runs one."""
        out = [(self.ref.k, self.ref.radius)]
        if self.ref.certificate:
            out.append((self.ref.cert_k, ref.binding_pair_radius(
                self.ref.cert_gain, self.ref.cert_radius,
                self.ref.cert_limit)))
        return out

    def stretch(self, profiler_run):
        """Run the traced stretch from the state the window ended at;
        ``profiler_run(fn)`` runs ``fn`` under the profiler. Returns
        (steps, launches by kernel, work by kernel, context)."""
        state, t_ep = self.last
        S = self.params["stretch_steps"]
        before = dict(self.knn.LAUNCHES)
        result = {}

        def run():
            result["out"] = self.engine.rollout_at(self.step, state, S, t_ep)
            _sync(self.device)

        profiler_run(run)
        launches = {k: self.knn.LAUNCHES[k] - before[k] for k in before}
        new, outs = result["out"]
        work = [search_work(1, self.cfg.n, k,
                            candidates(outs.trajectory[i], r))
                for i in range(S) for k, r in self.searches()]
        context = {"certificate": self.cfg.certificate, "swarm": self.swarm,
                   "cfg": self.cfg, "x": new.x, "v": new.v}
        return S, launches, {"knn_fused": work}, context

    def release(self) -> None:
        """Drop the program (its captured graphs and buffers)."""
        self.step = None
        self.last = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, item, dtype):
        x = item["x"].to(dtype)
        if item["v0"] is not None:
            v = item["v0"].to(dtype)
        else:
            v = ((item["x"].double() - item["x_prev"].double())
                 / self.cfg.dt).to(dtype)
        return ref.step(x, v, self.ref)

    def check(self, control: bool = False) -> dict:
        """The compared numbers over the kept steps: the program's (or,
        with ``control``, the reference's own in bfloat16 put in the
        program's place) against the float32 reference."""
        gaps = {"x_gap_m": 0.0, "nearest_gap_m": 0.0, "count_gap": 0}
        if self.ref.certificate:
            gaps["cert_residual_gap"] = 0.0
        for item in self.kept:
            sound = self._reference(item, torch.float32)
            if control:
                c = self._reference(item, torch.bfloat16)
                got = {"x_next": c.x_new.float(),
                       "nearest": float(torch.amin(c.nearest)),
                       "counts": _counts(c),
                       "residual": (None if c.cert_residual is None
                                    else float(c.cert_residual))}
            else:
                o = item["outs"]
                got = {"x_next": item["x_next"],
                       "nearest": float(o["min_pairwise_distance"]),
                       "counts": (int(o["filter_active_count"]),
                                  int(o["gating_dropped_count"]),
                                  int(o["infeasible_count"]),
                                  int(o.get("certificate_dropped_count",
                                            0))),
                       "residual": (float(o["certificate_residual"])
                                    if "certificate_residual" in o
                                    else None)}
            want = _counts(sound)
            new = {"x_gap_m": float(torch.amax(torch.abs(
                       got["x_next"].double() - sound.x_new.double()))),
                   "nearest_gap_m": abs(got["nearest"]
                                        - float(torch.amin(sound.nearest))),
                   "count_gap": sum(abs(a - b) for a, b in
                                    zip(got["counts"], want))}
            if self.ref.certificate:
                new["cert_residual_gap"] = abs(
                    got["residual"] - float(sound.cert_residual))
            for k, v in new.items():
                gaps[k] = max(gaps[k], _wide(v))
        return gaps


def _counts(o) -> tuple[int, int, int, int]:
    """(engaged, dropped, infeasible, uncovered certificate pairs)."""
    return (int(torch.sum(o.engaged)), int(torch.sum(o.dropped)),
            int(torch.sum(~o.feasible & o.engaged)),
            0 if o.cert_dropped is None else int(o.cert_dropped))


def _wide(v):
    """A gap that is not a number (a NaN answer) reads as infinitely
    wide, never as none."""
    return v if v == v else float("inf")
