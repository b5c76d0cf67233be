"""Falsification fleet (counterpart: cbf_tpu/verify/fleet.py):
corpus-driven continuous fuzzing over every registered scenario, runnable
as a preemptible background tenant of the serve engine.

The one-shot engines (`verify.search`) answer "does THIS config survive
THIS budget". The fleet is the standing-pressure half of the program: a
long-running campaign that

1. **mutates** archived counterexamples and near-miss low-margin
   survivors AFL-style — seeded operators (`MUTATION_OPS`) over
   initial-state deltas, deterministic from the fleet seed via
   ``fold_in(fold_in(fold_in(key, round), target), dispatch)`` on JAX's
   threefry stream (`utils.prng`), so the candidate stream is the JAX
   package's across processes and resumes;
2. **maintains** a persistent margin-coverage map per
   (target x property) and allocates each round's candidate budget
   where margins are thinnest (`allocate_budget`: unvisited cells
   first, then inverse-margin weighting);
3. **dispatches** candidate batches through the member-batched compiled
   evaluators (`search.make_eval_batch`: one CUDA graph per target and
   batch shape on the card, captured on the target's first dispatch),
   auto-enrolling every registry scenario (builtins +
   `platform.generate`) and the RTA hybrid as standing targets;
4. **runs as a background tenant** of `serve.engine.ServeEngine`
   (``attach_background``): one candidate batch per scheduler pass,
   only while the foreground tier is idle, dropped un-run on a
   foreground arrival (`on_preempt` -> ``fleet.preempt``). Offering a
   unit builds, captures and launches nothing: device work starts only
   when the unit runs.

New violations auto-shrink (float64-confirmed), archive to the corpus,
and trip a flight capsule; low-margin survivors archive as ``expect:
"safe"`` near-miss seeds (`corpus.near_miss_entry`). Campaign state
rides the fingerprinted resumable substrate from `verify.search`
(single atomically-replaced npz, the JAX package's layout): state is
saved at round END and every round's candidates derive only from
round-START state, so a SIGKILL mid-round re-runs that round
bit-identically on resume — archives are at-least-once, coverage
exactly-once.

The targets run on ``device`` (None = the card; ``"cpu"`` for the CPU).
It is not a `FleetSettings` field, so it never enters the campaign
fingerprint: a campaign moves between the card and the CPU.

CLI: ``python -m cbf_tpu_torch verify fleet`` (exit 3 = new violation).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, NamedTuple

import numpy as np
import torch

from cbf_tpu_torch.utils import prng
from cbf_tpu_torch.verify import corpus as _corpus
from cbf_tpu_torch.verify import shrink as _shrink
from cbf_tpu_torch.verify.properties import PROPERTY_NAMES
from cbf_tpu_torch.verify.search import (SearchSettings,
                                         _fingerprint_of, _load_round_state,
                                         _save_round_state, _state_dtype,
                                         _state_path, make_adapter,
                                         make_eval_batch, round_batch)

#: The event types this module emits (``obs.schema.FLEET_EVENT_TYPES``).
EMITTED_EVENT_TYPES: tuple[str, ...] = (
    "fleet.round", "fleet.violation", "fleet.preempt")

#: fold_in tag for the fleet's key stream — distinct from
#: search._ENGINE_TAG {random: 1, grad: 2, cem: 3}.
_FLEET_TAG = 4

#: AFL-style mutation operator families over initial-state deltas.
#: Order is part of the determinism contract (operator ids are drawn by
#: index); reordering or inserting mid-tuple invalidates persisted
#: campaigns (the settings fingerprint pins the tuple).
MUTATION_OPS: tuple[str, ...] = (
    "fresh",      # new draw: perturb_scale * normal
    "jitter",     # seed + 0.3 * perturb_scale * normal
    "scale",      # seed * uniform(0.5, 1.5)
    "rowmask",    # seed with a random half of the agent rows zeroed
    "crossover",  # row-wise splice of two seeds
    "flip",       # -seed (the reflected attack)
)


@dataclasses.dataclass(frozen=True)
class FleetSettings:
    """Everything that shapes the fleet's candidate streams — all of it
    is fingerprinted into persisted campaign state. The round BUDGET is
    deliberately not here (``budget_rounds`` on the fleet): extending a
    campaign's budget must resume it, not orphan it."""
    seed: int = 0
    batch: int = 16               # candidates per dispatch
    batches_per_round: int = 8    # dispatch budget allocated per round
    # Tighter than SearchSettings' 0.04/0.1: the standing targets run
    # the DEFAULT filters, whose calibrated floors (0.13 separation at
    # the bench-measured pack) leave less slack than a 0.1 m per-agent
    # push — at that norm the perturbation itself can close a spawn gap
    # below the floor before the filter ever acts, a fake finding. The
    # one-shot engines keep the wide neighborhood for deliberately
    # weakened filters; the fleet probes the certified envelope.
    perturb_scale: float = 0.02
    perturb_norm: float = 0.05
    near_miss_margin: float = 0.02  # archive survivors below this
    max_steps: int = 64           # horizon cap on standing targets
    generated_count: int = 2      # platform.generate specs to enroll
    include_rta: bool = True      # stand up the RTA hybrid target
    # (field, value) CBFParams overrides applied to every target's
    # default filter — the deliberate-weakening lever (--weaken).
    cbf_overrides: tuple = ()

    def __post_init__(self):
        if self.batch < 1 or self.batches_per_round < 1:
            raise ValueError("batch and batches_per_round must be >= 1")
        if self.near_miss_margin < 0:
            raise ValueError("near_miss_margin must be >= 0")


class FleetTarget(NamedTuple):
    name: str        # display / coverage-map name
    scenario: str    # registered scenario name (for make_adapter)
    archive: str     # corpus scenario name (importable module only)
    cfg: Any
    cbf: Any         # CBFParams override or None (target default)
    adapter: Any
    eval_b: Any      # batched evaluator: (B, *delta) -> (B, P)


class FleetResult(NamedTuple):
    targets: list          # coverage-map row names
    rounds: int            # rounds completed (cumulative, campaign)
    evaluated: int         # candidates evaluated (cumulative)
    best_margin: float     # thinnest margin observed anywhere
    violations: list       # new confirmed violations found THIS run
    near_misses: int       # near-miss cells flagged (cumulative)
    cells_visited: int     # coverage cells with at least one dispatch
    cells_total: int
    done: bool             # campaign over (violation found)
    state_path: str | None


def _default_cbf(scenario: str, cfg, device=None):
    """The scenario's default filter parameters (same derivation as the
    CLI's --weaken lever)."""
    from cbf_tpu_torch.core.filter import CBFParams
    from cbf_tpu_torch.scenarios import swarm as _swarm

    if scenario == "swarm" or getattr(cfg, "spawn", None) is not None:
        return _swarm.default_cbf(cfg, device=device)
    if scenario == "antipodal":
        return CBFParams(max_speed=cfg.max_speed, k=0.0)
    return CBFParams(max_speed=cfg.max_speed)


def enroll_targets(settings: FleetSettings = FleetSettings(), *,
                   mesh=None, telemetry=None,
                   device=None) -> list[FleetTarget]:
    """The fleet's standing targets: every builtin registry scenario,
    ``settings.generated_count`` freshly generated platform specs
    (seeded by the fleet seed — same seed, same specs, same registry
    names), and the RTA hybrid (swarm with the assurance ladder live,
    so ``rta_soundness`` is exercised under fuzz). Horizons are capped
    at ``settings.max_steps`` — the fleet buys coverage with many short
    probes, not few long ones. Generated and RTA targets archive as
    ``swarm`` (their configs ARE swarm configs; a generated name is not
    an importable module, which corpus replay requires). Building a
    target makes its initial state on ``device``; its first dispatch
    captures its member-step program."""
    from cbf_tpu_torch.scenarios.platform import dsl, registry

    ss = _search_settings(settings, mesh)
    overrides = dict(settings.cbf_overrides)

    def build(name, scenario, archive, cfg, steps_field):
        cap = min(int(getattr(cfg, steps_field)), settings.max_steps)
        cfg = dataclasses.replace(cfg, **{steps_field: cap})
        cbf = None
        if overrides:
            cbf = _default_cbf(scenario, cfg, device)._replace(**overrides)
        adapter = make_adapter(scenario, cfg, cbf=cbf, device=device)
        return FleetTarget(name=name, scenario=scenario, archive=archive,
                           cfg=adapter.cfg, cbf=cbf, adapter=adapter,
                           eval_b=make_eval_batch(adapter, ss, mesh))

    targets = []
    for entry in registry.builtin_entries():
        # Archive under the module basename: corpus replay imports
        # ``cbf_tpu_torch.scenarios.{archive}`` to rebuild the Config.
        archive = entry.module.rsplit(".", 1)[1]
        targets.append(build(entry.name, entry.adapter, archive,
                             entry.make_config(), entry.steps_field))
    if settings.generated_count > 0:
        specs = dsl.generate(settings.seed,
                             count=settings.generated_count,
                             telemetry=telemetry)
        dsl.enroll(specs, replace=True)
        for spec in specs:
            targets.append(build(spec.name, spec.name, "swarm",
                                 spec.to_config(), "steps"))
    if settings.include_rta:
        from cbf_tpu_torch.scenarios import swarm as _swarm

        base = _swarm.Config(n=12, steps=settings.max_steps,
                             k_neighbors=4, rta=True)
        targets.append(build("rta_hybrid", "swarm", "swarm", base,
                             "steps"))
    return targets


def _search_settings(settings: FleetSettings, mesh=None) -> SearchSettings:
    """The one-shot engines' settings for the fleet's evaluator, the batch
    rounded up to the dp extent of ``mesh`` (each rank evaluates its
    slice, :func:`search.make_eval_batch`)."""
    return round_batch(SearchSettings(
        budget=settings.batch, batch=settings.batch,
        perturb_scale=settings.perturb_scale,
        perturb_norm=settings.perturb_norm, seed=settings.seed), mesh)


def allocate_budget(n_batches: int, visits, worst_margin) -> np.ndarray:
    """Distribute a round's dispatch budget over targets: one dispatch
    to each never-visited target first (coverage before depth,
    deterministic index order), then the remainder by inverse-margin
    weight — the thinnest cell gets the largest share. Largest-
    remainder rounding with index tie-break keeps the split exactly
    reproducible."""
    visits = np.asarray(visits)
    worst = np.asarray(worst_margin, np.float64)
    T = len(visits)
    alloc = np.zeros(T, np.int64)
    remaining = int(n_batches)
    for t in range(T):
        if remaining == 0:
            break
        if visits[t] == 0:
            alloc[t] += 1
            remaining -= 1
    if remaining > 0:
        w = np.where(np.isfinite(worst), 1.0 / np.maximum(worst, 1e-3),
                     1.0)
        shares = remaining * w / w.sum()
        base = np.floor(shares).astype(np.int64)
        alloc += base
        left = remaining - int(base.sum())
        if left > 0:
            frac = shares - base
            # Largest remainder; ties fall to the lower index.
            order = sorted(range(T), key=lambda t: (-frac[t], t))
            for t in order[:left]:
                alloc[t] += 1
    return alloc


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def mutate_batch(key, batch: int, shape_one: tuple, dtype, scale: float,
                 seeds: list) -> np.ndarray:
    """One dispatch's candidate deltas, (batch, *shape_one) numpy of
    ``dtype`` (float32 or float64, torch or numpy): operator ids, seed
    picks, noise, gains, and row masks all derive from ``key`` alone
    (``fold_in(key, i)`` for i = 0..5, as the JAX package draws them), so
    the stream is a pure function of (fleet seed, round, target,
    dispatch). With no seeds yet, every candidate is a fresh draw
    (bootstrap = plain random search).

    A float64 campaign is one the JAX package runs under
    ``jax_enable_x64``, where its default ``randint`` draws int64 and its
    gains and masks draw float64: the port draws those widths for float64
    deltas and the x64-off widths (int32, float32) for float32 ones."""
    dt = _np_dtype(dtype)
    wide = dt == np.float64
    tdt = torch.float64 if wide else torch.float32
    ks = [prng.fold_in(key, i) for i in range(6)]
    noise = prng.normal(ks[0], (batch,) + tuple(shape_one), tdt).numpy()
    if not seeds:
        return scale * noise
    seeds_a = np.stack([np.asarray(s, noise.dtype) for s in seeds])
    idt = torch.int64 if wide else torch.int32
    ops = prng.randint(ks[1], (batch,), 0, len(MUTATION_OPS), idt).numpy()
    bi = prng.randint(ks[2], (batch,), 0, len(seeds), idt).numpy()
    bj = prng.randint(ks[3], (batch,), 0, len(seeds), idt).numpy()
    gains = prng.uniform(ks[4], (batch,), tdt, 0.5, 1.5).numpy()
    mask = prng.bernoulli(
        ks[5], 0.5, (batch, shape_one[0]) + (1,) * (len(shape_one) - 1),
        tdt).numpy()
    out = np.empty((batch,) + tuple(shape_one), noise.dtype)
    for c in range(batch):
        op = MUTATION_OPS[int(ops[c])]
        base, base2 = seeds_a[int(bi[c])], seeds_a[int(bj[c])]
        if op == "fresh":
            out[c] = scale * noise[c]
        elif op == "jitter":
            out[c] = base + 0.3 * scale * noise[c]
        elif op == "scale":
            out[c] = gains[c] * base
        elif op == "rowmask":
            out[c] = base * mask[c]
        elif op == "crossover":
            out[c] = np.where(mask[c], base, base2)
        else:                     # flip
            out[c] = -base
    return out


def _project_np(delta: np.ndarray, norm_cap: float) -> np.ndarray:
    """``search.project_delta`` of one host candidate in its own dtype,
    float64 out: numpy's correctly rounded square root, as XLA's is
    (torch's vectorised CPU sqrt can miss by an ulp), so a recorded best
    delta — a later round's mutation seed — is the JAX package's."""
    d = np.asarray(delta)
    ss = np.sum(d * d, axis=-1, keepdims=True)
    pos = ss > 0
    mag = np.where(pos, np.sqrt(np.where(pos, ss, 1.0)), 0.0).astype(d.dtype)
    scale = np.minimum(1.0, norm_cap / np.maximum(mag, d.dtype.type(1e-9)))
    return np.asarray(d * scale.astype(d.dtype), np.float64)


class FalsificationFleet:
    """One fuzzing campaign over a fixed target set (see the module
    docstring). Drive it either by calling :meth:`run` (standalone — the
    CLI default) or by attaching it to a `ServeEngine` as a background
    tenant (``engine.attach_background(fleet)``; :meth:`run` with
    ``engine=`` does both and blocks until the campaign ends).

    The tenant protocol is cursor-based: :meth:`next_unit` offers the
    campaign's next dispatch as a closure; campaign state advances only
    when the closure RUNS, so the scheduler may drop an offered unit
    un-run (foreground arrival) and the same work is re-offered on the
    next pull."""

    def __init__(self, settings: FleetSettings = FleetSettings(), *,
                 budget_rounds: int = 8, targets=None,
                 corpus_dir: str | None = None,
                 state_dir: str | None = None, resume: bool = True,
                 telemetry=None, mesh=None, flight=None, device=None):
        if budget_rounds < 1:
            raise ValueError("budget_rounds must be >= 1")
        from cbf_tpu_torch.parallel import multihost

        self.settings = settings
        self.budget_rounds = budget_rounds
        self.corpus_dir = corpus_dir
        self.state_dir = state_dir
        # In a world (--mesh-dp) every rank runs the same campaign; only
        # the primary writes the corpus, the state and the events.
        self._writes = multihost.is_primary()
        self.telemetry = telemetry if self._writes else None
        self.flight = flight if self._writes else None
        self._ss = _search_settings(settings, mesh)
        self.targets = list(targets) if targets is not None \
            else enroll_targets(settings, mesh=mesh, telemetry=telemetry,
                                device=device)
        if not self.targets:
            raise ValueError("fleet needs at least one target")
        self._key = prng.fold_in(prng.prng_key(settings.seed), _FLEET_TAG)
        T, P = len(self.targets), len(PROPERTY_NAMES)
        self._visits = np.zeros(T, np.int64)
        self._best_margin = np.full((T, P), np.inf, np.float64)
        self._best_worst = np.full(T, np.inf, np.float64)
        self._violation_counts = np.zeros((T, P), np.int64)
        self._near_missed = np.zeros((T, P), np.uint8)
        self._best_delta: list = [None] * T
        self._evaluated = 0
        self._round = 0
        self._done = False
        self._new_violations: list[dict] = []
        self._preempts = 0
        self._cursor_i = 0
        self._round_plan = None
        self._round_violators: dict[int, tuple] = {}
        self._fields = self._fingerprint_fields()
        self._fp = _fingerprint_of(self._fields)
        # Mutation seeds snapshot: only entries already in the corpus at
        # campaign START feed the stream (appending during the campaign
        # must not perturb later rounds — resume bit-exactness). The
        # snapshot length persists with the state.
        self._corpus_len0 = self._initial_corpus_len()
        if state_dir is not None and resume:
            self._restore()
        self._corpus_seeds = self._load_corpus_seeds()

    # -- construction helpers ---------------------------------------------

    def _fingerprint_fields(self) -> dict:
        raw = {"engine": "fleet",
               "mutation_ops": list(MUTATION_OPS),
               "targets": [{
                   "name": t.name, "scenario": t.scenario,
                   "archive": t.archive,
                   "delta_shape": list(t.adapter.delta_shape),
                   "steps": int(t.adapter.steps)} for t in self.targets],
               "settings": dataclasses.asdict(self.settings)}
        return json.loads(json.dumps(raw, sort_keys=True, default=str))

    def _initial_corpus_len(self) -> int:
        if self.corpus_dir is None:
            return 0
        try:
            return len(_corpus.load_entries(self.corpus_dir))
        except OSError:
            return 0

    def _load_corpus_seeds(self) -> list[list]:
        """Per-target mutation seed pools from the corpus snapshot:
        an entry seeds target t when its scenario matches the target's
        archive name and its delta matches the target's delta shape.
        File order is the determinism contract."""
        pools: list[list] = [[] for _ in self.targets]
        if self.corpus_dir is not None and self._corpus_len0 > 0:
            try:
                entries = _corpus.load_entries(self.corpus_dir)
            except OSError:
                entries = []
            for entry in entries[:self._corpus_len0]:
                delta = np.asarray(entry["delta"], np.float64)
                for t_idx, t in enumerate(self.targets):
                    if entry["scenario"] == t.archive \
                            and delta.shape == tuple(t.adapter.delta_shape):
                        pools[t_idx].append(delta)
        return pools

    def _seeds_for(self, t_idx: int) -> list:
        """Corpus snapshot seeds + the target's best-so-far delta (the
        exploit half of the loop: the thinnest observed survivor is the
        most promising mutation base)."""
        pool = list(self._corpus_seeds[t_idx])
        if self._best_delta[t_idx] is not None:
            pool.append(self._best_delta[t_idx])
        return pool

    # -- persistence -------------------------------------------------------

    def _restore(self) -> None:
        st = _load_round_state(self.state_dir, "fleet", self._fp,
                               self._fields)
        if st is None:
            return
        counters, arrays = st
        blob = json.loads(bytes(arrays["__fleet__"]).decode())
        self._round = int(counters["next_round"])
        self._evaluated = int(counters["evaluated"])
        self._done = bool(counters["done"])
        self._corpus_len0 = int(blob["corpus_len0"])
        self._visits = np.asarray(arrays["visits"], np.int64)
        self._best_margin = np.asarray(arrays["fleet_best_margin"],
                                       np.float64)
        self._best_worst = np.asarray(arrays["best_worst"], np.float64)
        self._violation_counts = np.asarray(arrays["violation_counts"],
                                            np.int64)
        self._near_missed = np.asarray(arrays["near_missed"], np.uint8)
        for i in range(len(self.targets)):
            a = arrays.get(f"best_delta_t{i}")
            if a is not None and a.size:
                self._best_delta[i] = np.asarray(a, np.float64)

    def _save(self) -> None:
        if self.state_dir is None or not self._writes:
            return
        extra = {
            "visits": self._visits,
            "fleet_best_margin": self._best_margin,
            "best_worst": self._best_worst,
            "violation_counts": self._violation_counts,
            "near_missed": self._near_missed,
            "__fleet__": np.frombuffer(json.dumps({
                "corpus_len0": int(self._corpus_len0),
                "targets": [t.name for t in self.targets]},
                sort_keys=True).encode(), np.uint8),
        }
        for i, d in enumerate(self._best_delta):
            if d is not None:
                extra[f"best_delta_t{i}"] = np.asarray(d, np.float64)
        _save_round_state(
            self.state_dir, "fleet", self._fp,
            next_round=self._round, evaluated=self._evaluated,
            best=(np.inf, None, None), done=self._done,
            extra_arrays=extra, fields=self._fields)

    # -- campaign body -----------------------------------------------------

    def _plan(self) -> list:
        """The current round's dispatch list, derived ONLY from
        round-start state (so a killed round replans identically)."""
        if self._round_plan is None:
            alloc = allocate_budget(self.settings.batches_per_round,
                                    self._visits, self._best_worst)
            self._round_plan = [(t, j) for t in range(len(self.targets))
                                for j in range(int(alloc[t]))]
            self._round_violators = {}
            self._round_candidates = 0
        return self._round_plan

    def _dispatch(self, t_idx: int, j: int) -> None:
        """Evaluate one mutated candidate batch against one target and
        fold the margins into the coverage map (one host copy of the
        batch's margins)."""
        target = self.targets[t_idx]
        kd = prng.fold_in(prng.fold_in(prng.fold_in(self._key, self._round),
                                       t_idx), j)
        deltas = mutate_batch(kd, self._ss.batch,
                              tuple(target.adapter.delta_shape),
                              _state_dtype(target.adapter),
                              self.settings.perturb_scale,
                              self._seeds_for(t_idx))
        margins = target.eval_b(deltas).detach().cpu().numpy().astype(
            np.float64)
        worst = margins.min(axis=1)
        self._evaluated += self._ss.batch
        self._round_candidates += self._ss.batch
        self._visits[t_idx] += 1
        self._best_margin[t_idx] = np.minimum(self._best_margin[t_idx],
                                              margins.min(axis=0))
        self._violation_counts[t_idx] += (margins < 0).sum(axis=0)
        i = int(np.argmin(worst))
        if worst[i] < self._best_worst[t_idx]:
            self._best_worst[t_idx] = worst[i]
            self._best_delta[t_idx] = _project_np(
                deltas[i], self.settings.perturb_norm)
        if worst[i] < 0:
            seen = self._round_violators.get(t_idx)
            if seen is None or worst[i] < seen[0]:
                self._round_violators[t_idx] = (
                    float(worst[i]),
                    _project_np(deltas[i], self.settings.perturb_norm))

    def _archive_violation(self, t_idx: int, delta) -> dict | None:
        """Shrink one violating candidate, float64-confirm it, archive
        it, trip a capsule. Returns the violation record, or None when
        the shrink cannot confirm it (float32 artifact)."""
        target = self.targets[t_idx]
        try:
            sr = _shrink.shrink(target.scenario, target.cfg, delta,
                                cbf=target.cbf,
                                thresholds=target.adapter.thresholds,
                                settings=self._ss, telemetry=self.telemetry,
                                device=target.adapter.device)
        except ValueError:
            return None          # margin flipped >= 0 solo: not real
        record = {"target": target.name, "scenario": target.archive,
                  "property": sr.property, "margin": sr.margin,
                  "margin_x64": sr.margin_x64,
                  "confirmed_x64": sr.confirmed_x64,
                  "round": self._round, "corpus": None}
        if not sr.confirmed_x64:
            return None
        if self.corpus_dir is not None and self._writes:
            entry = _corpus.entry_from(
                target.archive, target.cfg, sr, engine="fleet",
                settings=self._ss, cbf=target.cbf,
                thresholds=target.adapter.thresholds)
            record["corpus"] = _corpus.append_entry(self.corpus_dir, entry)
        if self.flight is not None:
            self.flight.trip(
                "fleet.violation",
                f"fleet found a confirmed violation: {target.name}/"
                f"{sr.property} margin_x64 {sr.margin_x64:.6f} "
                f"(round {self._round})")
        self._emit("fleet.violation", record)
        return record

    def _archive_near_misses(self) -> int:
        """Flag (and archive, when a corpus is attached) every coverage
        cell whose best margin entered the near-miss band this round.
        Once per cell per campaign."""
        new = 0
        thr = self.settings.near_miss_margin
        for t_idx, target in enumerate(self.targets):
            delta = self._best_delta[t_idx]
            if delta is None:
                continue
            row = self._best_margin[t_idx]
            for p_idx, prop in enumerate(PROPERTY_NAMES):
                if self._near_missed[t_idx, p_idx]:
                    continue
                if not (0.0 <= row[p_idx] < thr):
                    continue
                self._near_missed[t_idx, p_idx] = 1
                new += 1
                if self.corpus_dir is None or not self._writes:
                    continue
                prop_name, m32, m64 = _shrink.measure_margin_x64(
                    target.scenario, target.cfg, delta, cbf=target.cbf,
                    thresholds=target.adapter.thresholds,
                    settings=self._ss, property=prop,
                    steps=target.adapter.steps,
                    device=target.adapter.device)
                if m64 < 0:
                    continue     # float64 disagrees: not a survivor
                entry = _corpus.near_miss_entry(
                    target.archive, target.cfg, delta, engine="fleet",
                    settings=self._ss, property=prop_name, margin=m32,
                    margin_x64=m64, steps=target.adapter.steps,
                    cbf=target.cbf,
                    thresholds=target.adapter.thresholds)
                _corpus.append_entry(self.corpus_dir, entry)
        return new

    def _finish_round(self) -> None:
        """Archive the round's finds, emit ``fleet.round``, persist
        state, advance the cursor. A confirmed violation ends the
        campaign (exit-3 semantics); archives land BEFORE the state
        save, so a kill in between re-archives on resume
        (at-least-once) rather than ever losing a find."""
        self._plan()             # materialize accumulators on empty rounds
        new_records = []
        for t_idx, (_, delta) in sorted(self._round_violators.items()):
            rec = self._archive_violation(t_idx, delta)
            if rec is not None:
                new_records.append(rec)
        near = self._archive_near_misses()
        self._new_violations.extend(new_records)
        self._round += 1
        self._cursor_i = 0
        self._round_plan = None
        if new_records or self._round >= self.budget_rounds:
            self._done = bool(new_records)
            self._finished = True
        self._emit("fleet.round", {
            "round": self._round - 1,
            "candidates": int(self._round_candidates),
            "evaluated": int(self._evaluated),
            "best_margin": float(np.min(self._best_worst)),
            "violations": len(new_records),
            "near_misses": int(near),
            "cells_visited": self._cells_visited(),
            "cells_total": len(self.targets) * len(PROPERTY_NAMES)})
        self._save()

    def _cells_visited(self) -> int:
        return int((self._visits > 0).sum()) * len(PROPERTY_NAMES)

    def _emit(self, event_type: str, payload: dict) -> None:
        if self.telemetry is not None:
            from cbf_tpu_torch.obs.schema import json_scalar

            self.telemetry.event(event_type, {
                k: json_scalar(v) if isinstance(v, float) else v
                for k, v in payload.items()})

    # -- tenant protocol (serve.engine.attach_background) ------------------

    _finished = False

    def next_unit(self):
        """One unit of campaign work as a closure, or None when the
        campaign is over. State advances inside the closure — an
        offered-but-dropped unit costs nothing and is re-offered. The
        offer itself is host-only: no program is built, captured or
        launched until the closure runs."""
        if self._finished or self._done or \
                self._round >= self.budget_rounds:
            self._finished = True
            return None
        plan = self._plan()
        if self._cursor_i < len(plan):
            t_idx, j = plan[self._cursor_i]

            def unit():
                self._dispatch(t_idx, j)
                self._cursor_i += 1
            return unit
        return self._finish_round

    def on_preempt(self, queue_depth: int) -> None:
        """Tenant-side half of the yield guarantee: the scheduler
        dropped an offered unit because foreground work arrived."""
        self._preempts += 1
        self._emit("fleet.preempt", {
            "round": self._round, "queue_depth": int(queue_depth),
            "dispatched": int(self._cursor_i)})

    # -- driving -----------------------------------------------------------

    def run(self, engine=None, poll_s: float = 0.05) -> FleetResult:
        """Run the campaign to completion (violation found or budget
        exhausted). Standalone by default; with ``engine`` (a started
        `ServeEngine`), attach as its background tenant and block until
        the engine's idle capacity has driven the campaign to the same
        end state."""
        if engine is not None:
            import time as _time

            engine.attach_background(self)
            try:
                while not self._finished:
                    _time.sleep(poll_s)
            finally:
                engine.attach_background(None)
            return self.result()
        while True:
            unit = self.next_unit()
            if unit is None:
                break
            unit()
        return self.result()

    def result(self) -> FleetResult:
        return FleetResult(
            targets=[t.name for t in self.targets],
            rounds=self._round, evaluated=self._evaluated,
            best_margin=float(np.min(self._best_worst))
            if np.isfinite(self._best_worst).any() else float("inf"),
            violations=list(self._new_violations),
            near_misses=int(self._near_missed.sum()),
            cells_visited=self._cells_visited(),
            cells_total=len(self.targets) * len(PROPERTY_NAMES),
            done=self._done,
            state_path=None if self.state_dir is None
            else _state_path(self.state_dir, "fleet"))


def run_fleet(settings: FleetSettings = FleetSettings(), *,
              budget_rounds: int = 8, targets=None,
              corpus_dir: str | None = None, state_dir: str | None = None,
              resume: bool = True, telemetry=None, mesh=None, flight=None,
              engine=None, device=None) -> FleetResult:
    """Construct and run one `FalsificationFleet` campaign (the CLI
    entry point; see the class for the knobs)."""
    fleet = FalsificationFleet(
        settings, budget_rounds=budget_rounds, targets=targets,
        corpus_dir=corpus_dir, state_dir=state_dir, resume=resume,
        telemetry=telemetry, mesh=mesh, flight=flight, device=device)
    return fleet.run(engine=engine)
