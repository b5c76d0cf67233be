"""Batched falsification: adversarial search over perturbed initial
states (counterpart: cbf_tpu/verify/search.py).

Each engine searches for a bounded perturbation ``delta`` of the
scenario's spawn state that drives a full rollout to a property violation
(:mod:`cbf_tpu_torch.verify.properties`, margin < 0):

- :func:`random_search` — seeded Gaussian perturbations, pure breadth;
- :func:`gradient_search` — normalized-gradient descent on the worst
  differentiable margin through the eager autograd rollout (the step with
  ``unroll_relax > 0``), a batch of candidates at once;
- :func:`cem_search` — cross-entropy refinement around the elite.

The JAX package evaluates a batch as ``jit(vmap(eval_one))``: one program
in which every ``pallas_call`` becomes one batched launch. Here
:func:`make_eval_batch` is one program per batch shape too: the member
step :func:`member_step` is ``torch.func.vmap`` of the scenario's
capture-safe step over a leading candidate axis — the k-NN kernels reach
it through :func:`cbf_tpu_torch.ops.knn.knn_select` (a ``gating="banded"``
swarm through :func:`~cbf_tpu_torch.ops.knn.knn_neighbors_banded`), whose
vmap rules make the candidate axis the kernels' member axis, one launch
(set) per step for the batch, and every other op runs batched — and the
compiled rollout
(:func:`cbf_tpu_torch.rollout.engine.rollout`) captures it as a CUDA
graph. Each candidate carries its own relax flag; where any is set, the
chunk is redone candidate by candidate with the eager step (exact: the
candidates are independent).

Every key is ``fold_in``-derived from ``SearchSettings.seed``
(:mod:`cbf_tpu_torch.utils.prng` reproduces ``jax.random``'s streams), so
the engines draw the JAX package's proposals; the draws are made on the
host and copied to the card before each batch. ``telemetry`` is any
object with an ``event(type, payload)`` method. With a dp ``mesh`` (a
(dp, sp) pair over a ``torch.distributed`` world) every rank draws the
same candidates, evaluates its B / dp slice and all-gathers the margins,
so every rank holds the same search state; only the primary rank emits
events and writes campaign files.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from cbf_tpu_torch.obs.schema import json_scalar
from cbf_tpu_torch.rollout.engine import (_leaves, _tree_map, eager_rollout,
                                          rollout)
from cbf_tpu_torch.solvers import exact2d
from cbf_tpu_torch.utils import prng
from cbf_tpu_torch.utils.math import l2_cap
from cbf_tpu_torch.verify.properties import (DIFFERENTIABLE_PROPERTIES,
                                             PROPERTY_NAMES,
                                             PropertyThresholds,
                                             rollout_margins, stack_margins,
                                             thresholds_for)

#: Event types this module emits (the JAX package's
#: ``obs.schema.VERIFY_EVENT_TYPES``).
EMITTED_EVENT_TYPES: tuple[str, ...] = ("verify.round", "verify.margin")

ENGINES: tuple[str, ...] = ("random", "grad", "cem")

# fold_in tags: engine keys never collide across engines.
_ENGINE_TAG = {"random": 1, "grad": 2, "cem": 3}


@dataclasses.dataclass(frozen=True)
class SearchSettings:
    """Falsification budget and proposal knobs (the JAX package's)."""
    budget: int = 256
    batch: int = 32
    perturb_scale: float = 0.04
    perturb_norm: float = 0.1
    seed: int = 0
    gd_iters: int = 12
    gd_lr: float = 0.03
    gd_candidates: int = 8
    unroll_relax: int = 2
    cem_rounds: int = 6
    cem_elite_frac: float = 0.2
    cem_std_floor: float = 5e-3


class Adapter(NamedTuple):
    """One scenario bound for falsification (build once, evaluate
    thousands of candidates). ``obstacle_fn(T)`` gives the (T, M, 2)
    obstacle positions of steps 0..T-1 on ``device``."""
    scenario: str
    cfg: Any
    state0: Any
    step: Callable             # (state, t) -> (state, StepOutputs)
    steps: int
    thresholds: PropertyThresholds
    delta_shape: tuple         # perturbation shape ((P, 2) positions)
    perturb: Callable          # (state0, delta) -> state0'
    positions: Callable        # final_state -> (N, 2)
    traj_extract: Callable     # outs -> (T, N, 2) | None
    obstacle_fn: Callable | None
    obstacle_fn_np: Callable | None   # host t -> (M, 2) | None
    differentiable: bool
    device: torch.device = torch.device("cpu")


def make_adapter(scenario: str, cfg=None, *, cbf=None, steps=None,
                 thresholds: PropertyThresholds | None = None,
                 differentiable: bool = False, unroll_relax: int = 2,
                 device=None) -> Adapter:
    """Bind a scenario config for falsification, through the registry
    (:mod:`cbf_tpu_torch.scenarios.platform.registry`). ``device`` None
    means the card. ``differentiable=True`` (swarm only) builds the step
    with the unrolled-relax QP and the dense gating, for the gradient
    engine."""
    from cbf_tpu_torch.scenarios.platform import registry as scen_registry

    try:
        entry = scen_registry.get(scenario)
    except KeyError:
        raise ValueError(
            f"unknown scenario {scenario!r}; have "
            f"{', '.join(scen_registry.names())}") from None
    if cfg is None:
        cfg = entry.make_config()
    factory = ADAPTER_FACTORIES[entry.adapter]
    if entry.adapter == "swarm":
        return factory(scenario, cfg, cbf, steps, thresholds,
                       differentiable, unroll_relax, device)
    if differentiable:
        raise ValueError(
            f"the differentiable (gradient-engine) path exists for "
            f"swarm-built steps only — {scenario!r} steps run the "
            "scalar-guarded relax loop; use the random/cem engines")
    return factory(scenario, cfg, cbf, steps, thresholds, device)


def _add_positions(s0, d):
    return s0._replace(x=s0.x + d.to(s0.x.dtype))


def _swarm_adapter(scenario, cfg, cbf, steps, thresholds, differentiable,
                   unroll_relax, device) -> Adapter:
    from cbf_tpu_torch.scenarios import swarm

    cfg = cfg or swarm.Config()
    if steps is not None:
        cfg = dataclasses.replace(cfg, steps=int(steps))
    if differentiable:
        if cfg.gating_rebuild_skin or cfg.certificate_rebuild_skin:
            raise ValueError(
                "the gradient engine cannot differentiate the Verlet "
                "caches (rebuild cond) — falsify with both skins at 0")
        if cfg.certificate:
            raise ValueError(
                "the gradient engine does not differentiate the joint "
                "certificate; falsify certificate configs with the "
                "random/cem engines (the filter parameters under attack "
                "are the same)")
        cfg = dataclasses.replace(cfg, gating="jnp")
    state0, step = swarm.make(
        cfg, cbf, unroll_relax=unroll_relax if differentiable else 0,
        device=device)
    dev = state0.x.device
    th = thresholds or thresholds_for(scenario, cfg)
    obstacle_fn = obstacle_fn_np = None
    if cfg.n_obstacles:
        def obstacle_fn(T):
            return swarm.obstacle_table(cfg, 0, T, cfg.dtype)[..., :2].to(dev)

        def obstacle_fn_np(t):
            return swarm.obstacle_positions_at(cfg, t)
    traj_extract = ((lambda outs: outs.trajectory)
                    if cfg.record_trajectory else (lambda outs: None))
    return Adapter(
        scenario=scenario, cfg=cfg, state0=state0, step=step,
        steps=int(cfg.steps), thresholds=th, delta_shape=(cfg.n, 2),
        perturb=_add_positions, positions=lambda final: final.x,
        traj_extract=traj_extract, obstacle_fn=obstacle_fn,
        obstacle_fn_np=obstacle_fn_np, differentiable=differentiable,
        device=dev)


def _meet_adapter(scenario, cfg, cbf, steps, thresholds, device) -> Adapter:
    from cbf_tpu_torch.scenarios import meet_at_center as meet

    cfg = cfg or meet.Config()
    if steps is not None:
        cfg = dataclasses.replace(cfg, iterations=int(steps))
    state0, step = meet.make(cfg, cbf=cbf, device=device)
    th = thresholds or thresholds_for("meet_at_center", cfg)
    n_obs = cfg.n_obstacles

    def perturb(s0, d):
        # Free agents only: perturbing the pursuit ring can fabricate a
        # t=0 overlap no filter could have prevented.
        p = s0.poses
        moved = p[:2, n_obs:] + d.T.to(p.dtype)
        return s0._replace(poses=torch.cat(
            [torch.cat([p[:2, :n_obs], moved], dim=1), p[2:]], dim=0))

    traj_extract = ((lambda outs: torch.swapaxes(outs.trajectory, 1, 2))
                    if cfg.record_trajectory else (lambda outs: None))
    return Adapter(
        scenario="meet_at_center", cfg=cfg, state0=state0, step=step,
        steps=int(cfg.iterations), thresholds=th,
        delta_shape=(cfg.n_free, 2), perturb=perturb,
        positions=lambda final: final.poses[:2].T,
        traj_extract=traj_extract, obstacle_fn=None, obstacle_fn_np=None,
        differentiable=False, device=state0.poses.device)


def _cross_adapter(scenario, cfg, cbf, steps, thresholds, device) -> Adapter:
    from cbf_tpu_torch.scenarios import cross_and_rescue as cross

    cfg = cfg or cross.Config()
    if steps is not None:
        cfg = dataclasses.replace(cfg, iterations=int(steps))
    state0, step = cross.make(cfg, cbf=cbf, device=device)
    th = thresholds or thresholds_for("cross_and_rescue", cfg)

    def perturb(s0, d):
        p = s0.poses
        return s0._replace(poses=torch.cat([p[:2] + d.T.to(p.dtype), p[2:]],
                                           dim=0))

    def traj_extract(outs):
        if not cfg.record_trajectory:
            return None
        return torch.swapaxes(outs.trajectory[0], 1, 2)

    return Adapter(
        scenario="cross_and_rescue", cfg=cfg, state0=state0, step=step,
        steps=int(cfg.iterations), thresholds=th,
        delta_shape=(cfg.n_robots, 2), perturb=perturb,
        positions=lambda final: final.poses[:2].T,
        traj_extract=traj_extract, obstacle_fn=None, obstacle_fn_np=None,
        differentiable=False, device=state0.poses.device)


def _antipodal_adapter(scenario, cfg, cbf, steps, thresholds,
                       device) -> Adapter:
    from cbf_tpu_torch.scenarios import antipodal

    cfg = cfg or antipodal.Config()
    if steps is not None:
        cfg = dataclasses.replace(cfg, steps=int(steps))
    state0, step = antipodal.make(cfg, cbf=cbf, device=device)
    th = thresholds or thresholds_for("antipodal", cfg)
    traj_extract = ((lambda outs: outs.trajectory)
                    if cfg.record_trajectory else (lambda outs: None))
    return Adapter(
        scenario="antipodal", cfg=cfg, state0=state0, step=step,
        steps=int(cfg.steps), thresholds=th, delta_shape=(cfg.n, 2),
        perturb=_add_positions, positions=lambda final: final.x,
        traj_extract=traj_extract, obstacle_fn=None, obstacle_fn_np=None,
        differentiable=False, device=state0.x.device)


#: Adapter-factory dispatch, keyed by ``ScenarioEntry.adapter``.
ADAPTER_FACTORIES: dict[str, Callable] = {
    "swarm": _swarm_adapter,
    "meet_at_center": _meet_adapter,
    "cross_and_rescue": _cross_adapter,
    "antipodal": _antipodal_adapter,
}


# ----------------------------------------------------------- evaluation --

def project_delta(delta, norm_cap: float):
    """Clamp each agent's perturbation row to the attack neighbourhood
    (per-row L2 cap)."""
    return l2_cap(delta, norm_cap)


def _dp_axis(mesh, device):
    """The dp :class:`~cbf_tpu_torch.parallel.mesh.Axis` the candidate
    axis is sharded over: None for no mesh or dp 1; a (dp, sp) pair is
    built over the process world
    (:func:`cbf_tpu_torch.parallel.mesh.as_mesh`)."""
    if mesh is None or tuple(mesh)[0] == 1:
        return None
    from cbf_tpu_torch.parallel.mesh import as_mesh

    return as_mesh(mesh, device).axis("dp")


def round_batch(settings: SearchSettings, mesh) -> SearchSettings:
    """Round ``settings.batch`` up to a whole multiple of the mesh's dp
    extent (no-op without a mesh)."""
    if mesh is None:
        return settings
    dp = tuple(mesh)[0]
    batch = -(-settings.batch // dp) * dp
    return dataclasses.replace(settings, batch=batch)


def _writer(telemetry):
    """(telemetry, writes): only the primary rank of a world emits events
    and writes campaign files; every rank holds the same search state."""
    from cbf_tpu_torch.parallel import multihost

    primary = multihost.is_primary()
    return (telemetry if primary else None), primary


def _margins_fn(adapter: Adapter):
    """(final, outs) -> (P,) margins of one rollout."""
    def margins(final, outs):
        m = rollout_margins(adapter.thresholds, outs,
                            adapter.positions(final),
                            trajectory=adapter.traj_extract(outs),
                            obstacle_fn=adapter.obstacle_fn)
        return stack_margins(m)
    return margins


def make_eval_one(adapter: Adapter, settings: SearchSettings) -> Callable:
    """``eval_one(delta) -> (P,) margins``: one eager rollout of the
    perturbed state and every property margin. Differentiable where the
    adapter's step is (the gradient engine's core)."""
    margins = _margins_fn(adapter)

    def eval_one(delta):
        d = project_delta(delta.to(adapter.device), settings.perturb_norm)
        s0 = adapter.perturb(adapter.state0, d)
        final, outs = eager_rollout(adapter.step, s0, adapter.steps)
        return margins(final, outs)

    return eval_one


def _member(tree, b: int):
    return _tree_map(lambda v: v[b], tree)


def _stack(trees):
    return _tree_map(lambda *vs: torch.stack(vs), *trees)


def member_step(step: Callable) -> Callable:
    """The step over a leading candidate axis. Inside the compiled
    rollout's body it is ``torch.func.vmap`` of ``step`` with one guard
    (and relax flag) per candidate, the flags ORed into the body's; the
    k-NN kernels launch once per step for the batch. Outside it (the
    eager loop, the redo path) each candidate takes the eager step in
    turn. Carries the step's ``relax_rounds``, ``admm_blocks`` and
    ``host_inputs``, which the candidates share."""
    hook = getattr(step, "host_inputs", None)

    def call(state, t, inputs):
        return step(state, t) if inputs is None else \
            step(state, t, inputs=inputs)

    def batched(state, t, inputs=None):
        if not exact2d.in_guarded_body():
            B = _leaves(state)[0].shape[0]
            per = [call(_member(state, b), t, inputs) for b in range(B)]
            return _stack([p[0] for p in per]), _stack([p[1] for p in per])
        rounds, blocks = exact2d.guard_settings()

        def one(s, flag):
            with exact2d.guarded_relax(rounds, flag, blocks):
                s2, out = call(s, t, inputs)
            return s2, out, flag

        leaf = _leaves(state)[0]
        flags = torch.zeros(leaf.shape[0], dtype=torch.bool,
                            device=leaf.device)
        new, outs, flags = torch.func.vmap(one)(state, flags)
        exact2d.request_redo(torch.any(flags))
        return new, outs

    for name in ("relax_rounds", "admm_blocks"):
        if hasattr(step, name):
            setattr(batched, name, getattr(step, name))
    if hook is not None:
        batched.host_inputs = hook
    return batched


def make_eval_batch(adapter: Adapter, settings: SearchSettings,
                    mesh=None, cost_model=None) -> Callable:
    """``eval_batch(deltas (B, *delta_shape)) -> (B, P)`` margins: the
    batch's perturbed states step together through :func:`member_step`
    in one compiled rollout (one CUDA graph per batch shape on the card,
    cached on the member step), then every candidate's margins. With a
    dp ``mesh`` (a (dp, sp) pair or a mesh over the world) every rank
    evaluates its B / dp slice of the batch and all-gathers the margins,
    so every rank holds all B (B must be a multiple of dp —
    :func:`round_batch`). With ``cost_model`` (a
    :class:`cbf_tpu_torch.obs.resource.CostModel`) each batch shape's
    program is prepared and measured under ``verify-eval-b<B>-s<steps>``
    and every batch's rollout wall is observed."""
    axis = _dp_axis(mesh, adapter.device)
    stepper = member_step(adapter.step)
    margins = torch.func.vmap(_margins_fn(adapter), in_dims=(0, 1))

    def perturb_one(d):
        return adapter.perturb(adapter.state0,
                               project_delta(d, settings.perturb_norm))

    def eval_batch(deltas):
        deltas = torch.as_tensor(deltas).to(adapter.device)
        s0 = torch.func.vmap(perturb_one)(deltas)
        label = None if cost_model is None else \
            f"verify-eval-b{deltas.shape[0]}-s{adapter.steps}"
        final, outs = rollout(stepper, s0, adapter.steps,
                              cost_model=cost_model, cost_label=label)
        return margins(final, outs)

    eval_batch.member_step = stepper
    if axis is None:
        return eval_batch

    def eval_sharded(deltas):
        B = deltas.shape[0]
        if B % axis.size:
            raise ValueError(
                f"batch {B} must be a multiple of the dp extent "
                f"{axis.size} (round_batch pads the settings for you)")
        b = B // axis.size
        mine = eval_batch(deltas[axis.index * b:(axis.index + 1) * b])
        return axis.all_gather(mine)

    eval_sharded.member_step = stepper
    return eval_sharded


# -------------------------------------------------------------- results --

class SearchResult(NamedTuple):
    """One engine's verdict: the lowest-margin candidate it saw."""
    engine: str
    scenario: str
    found: bool
    margin: float
    property: str
    delta: np.ndarray
    margins: dict
    evaluated: int
    rounds: int
    seed: int


def _result(engine, adapter, settings, delta_np, margins_vec, evaluated,
            rounds) -> SearchResult:
    m = np.asarray(margins_vec, np.float64)
    i = int(np.argmin(m))
    return SearchResult(
        engine=engine, scenario=adapter.scenario,
        found=bool(m[i] < 0.0), margin=float(m[i]),
        property=PROPERTY_NAMES[i], delta=np.asarray(delta_np),
        margins={name: float(v) for name, v in zip(PROPERTY_NAMES, m)},
        evaluated=int(evaluated), rounds=int(rounds), seed=settings.seed)


def _emit_round(telemetry, engine, rnd, candidates, best_margin,
                violations, evaluated) -> None:
    if telemetry is None:
        return
    telemetry.event("verify.round", {
        "engine": engine, "round": int(rnd), "candidates": int(candidates),
        "best_margin": json_scalar(best_margin),
        "violations": int(violations), "evaluated": int(evaluated)})


def _emit_result(telemetry, result: SearchResult) -> None:
    if telemetry is None:
        return
    telemetry.event("verify.margin", {
        "engine": result.engine, "scenario": result.scenario,
        "property": result.property,
        "margin": json_scalar(result.margin),
        "found": bool(result.found), "evaluated": result.evaluated})


def _worst_per_candidate(margins) -> np.ndarray:
    """(B,) worst margin per candidate, on host."""
    return torch.amin(margins, dim=1).detach().cpu().numpy().astype(
        np.float64)


# ------------------------------------------------- campaign persistence --
#
# The random and cem engines persist per-round state under ``state_dir``
# (counters and best candidate, plus the CEM proposal) in ONE atomically
# replaced npz per engine, and resume bit-identically: round r's key is
# fold_in(engine_key, r) whether or not rounds 0..r-1 ran in this process.

SEARCH_STATE_SCHEMA_VERSION = 1
_COUNTERS_KEY = "__counters__"


def write_npz_atomic(path: str, arrays: dict) -> None:
    """np.savez to a temp file in the target directory, fsync,
    ``os.replace`` (the JAX package's ``durable.integrity``)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-", suffix=".npz~")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _campaign_fields(engine: str, adapter: Adapter,
                     settings: SearchSettings) -> dict:
    return json.loads(json.dumps({
        "engine": engine, "scenario": adapter.scenario,
        "delta_shape": list(adapter.delta_shape), "steps": adapter.steps,
        "settings": dataclasses.asdict(settings)},
        sort_keys=True, default=str))


def _fingerprint_of(fields: dict) -> str:
    blob = json.dumps(fields, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _diff_fields(persisted: dict, expected: dict, prefix: str = "") -> list:
    diffs = []
    for k in sorted(set(persisted) | set(expected)):
        old, new = persisted.get(k), expected.get(k)
        if old == new:
            continue
        if isinstance(old, dict) and isinstance(new, dict):
            diffs.extend(_diff_fields(old, new, f"{prefix}{k}."))
        else:
            diffs.append(f"{prefix}{k} (persisted {old!r} != {new!r})")
    return diffs


def _state_path(state_dir: str, engine: str) -> str:
    return os.path.join(os.path.abspath(state_dir), f"{engine}_state.npz")


def reset_campaign_state(state_dir: str) -> list:
    """Delete every persisted ``*_state.npz`` under ``state_dir``; returns
    the removed paths."""
    removed = []
    root = os.path.abspath(state_dir)
    if not os.path.isdir(root):
        return removed
    for name in sorted(os.listdir(root)):
        if name.endswith("_state.npz"):
            path = os.path.join(root, name)
            os.remove(path)
            removed.append(path)
    return removed


def _save_round_state(state_dir, engine, fingerprint, *, next_round,
                      evaluated, best, done, extra_arrays=None,
                      fields=None) -> None:
    arrays = dict(extra_arrays or {})
    if best[1] is not None:
        arrays["best_delta"] = np.asarray(best[1])
        arrays["best_margins"] = np.asarray(best[2])
    counters = {
        "schema": SEARCH_STATE_SCHEMA_VERSION, "engine": engine,
        "fingerprint": fingerprint, "next_round": int(next_round),
        "evaluated": int(evaluated),
        "best_margin": None if best[1] is None else float(best[0]),
        "done": bool(done)}
    if fields is not None:
        counters["fields"] = fields
    arrays[_COUNTERS_KEY] = np.frombuffer(
        json.dumps(counters, sort_keys=True).encode(), np.uint8)
    write_npz_atomic(_state_path(state_dir, engine), arrays)


def _load_round_state(state_dir: str, engine: str, fingerprint: str,
                      fields: dict | None = None):
    npath = _state_path(state_dir, engine)
    if not os.path.exists(npath):
        return None
    with np.load(npath) as z:
        arrays = {k: z[k] for k in z.files}
    counters = json.loads(bytes(arrays.pop(_COUNTERS_KEY)).decode())
    if counters.get("schema") != SEARCH_STATE_SCHEMA_VERSION:
        raise ValueError(
            f"search state schema {counters.get('schema')!r} at {npath} "
            f"!= {SEARCH_STATE_SCHEMA_VERSION}")
    if counters.get("fingerprint") != fingerprint:
        detail = ""
        persisted = counters.get("fields")
        if persisted is not None and fields is not None:
            diffs = _diff_fields(persisted, fields)
            if diffs:
                detail = ": " + "; ".join(diffs)
        raise ValueError(
            f"persisted {engine} campaign in {state_dir} was run under "
            f"different settings/scenario (fingerprint mismatch{detail}) "
            "— refusing to splice; use a fresh state dir, the original "
            "settings, or --reset-state")
    return counters, arrays


def _resume_engine_state(state_dir, engine, fingerprint, resume, rounds,
                         best, evaluated, fields=None):
    if state_dir is None or not resume:
        return 0, evaluated, best, False, {}
    st = _load_round_state(state_dir, engine, fingerprint, fields)
    if st is None:
        return 0, evaluated, best, False, {}
    counters, arrays = st
    r0 = int(counters["next_round"])
    evaluated = int(counters["evaluated"])
    if counters["best_margin"] is not None:
        best = (counters["best_margin"], arrays["best_delta"],
                arrays["best_margins"])
    return r0, evaluated, best, bool(counters["done"]) or r0 >= rounds, arrays


# -------------------------------------------------------------- engines --

def _state_dtype(adapter: Adapter):
    return adapter.positions(adapter.state0).dtype


def _engine_key(settings: SearchSettings, engine: str):
    return prng.fold_in(prng.prng_key(settings.seed), _ENGINE_TAG[engine])


def _best_of(deltas, margins, worst, best, settings):
    i = int(np.argmin(worst))
    if worst[i] < best[0]:
        return (worst[i],
                project_delta(deltas[i], settings.perturb_norm).detach()
                .cpu().numpy(),
                margins[i].detach().cpu().numpy())
    return best


def random_search(adapter: Adapter,
                  settings: SearchSettings = SearchSettings(), *,
                  telemetry=None, mesh=None, state_dir: str | None = None,
                  resume: bool = True) -> SearchResult:
    """Batched seeded random search; stops after the first round that
    finds a violation (the whole round still evaluates). ``state_dir``
    persists per-round campaign state and, with ``resume``, picks a
    killed campaign up at its next round. With a dp ``mesh`` every rank
    draws the same candidates, evaluates its slice and holds every
    margin; only the primary rank writes."""
    settings = round_batch(settings, mesh)
    telemetry, writes = _writer(telemetry)
    key = _engine_key(settings, "random")
    B = settings.batch
    rounds = max(1, -(-settings.budget // B))
    best = (np.inf, None, None)
    ffields = _campaign_fields("random", adapter, settings) \
        if state_dir is not None else None
    fp = None if ffields is None else _fingerprint_of(ffields)
    r0, evaluated, best, finished, _ = _resume_engine_state(
        state_dir, "random", fp, resume, rounds, best, 0, ffields)
    if finished:
        result = _result("random", adapter, settings, best[1], best[2],
                         evaluated, r0)
        _emit_result(telemetry, result)
        return result
    eval_b = make_eval_batch(adapter, settings, mesh)
    dt_ = _state_dtype(adapter)
    for r in range(r0, rounds):
        deltas = (settings.perturb_scale * prng.normal(
            prng.fold_in(key, r), (B,) + adapter.delta_shape, dt_)).to(
                adapter.device)
        margins = eval_b(deltas)
        worst = _worst_per_candidate(margins)
        evaluated += B
        best = _best_of(deltas, margins, worst, best, settings)
        _emit_round(telemetry, "random", r, B, best[0],
                    int((worst < 0).sum()), evaluated)
        if state_dir is not None and writes:
            _save_round_state(state_dir, "random", fp, next_round=r + 1,
                              evaluated=evaluated, best=best,
                              done=bool(best[0] < 0), fields=ffields)
        if best[0] < 0:
            break
    result = _result("random", adapter, settings, best[1], best[2],
                     evaluated, r + 1)
    _emit_result(telemetry, result)
    return result


def make_grad_batch(adapter: Adapter, settings: SearchSettings) -> Callable:
    """``grad_batch(deltas (C, *delta_shape)) -> (objective (C,), margins
    (C, P), grads (C, *delta_shape))``: the objective (the worst
    differentiable margin) of every candidate through the eager autograd
    rollout under ``torch.func.vmap``, one backward for the batch (the
    candidates are independent, so each gets its own gradient). The step
    runs branch-free inside one guard per candidate; a candidate whose
    flag is set (a branch the guarded step leaves out, RTA's re-solve) is
    evaluated again alone on the host-guarded eager loop."""
    eval_one = make_eval_one(adapter, settings)
    diff_idx = [PROPERTY_NAMES.index(p) for p in DIFFERENTIABLE_PROPERTIES]
    rounds = int(getattr(adapter.step, "relax_rounds", 0))
    blocks = getattr(adapter.step, "admm_blocks", None)

    def guarded(delta, flag):
        with exact2d.guarded_relax(rounds, flag, blocks):
            return eval_one(delta), flag

    def grad_batch(deltas):
        deltas = deltas.detach().to(adapter.device).requires_grad_()
        flags0 = torch.zeros(deltas.shape[0], dtype=torch.bool,
                             device=adapter.device)
        with torch.enable_grad():
            margins, flags = torch.func.vmap(guarded)(deltas, flags0)
            objective = torch.amin(margins[:, diff_idx], dim=1)
            grads, = torch.autograd.grad(objective.sum(), deltas)
        margins, objective = margins.detach(), objective.detach()
        for c in torch.nonzero(flags).flatten().tolist():
            d = deltas[c].detach().requires_grad_()
            with torch.enable_grad():
                m = eval_one(d)
                obj = torch.amin(m[diff_idx])
                g, = torch.autograd.grad(obj, d)
            margins[c], objective[c], grads[c] = m.detach(), obj.detach(), g
        return objective, margins, grads

    return grad_batch


def gradient_search(adapter: Adapter,
                    settings: SearchSettings = SearchSettings(), *,
                    telemetry=None, mesh=None) -> SearchResult:
    """Descend the worst differentiable margin w.r.t. the initial state:
    normalized-gradient steps of ``gd_lr`` metres on a batch of
    candidates (:func:`make_grad_batch`). Needs a
    ``make_adapter(differentiable=True)`` adapter."""
    if not adapter.differentiable:
        raise ValueError(
            "gradient_search needs make_adapter(differentiable=True) "
            "(swarm only — the unrolled-relax step); got a non-"
            "differentiable adapter")
    telemetry, _ = _writer(telemetry)
    grad_b = make_grad_batch(adapter, settings)
    C = max(1, settings.gd_candidates)
    deltas = (settings.perturb_scale * prng.normal(
        _engine_key(settings, "grad"), (C,) + adapter.delta_shape,
        _state_dtype(adapter))).to(adapter.device)
    best = (np.inf, None, None)
    evaluated = 0
    iters = max(1, min(settings.gd_iters, -(-settings.budget // C)))
    for it in range(iters):
        _, margins, grads = grad_b(deltas)
        evaluated += C
        worst = _worst_per_candidate(margins)
        best = _best_of(deltas, margins, worst, best, settings)
        _emit_round(telemetry, "grad", it, C, best[0],
                    int((worst < 0).sum()), evaluated)
        if best[0] < 0:
            break
        norm = torch.sqrt(torch.sum(grads ** 2, dim=(1, 2), keepdim=True))
        deltas = deltas - settings.gd_lr * (grads
                                            / torch.clamp(norm, min=1e-12))
    result = _result("grad", adapter, settings, best[1], best[2],
                     evaluated, it + 1)
    _emit_result(telemetry, result)
    return result


def cem_search(adapter: Adapter, settings: SearchSettings = SearchSettings(),
               *, telemetry=None, mesh=None, state_dir: str | None = None,
               resume: bool = True) -> SearchResult:
    """Cross-entropy refinement: fit the proposal to the elite (lowest
    worst-margin) candidates each round. ``state_dir``/``resume``: as
    :func:`random_search`, with the proposal (mean, std) persisted too."""
    settings = round_batch(settings, mesh)
    telemetry, writes = _writer(telemetry)
    B = settings.batch
    rounds = max(1, min(settings.cem_rounds, -(-settings.budget // B)))
    n_elite = max(1, int(settings.cem_elite_frac * B))
    dt_ = _state_dtype(adapter)
    dev = adapter.device
    mean = torch.zeros(adapter.delta_shape, dtype=dt_, device=dev)
    std = torch.full(adapter.delta_shape, settings.perturb_scale, dtype=dt_,
                     device=dev)
    key = _engine_key(settings, "cem")
    best = (np.inf, None, None)
    ffields = _campaign_fields("cem", adapter, settings) \
        if state_dir is not None else None
    fp = None if ffields is None else _fingerprint_of(ffields)
    r0, evaluated, best, finished, arrays = _resume_engine_state(
        state_dir, "cem", fp, resume, rounds, best, 0, ffields)
    if "mean" in arrays:
        mean = torch.as_tensor(arrays["mean"], dtype=dt_, device=dev)
        std = torch.as_tensor(arrays["std"], dtype=dt_, device=dev)
    if finished:
        result = _result("cem", adapter, settings, best[1], best[2],
                         evaluated, r0)
        _emit_result(telemetry, result)
        return result
    eval_b = make_eval_batch(adapter, settings, mesh)
    for r in range(r0, rounds):
        noise = prng.normal(prng.fold_in(key, r),
                            (B,) + adapter.delta_shape, dt_).to(dev)
        deltas = mean[None] + std[None] * noise
        margins = eval_b(deltas)
        worst = _worst_per_candidate(margins)
        evaluated += B
        order = np.argsort(worst)
        best = _best_of(deltas, margins, worst, best, settings)
        _emit_round(telemetry, "cem", r, B, best[0],
                    int((worst < 0).sum()), evaluated)
        done = bool(best[0] < 0)
        if not done:
            elite = deltas[torch.as_tensor(order[:n_elite].copy(),
                                           device=dev)]
            mean = torch.mean(elite, dim=0)
            std = torch.clamp(torch.std(elite, dim=0, correction=0),
                              min=settings.cem_std_floor)
        if state_dir is not None and writes:
            _save_round_state(state_dir, "cem", fp, next_round=r + 1,
                              evaluated=evaluated, best=best, done=done,
                              extra_arrays={"mean": mean.cpu().numpy(),
                                            "std": std.cpu().numpy()},
                              fields=ffields)
        if done:
            break
    result = _result("cem", adapter, settings, best[1], best[2],
                     evaluated, r + 1)
    _emit_result(telemetry, result)
    return result


_ENGINE_FNS = {"random": random_search, "grad": gradient_search,
               "cem": cem_search}


def falsify(scenario: str, cfg=None, *,
            settings: SearchSettings = SearchSettings(),
            engines=("random", "cem"), cbf=None,
            thresholds: PropertyThresholds | None = None,
            steps=None, telemetry=None, mesh=None,
            stop_on_find: bool = True, state_dir: str | None = None,
            resume: bool = True, device=None) -> list[SearchResult]:
    """Run the requested engines in order against one scenario config;
    every engine gets ``settings.budget`` candidates. Returns each
    engine's :class:`SearchResult`; with ``stop_on_find`` the sweep stops
    at the first engine that violates."""
    unknown = set(engines) - set(ENGINES)
    if unknown:
        raise ValueError(f"unknown engines {sorted(unknown)}; have "
                         f"{ENGINES}")
    adapter = make_adapter(scenario, cfg, cbf=cbf, steps=steps,
                           thresholds=thresholds, device=device)
    results = []
    for engine in engines:
        a = adapter
        kw = {}
        if engine == "grad":
            a = make_adapter(scenario, cfg, cbf=cbf, steps=steps,
                             thresholds=thresholds, differentiable=True,
                             unroll_relax=settings.unroll_relax,
                             device=device)
        else:
            kw = {"state_dir": state_dir, "resume": resume}
        results.append(_ENGINE_FNS[engine](a, settings, telemetry=telemetry,
                                           mesh=mesh, **kw))
        if stop_on_find and results[-1].found:
            break
    return results
