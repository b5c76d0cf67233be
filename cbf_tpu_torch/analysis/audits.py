"""Repo audits as analyser rules (counterpart: cbf_tpu/analysis/audits.py).

* AUD001 — telemetry schema drift: the port's StepOutputs/EnsembleMetrics
  and every emitter's declared event types against ``obs/schema.py``'s
  tables (equal to the JAX package's) and ``docs/API.md``, which is read
  and never written;
* AUD002 — budget-shaped tests missing ``@pytest.mark.slow`` (over
  ``tests/``, as the JAX package's);
* AUD003 — the certificate's chain depth: one fused ADMM iteration's
  longest path through serialized gather/scatter-class ops, walked under
  a ``TorchDispatchMode`` (JAX walks the jaxpr), at most
  :data:`FUSED_CHAIN_DEPTH_BOUND` and below the default path's;
* AUD004 — reproducibility: seedless ``np.random`` and draws from torch's
  global generator (no ``generator=``) in ``cbf_tpu_torch/`` and
  ``chip_smoke.py``;
* AUD007 — scenario-platform coverage: every registered scenario of the
  port has its verify adapter (``verify.search.ADAPTER_FACTORIES``),
  calibrated thresholds, parity needle in ``tests/`` and ``docs/API.md``
  row, and every ``cbf_tpu_torch/scenarios/*.py`` module registers;
* AUD008 — concurrency-map drift: the concurrency analyser's inventory of
  ``cbf_tpu_torch/`` against the port's own concurrency map, the table
  between the port-owned markers in the README's "PyTorch/CUDA port"
  section;
* AUD009 — spmd-budget liveness: ``spmd_budget.toml``'s rows against the
  SPMD analyser's entry points, by name in both directions.
"""

from __future__ import annotations

import ast
import inspect
import os
import re

from cbf_tpu_torch.analysis.registry import Finding

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _read(path: str) -> str | None:
    try:
        with open(path, encoding="utf-8") as fh:
            return fh.read()
    except OSError:
        return None


# -- AUD001: obs schema drift ----------------------------------------------

def obs_schema_audit(repo_root: str | None = None) -> list[str]:
    """One "what drifted — where" string per violation."""
    from cbf_tpu_torch.cluster import membership as cluster_membership
    from cbf_tpu_torch.cluster import router as cluster_router
    from cbf_tpu_torch.durable import journal as durable_journal
    from cbf_tpu_torch.durable import rollout as durable_rollout
    from cbf_tpu_torch.obs import flight as obs_flight
    from cbf_tpu_torch.obs import lanes as obs_lanes
    from cbf_tpu_torch.obs import schema
    from cbf_tpu_torch.obs import trace as obs_trace
    from cbf_tpu_torch.obs import watchdog
    from cbf_tpu_torch.parallel.ensemble import EnsembleMetrics
    from cbf_tpu_torch.rollout.engine import StepOutputs
    from cbf_tpu_torch.rta import monitor as rta_monitor
    from cbf_tpu_torch.scenarios.platform import dsl as scen_dsl
    from cbf_tpu_torch.serve import engine as serve_engine
    from cbf_tpu_torch.serve import ha as serve_ha
    from cbf_tpu_torch.serve import loadgen as serve_loadgen
    from cbf_tpu_torch.verify import fleet as verify_fleet
    from cbf_tpu_torch.verify import search as verify_search

    repo = repo_root or _REPO
    problems = []

    mapped_step = schema.step_output_channels()
    for field in StepOutputs._fields:
        if field in mapped_step or \
                field in schema.EXCLUDED_STEP_OUTPUT_FIELDS:
            continue
        problems.append(
            f"StepOutputs.{field} is neither a heartbeat channel "
            "(schema.HEARTBEAT_FIELDS.step_output) nor excluded with a "
            "reason (schema.EXCLUDED_STEP_OUTPUT_FIELDS)")
    mapped_ens = schema.ensemble_channels()
    for field in EnsembleMetrics._fields:
        if field in mapped_ens or \
                field in schema.EXCLUDED_ENSEMBLE_FIELDS:
            continue
        problems.append(
            f"EnsembleMetrics.{field} is neither a heartbeat channel "
            "(schema.HEARTBEAT_FIELDS.ensemble) nor excluded with a "
            "reason (schema.EXCLUDED_ENSEMBLE_FIELDS)")

    # Dangling mappings: schema entries naming fields the structs no
    # longer have.
    for f in schema.HEARTBEAT_FIELDS:
        if f.step_output is not None and \
                f.step_output not in StepOutputs._fields:
            problems.append(
                f"schema field {f.name!r} maps step_output="
                f"{f.step_output!r}, which StepOutputs does not have")
        if f.ensemble is not None and \
                f.ensemble not in EnsembleMetrics._fields:
            problems.append(
                f"schema field {f.name!r} maps ensemble={f.ensemble!r}, "
                "which EnsembleMetrics does not have")
        if f.reduce not in ("min", "max", "sum"):
            problems.append(
                f"schema field {f.name!r} has unknown reduction "
                f"{f.reduce!r}")
        if f.kind not in ("gauge", "counter"):
            problems.append(
                f"schema field {f.name!r} has unknown kind {f.kind!r}")
    for struct, excluded, table in (
            (StepOutputs, schema.EXCLUDED_STEP_OUTPUT_FIELDS,
             "EXCLUDED_STEP_OUTPUT_FIELDS"),
            (EnsembleMetrics, schema.EXCLUDED_ENSEMBLE_FIELDS,
             "EXCLUDED_ENSEMBLE_FIELDS")):
        for field, reason in excluded.items():
            if field not in struct._fields:
                problems.append(
                    f"{table} names {field!r}, which {struct.__name__} "
                    "does not have")
            if not reason.strip():
                problems.append(f"exclusion of {struct.__name__}.{field} "
                                "has no reason")

    # Emitter drift: each family's emitters must declare exactly the
    # schema's types, in order (a multi-module family as the union).
    families = (
        ("verify.search", (verify_search,), "VERIFY_EVENT_TYPES"),
        ("serve emitters (engine+trace)", (serve_engine, obs_trace),
         "SERVE_EVENT_TYPES"),
        ("serve.loadgen", (serve_loadgen,), "LOADGEN_EVENT_TYPES"),
        ("durable emitters (journal+rollout)",
         (durable_journal, durable_rollout), "DURABLE_EVENT_TYPES"),
        ("rta.monitor", (rta_monitor,), "RTA_EVENT_TYPES"),
        ("obs.flight", (obs_flight,), "FLIGHT_EVENT_TYPES"),
        ("scenarios.platform.dsl", (scen_dsl,), "SCENARIO_EVENT_TYPES"),
        ("serve.ha", (serve_ha,), "HA_EVENT_TYPES"),
        ("obs.lanes", (obs_lanes,), "LANES_EVENT_TYPES"),
        ("verify.fleet", (verify_fleet,), "FLEET_EVENT_TYPES"),
        ("cluster emitters (router+membership)",
         (cluster_router, cluster_membership), "CLUSTER_EVENT_TYPES"))
    for label, mods, types_name in families:
        emitted = tuple(t for m in mods for t in m.EMITTED_EVENT_TYPES)
        declared = tuple(getattr(schema, types_name))
        if (emitted != declared if len(mods) == 1
                else sorted(emitted) != sorted(declared)):
            problems.append(
                f"{label} EMITTED_EVENT_TYPES {emitted!r} != "
                f"obs.schema.{types_name} {declared!r} — emitter "
                "and schema drifted")
    for family in ("VERIFY", "SERVE", "DURABLE", "LOADGEN", "RTA", "FLIGHT",
                   "SCENARIO", "HA", "LANES", "FLEET", "CLUSTER"):
        fields = getattr(schema, f"{family}_EVENT_FIELDS")
        types = getattr(schema, f"{family}_EVENT_TYPES")
        for etype in fields:
            if etype not in types:
                problems.append(
                    f"{family}_EVENT_FIELDS declares {etype!r}, which is "
                    f"not in {family}_EVENT_TYPES")
        for etype in types:
            if etype not in fields:
                problems.append(
                    f"{family.lower()} event type {etype!r} has no "
                    f"{family}_EVENT_FIELDS payload declaration")

    # Emit sites: every declared type has a literal `.event("type", ...)`
    # or `._emit("type", ...)` call in its module.
    for mod in (verify_search, serve_engine, obs_trace, serve_loadgen,
                durable_journal, durable_rollout, rta_monitor, obs_flight,
                obs_lanes, scen_dsl, serve_ha, verify_fleet,
                cluster_router, cluster_membership):
        try:
            mod_tree = ast.parse(inspect.getsource(mod))
        except (OSError, TypeError):
            problems.append(f"cannot read source of {mod.__name__} for "
                            "the emit-site check")
            continue
        emit_sites = {
            node.args[0].value for node in ast.walk(mod_tree)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("event", "_emit") and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)}
        for etype in mod.EMITTED_EVENT_TYPES:
            if etype not in emit_sites:
                problems.append(
                    f"{mod.__name__} declares emitted event type {etype!r} "
                    "but has no literal .event()/._emit() call site for it")

    # Docs: every heartbeat field, alert kind and event is documented.
    api_path = os.path.join(repo, "docs", "API.md")
    api_text = _read(api_path)
    if api_text is None:
        problems.append(f"docs/API.md unreadable at {api_path}")
        api_text = ""
    if api_text:
        for f in schema.HEARTBEAT_FIELDS:
            if f"`{f.name}`" not in api_text:
                problems.append(
                    f"heartbeat field `{f.name}` is undocumented in "
                    "docs/API.md")
        for kind in watchdog.ALERT_KINDS:
            if f"`{kind}`" not in api_text:
                problems.append(
                    f"watchdog alert kind `{kind}` is undocumented in "
                    "docs/API.md")
        for family in ("VERIFY", "SERVE", "DURABLE", "LOADGEN", "RTA",
                       "FLIGHT", "SCENARIO", "HA", "LANES", "FLEET",
                       "CLUSTER"):
            for etype, fields in getattr(
                    schema, f"{family}_EVENT_FIELDS").items():
                if f"`{etype}`" not in api_text:
                    problems.append(
                        f"{family.lower()} event type `{etype}` is "
                        "undocumented in docs/API.md")
                for field in fields:
                    if f"`{field}`" not in api_text:
                        problems.append(
                            f"{family.lower()} event field `{field}` "
                            f"({etype}) is undocumented in docs/API.md")
    return problems


# -- AUD002: tier-1 slow markers -------------------------------------------

N_LIMIT = 8192
STEPS_LIMIT = 2000
CERT_N_LIMIT = 512


def _int_value(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None


def _is_slow_marked(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        # pytest.mark.slow (bare) or pytest.mark.slow(...) (called).
        target = dec.func if isinstance(dec, ast.Call) else dec
        if isinstance(target, ast.Attribute) and target.attr == "slow":
            return True
    return False


def _budget_violations(fn: ast.FunctionDef) -> list[str]:
    """Budget-shaped constructs inside one test function."""
    hits = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        kw = {k.arg: _int_value(k.value) for k in node.keywords if k.arg}
        certificate = any(
            k.arg == "certificate" and isinstance(k.value, ast.Constant)
            and k.value.value is True for k in node.keywords)
        n = kw.get("n") or kw.get("N")
        steps = kw.get("steps")
        if n is not None and n >= N_LIMIT:
            hits.append(f"n={n} >= {N_LIMIT}")
        if (certificate and n is not None and n >= CERT_N_LIMIT
                and steps is not None and steps >= STEPS_LIMIT):
            hits.append(f"certificate n={n}, steps={steps} "
                        f">= {STEPS_LIMIT}")
    # Parametrize lists can also carry the sizes.
    for dec in fn.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        target = dec.func
        if not (isinstance(target, ast.Attribute)
                and target.attr == "parametrize"):
            continue
        for arg in ast.walk(dec):
            v = _int_value(arg)
            if v is not None and v >= N_LIMIT:
                hits.append(f"parametrized size {v} >= {N_LIMIT}")
    return hits


def tier1_marker_audit(tests_dir: str | None = None) -> list[str]:
    """Return "file::test — reason" strings for every unmarked
    budget-shaped test."""
    tests_dir = tests_dir or os.path.join(_REPO, "tests")
    problems = []
    for name in sorted(os.listdir(tests_dir)):
        if not (name.startswith("test_") and name.endswith(".py")):
            continue
        path = os.path.join(tests_dir, name)
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.FunctionDef) \
                    or not node.name.startswith("test_"):
                continue
            if _is_slow_marked(node):
                continue
            for reason in _budget_violations(node):
                problems.append(f"{name}::{node.name} — {reason} "
                                "(mark @pytest.mark.slow or shrink)")
    return problems


# -- AUD003: chain-depth regression -----------------------------------------

#: Serialized memory-bound passes over the pair-row axis (ATen op names,
#: in-place and ``_impl`` spellings folded in; ``scatter*`` by prefix).
#: Elementwise ops between them add no dependent pass of their own.
HEAVY_OPS = frozenset({
    "index_select", "gather", "index", "index_put", "index_add",
    "segment_reduce", "take",
})

#: The pinned bound (the JAX package's): the fused iteration's whole
#: point is a <= 4 serialized pair-op chain.
FUSED_CHAIN_DEPTH_BOUND = 4


def _heavy_name(func) -> str | None:
    name = func.overloadpacket.__name__.rstrip("_")
    if name == "_index_put_impl":
        name = "index_put"
    if name in HEAVY_OPS or name.startswith("scatter"):
        return name
    return None


def chain_profile(settings=None, N: int = 64, k: int = 8,
                  agent_k: int | None = None, device=None) -> dict:
    """Profile one ADMM iteration of the sparse certificate solver.

    Returns {"chain_depth", "heavy_ops", "op_counts"} for one eager
    iteration of :func:`cbf_tpu_torch.solvers.sparse_admm.
    admm_iteration_spec`'s step under ``settings`` with the inner budget
    normalized to one step (``cg_iters=1``), run under a
    ``TorchDispatchMode`` that gives every tensor a depth: the largest of
    its inputs' (views included, as each view is an op of its own), plus
    one at each op of :data:`HEAVY_OPS`. ``device`` None is the card."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from cbf_tpu_torch.solvers.sparse_admm import (SparseADMMSettings,
                                                   admm_iteration_spec)

    settings = settings if settings is not None else SparseADMMSettings()
    settings = settings._replace(cg_iters=1)
    step, carry0 = admm_iteration_spec(N=N, k=k, settings=settings,
                                       agent_k=agent_k, device=device)
    depth: dict[int, int] = {}
    alive: list = []          # keeps ids unique for the walk
    counts: dict[str, int] = {}

    class _Walk(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            din = max((depth.get(id(a), 0)
                       for a in tree_flatten((args, kwargs))[0]
                       if isinstance(a, torch.Tensor)), default=0)
            heavy = _heavy_name(func)
            if heavy is not None:
                counts[heavy] = counts.get(heavy, 0) + 1
            for o in tree_flatten(out)[0]:
                if isinstance(o, torch.Tensor):
                    alive.append(o)
                    depth[id(o)] = din + (heavy is not None)
            return out

    with torch.no_grad(), _Walk():
        out = step(carry0)
    return {
        "chain_depth": max((depth.get(id(o), 0) for o in out), default=0),
        "heavy_ops": sum(counts.values()),
        "op_counts": dict(sorted(counts.items())),
    }


def chain_depth_audit(device=None) -> list[str]:
    """The regression gate as audit problems: fused <= pinned bound,
    and fused strictly shallower than the default path."""
    from cbf_tpu_torch.solvers.sparse_admm import SparseADMMSettings

    fused = chain_profile(SparseADMMSettings(fused=True, ksolve="chebyshev"),
                          device=device)
    default = chain_profile(SparseADMMSettings(), device=device)
    problems = []
    if fused["chain_depth"] > FUSED_CHAIN_DEPTH_BOUND:
        problems.append(
            f"fused ADMM iteration chain_depth={fused['chain_depth']} "
            f"exceeds the pinned bound {FUSED_CHAIN_DEPTH_BOUND} "
            f"(op_counts={fused['op_counts']})")
    if fused["chain_depth"] >= default["chain_depth"]:
        problems.append(
            f"fused chain_depth={fused['chain_depth']} is not shallower "
            f"than the default path's {default['chain_depth']} — the "
            "fusion no longer buys anything")
    return problems


# -- AUD004: reproducibility -----------------------------------------------

#: np.random attributes that construct or seed an explicit generator.
_NP_RANDOM_CONSTRUCTORS = frozenset({
    "default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
    "MT19937", "SFC64", "BitGenerator", "RandomState", "get_state",
})

#: torch's sampling functions and in-place samplers: each draws from the
#: global generator unless it is handed ``generator=``.
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
})
_TORCH_INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "cauchy_", "log_normal_", "geometric_",
})
#: Global-state seeding is action at a distance, not a threaded seed.
_TORCH_GLOBAL_SEEDING = frozenset({"manual_seed", "seed"})

#: Source trees the reproducibility contract covers.
_AUD004_TREES = ("cbf_tpu_torch", "chip_smoke.py")


def _np_random_attr(node: ast.Call) -> str | None:
    """The attribute name X for a call shaped ``<name>.random.X(...)``
    (np/numpy aliases), else None."""
    fn = node.func
    if not (isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Attribute)
            and fn.value.attr == "random"
            and isinstance(fn.value.value, ast.Name)
            and fn.value.value.id in ("np", "numpy")):
        return None
    return fn.attr


def _torch_attr(node: ast.Call) -> str | None:
    """X for a call shaped ``torch.X(...)``, else None."""
    fn = node.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id == "torch":
        return fn.attr
    return None


def _has_generator(node: ast.Call) -> bool:
    return any(k.arg == "generator" for k in node.keywords)


def reproducibility_audit(repo_root: str | None = None) -> list[str]:
    """AUD004: every stochastic entry point threads an explicit seed —
    verify runs are archived as (config, seed, perturbation) and must
    replay bit for bit from that record. Flags, in ``cbf_tpu_torch/`` and
    ``chip_smoke.py``:

    * ``np.random.default_rng()`` with no seed argument, and any draw on
      numpy's global generator (``np.random.seed`` included);
    * a torch sampling call (``torch.rand``/``randn``/``randint``/
      ``randperm``/``normal``/``bernoulli``/``multinomial``/``poisson``
      and their ``*_like`` forms, the in-place ``Tensor.uniform_``/
      ``normal_``/... samplers) with no ``generator=``, and
      ``torch.manual_seed``/``torch.seed`` (global-state seeding).

    ``utils/prng.py``'s threefry streams are exempt by construction: they
    take a key."""
    repo = repo_root or _REPO
    problems = []
    paths = []
    for tree in _AUD004_TREES:
        root = os.path.join(repo, tree)
        if os.path.isfile(root):
            paths.append(root)
            continue
        for dirpath, dirs, files in os.walk(root):
            dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")]
            paths.extend(os.path.join(dirpath, name)
                         for name in sorted(files) if name.endswith(".py"))
    for path in sorted(paths):
        rel = os.path.relpath(path, repo)
        with open(path, encoding="utf-8") as fh:
            try:
                tree = ast.parse(fh.read(), filename=path)
            except SyntaxError as e:
                problems.append(f"{rel}: unparseable ({e.msg})")
                continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            attr = _np_random_attr(node)
            if attr == "default_rng":
                if not (node.args or node.keywords):
                    problems.append(
                        f"{rel}:{node.lineno}: np.random.default_rng() "
                        "with no seed — thread an explicit seed so the "
                        "run is replayable")
            elif attr is not None and attr not in _NP_RANDOM_CONSTRUCTORS:
                problems.append(
                    f"{rel}:{node.lineno}: np.random.{attr}(...) draws "
                    "from the seedless GLOBAL generator — use "
                    "np.random.default_rng(seed)")
            tattr = _torch_attr(node)
            if tattr in _TORCH_DRAWS and not _has_generator(node):
                problems.append(
                    f"{rel}:{node.lineno}: torch.{tattr}(...) with no "
                    "generator= draws from torch's GLOBAL generator — "
                    "pass a seeded torch.Generator")
            elif tattr in _TORCH_GLOBAL_SEEDING:
                problems.append(
                    f"{rel}:{node.lineno}: torch.{tattr}(...) seeds "
                    "torch's GLOBAL generator — pass a seeded "
                    "torch.Generator instead")
            elif tattr is None and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _TORCH_INPLACE_DRAWS \
                    and not _has_generator(node):
                problems.append(
                    f"{rel}:{node.lineno}: .{node.func.attr}(...) with "
                    "no generator= draws from torch's GLOBAL generator — "
                    "pass a seeded torch.Generator")
    return problems


# -- AUD007: scenario-platform coverage ------------------------------------

def scenario_coverage_audit(repo_root: str | None = None) -> list[str]:
    """AUD007: the port's scenario registry's full-stack enrollment
    contract. Every registered scenario's ``adapter`` key must exist in
    ``verify.search.ADAPTER_FACTORIES`` and its default config must have
    calibrated property thresholds; its ``parity_test`` needle must
    appear in ``tests/``; a hand-written builtin must have a backticked
    row in ``docs/API.md`` (read only). The inverse leg: a
    ``cbf_tpu_torch/scenarios/*.py`` module that never registers is
    invisible to verify/serve and fails here."""
    from cbf_tpu_torch.scenarios.platform import registry as scen_registry
    from cbf_tpu_torch.verify import properties as verify_properties
    from cbf_tpu_torch.verify import search as verify_search

    repo = repo_root or _REPO
    problems: list[str] = []
    test_blobs = []
    for dirpath, _dirs, files in os.walk(os.path.join(repo, "tests")):
        for name in sorted(files):
            if name.endswith(".py"):
                test_blobs.append(_read(os.path.join(dirpath, name)) or "")
    test_blob = "\n".join(test_blobs)

    api_path = os.path.join(repo, "docs", "API.md")
    api_text = _read(api_path)
    if api_text is None:
        problems.append(f"docs/API.md unreadable at {api_path}")
        api_text = ""

    for entry in scen_registry.entries():
        if entry.adapter not in verify_search.ADAPTER_FACTORIES:
            problems.append(
                f"scenario {entry.name!r}: adapter key {entry.adapter!r} "
                "has no verify.search.ADAPTER_FACTORIES entry — "
                "falsification cannot enroll it")
        else:
            try:
                verify_properties.thresholds_for(entry.name,
                                                 entry.make_config())
            except ValueError as e:
                problems.append(
                    f"scenario {entry.name!r}: no calibrated property "
                    f"thresholds ({e})")
        if entry.parity_test not in test_blob:
            problems.append(
                f"scenario {entry.name!r}: parity-test needle "
                f"{entry.parity_test!r} not found in tests/ — its twin "
                "is uncovered")
        if not entry.generated and api_text \
                and f"`{entry.name}`" not in api_text:
            problems.append(
                f"scenario {entry.name!r} has no `{entry.name}` row in "
                "docs/API.md")

    registered_mods = {e.module.rsplit(".", 1)[-1]
                       for e in scen_registry.entries()}
    scen_dir = os.path.join(repo, "cbf_tpu_torch", "scenarios")
    for name in sorted(os.listdir(scen_dir)):
        if not name.endswith(".py") or name.startswith("_"):
            continue
        if name[:-3] not in registered_mods:
            problems.append(
                f"cbf_tpu_torch/scenarios/{name} is not registered with "
                "scenarios.platform.registry — a stale scenario module "
                "the stack cannot see (register it or remove it)")
    return problems


# -- AUD008: concurrency-map drift ----------------------------------------

#: The port's concurrency map: the README table between these markers.
MAP_DOC = "README.md"
MAP_START = "<!-- torch-concurrency-map:start -->"
MAP_END = "<!-- torch-concurrency-map:end -->"


def concurrency_map_audit(repo_root: str | None = None) -> list[str]:
    """AUD008: the port's threading inventory vs its concurrency map.

    Every lock/condition/event attribute, thread entry point,
    signal/atexit handler and module-level lock the concurrency analyser
    discovers in ``cbf_tpu_torch/`` must have a backticked row in the
    README's port map (between :data:`MAP_START` and :data:`MAP_END`);
    the inverse leg flags a backticked ``Class.attr`` row the analyser no
    longer discovers."""
    from cbf_tpu_torch.analysis import concurrency

    repo = repo_root or _REPO
    inv = concurrency.analyze_paths(
        [os.path.join(repo, "cbf_tpu_torch")], repo_root=repo).inventory
    doc_path = os.path.join(repo, MAP_DOC)
    text = _read(doc_path)
    if text is None:
        return [f"{MAP_DOC} unreadable at {doc_path}"]
    start, end = text.find(MAP_START), text.find(MAP_END)
    if start < 0 or end < 0 or end < start:
        return [f"{MAP_DOC} has no port concurrency-map markers "
                f"({MAP_START} ... {MAP_END}) — the map table is missing"]
    map_text = text[start:end]

    expected: set[str] = set()
    for cls_name, rec in inv.items():
        for attr in rec["locks"]:
            expected.add(f"{cls_name}.{attr}")
        for attr in rec["conditions"]:
            expected.add(f"{cls_name}.{attr}")
        for attr in rec["events"]:
            expected.add(f"{cls_name}.{attr}")
        for t in rec["threads"]:
            if t["entry"]:
                expected.add(f"{cls_name}.{t['entry']}")
        for qual in rec["handlers"]:
            # `Cls.method.nested` documents as the enclosing method row.
            expected.add(".".join(qual.split(".")[:2]))
    problems = [
        f"discovered threading primitive `{needle}` has no row in the "
        f"{MAP_DOC} port concurrency map — document the new lock/thread "
        "(who holds it, who runs it) or remove it"
        for needle in sorted(expected) if f"`{needle}`" not in map_text]
    # Inverse: every backticked Class.attr-shaped token in the map must
    # still be discovered.
    for token in sorted(set(re.findall(r"`([A-Za-z_][\w.]*)`", map_text))):
        parts = token.split(".")
        if len(parts) != 2 or not parts[0][0].isupper():
            continue
        if token not in expected:
            problems.append(
                f"concurrency-map row `{token}` matches no discovered "
                "primitive — the map describes a lock/thread that no "
                "longer exists (delete the row)")
    return problems


# -- AUD009: spmd-budget liveness -------------------------------------------

def spmd_budget_audit(repo_root: str | None = None) -> list[str]:
    """Both directions of the budget <-> entry-point mapping, plus file
    well-formedness. Names only: no world is started — the cheap half of
    the SPMD gate."""
    from cbf_tpu_torch.analysis import mesh_budget
    from cbf_tpu_torch.analysis.spmd_rules import spmd_entrypoint_names

    path = os.path.join(repo_root or _REPO, "cbf_tpu_torch", "analysis",
                        "spmd_budget.toml")
    try:
        budget = mesh_budget.load(path)
    except mesh_budget.BudgetError as e:
        return [str(e)]
    return mesh_budget.liveness_problems(budget, spmd_entrypoint_names())


# -- runner ----------------------------------------------------------------

def run_audits(repo_root: str | None = None, device=None) -> list[Finding]:
    """All repo audits as Findings (the ``lint --all`` surface); the
    chain-depth audit runs its iteration on ``device`` (None = the
    card)."""
    findings = []
    for msg in obs_schema_audit(repo_root):
        findings.append(Finding("AUD001", "cbf_tpu_torch/obs/schema.py", 0,
                                0, "<schema>", msg))
    for msg in tier1_marker_audit(
            os.path.join(repo_root or _REPO, "tests")):
        findings.append(Finding("AUD002", "tests/", 0, 0, "<tests>", msg))
    for msg in chain_depth_audit(device):
        findings.append(Finding("AUD003",
                                "cbf_tpu_torch/solvers/sparse_admm.py",
                                0, 0, "<chain>", msg))
    for msg in reproducibility_audit(repo_root):
        findings.append(Finding("AUD004", msg.split(":", 1)[0], 0, 0,
                                "<reproducibility>", msg))
    for msg in scenario_coverage_audit(repo_root):
        findings.append(Finding(
            "AUD007", "cbf_tpu_torch/scenarios/platform/registry.py", 0, 0,
            "<scenario>", msg))
    for msg in concurrency_map_audit(repo_root):
        findings.append(Finding("AUD008",
                                "cbf_tpu_torch/analysis/concurrency.py",
                                0, 0, "<concurrency>", msg))
    for msg in spmd_budget_audit(repo_root):
        findings.append(Finding("AUD009",
                                "cbf_tpu_torch/analysis/spmd_budget.toml",
                                0, 0, "<spmd-budget>", msg))
    return findings
