"""The port's SPMD analyser (cbf_tpu_torch/analysis/spmd_rules.py and
mesh_budget.py), the chain-depth audit (AUD003) and the fused ADMM
iteration's layout, held to the JAX package's on the CPU.

- Each AST rule the port keeps (SP005, SP006) fires on its bad source
  string and is silent on its clean one; the two collective owners keep
  their collectives. SP004 has no AST half in the port (no shard_map).
- The census by kind: a 2-rank gloo world calls each ``Axis`` collective
  and reads ``mesh.census()`` (counts and operand bytes under the JAX
  package's keys; the totals keep their meaning).
- The budget gate, pure: the JAX package's five ``compare`` cases, plus
  SP002 skipped where no peak was measured; load validation (reason,
  schema, unknown kind); liveness both ways; the writer round trip (and
  the CPU keeping a row's peak); the fallback parser equal to tomllib;
  each package's ``load`` reading the other's budget file.
- The live census: one 4-rank world per module (device "cpu", one torch
  thread per rank) runs the five entry points; its reports are complete
  and clean, match the committed spmd_budget.toml at 0 findings, and a
  hand-bumped row fails ``run_lint`` with SP001. SP003 from a synthetic
  report; an entry that raises is SP004 and the world runs on without
  it.
- The JSON/CLI contract: ``spmd_census`` only when the pass ran,
  ``lint --spmd --json --device cpu`` exits 0.
- AUD003 (tests/test_fused_batched.py's chain-depth tests): the fused
  iteration's chain is <= 4 and below the default path's, the default
  path's equals JAX's ``chain_profile`` of the same problem, the
  agent-major path is analysable. AUD009's stale and missing rows.
- The fused solve's slot layout is bit-equal to the former row-order
  iteration, whose two-pass transpose (a gather into segment order, then
  ``segment_reduce``) is copied inline below: u, the residuals and the
  carry, cold and warm, float32 and float64, generic and agent-major
  rows, Chebyshev and CG.
"""

import json
import os
import tomllib

import numpy as np
import pytest
import torch

from cbf_tpu_torch.analysis import mesh_budget, spmd_rules
from cbf_tpu_torch.analysis.report import run_lint

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
MODULE = os.path.splitext(os.path.basename(__file__))[0]
_FIXTURES = os.path.join(HERE, "analysis_fixtures")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def census():
    """The live census of every entry point: one 4-rank world on the CPU
    (cached per process, so the lint runs below reuse it)."""
    return spmd_rules.entrypoint_reports(device="cpu")


@pytest.fixture
def empty_baseline(tmp_path):
    p = tmp_path / "none.toml"
    p.write_text("")
    return str(p)


# -- AST rules: one bad + one clean source each -----------------------------

BAD = {
    "SP005": '''"""SP005 bad: axis names the mesh does not have."""
from cbf_tpu_torch.parallel.mesh import resolve_axis


def reduce_rows(mesh, x, solve):
    ax = mesh.axis("agents")                 # SP005
    tiles = resolve_axis("tile")             # SP005
    return solve(ax.psum(x), axis_name="rows") + tiles.index   # SP005
''',
    "SP006": '''"""SP006 bad: raw collectives outside parallel/mesh.py and
parallel/multihost.py."""
import torch
import torch.distributed as dist
from torch.distributed import all_gather


def total(x):
    dist.all_reduce(x)                       # SP006
    torch.distributed.barrier()              # SP006
    parts = [torch.empty_like(x) for _ in range(2)]
    all_gather(parts, x)                     # SP006
    return torch.cat(parts)
''',
}

CLEAN = {
    "SP005": '''"""SP005 clean: the canonical axes, and names not given literally."""
from cbf_tpu_torch.parallel.mesh import resolve_axis


def reduce_rows(mesh, x, solve, name):
    ax = mesh.axis("sp")
    dp = resolve_axis("dp")
    other = mesh.axis(name)                  # not a literal: out of scope
    return solve(ax.psum(x), axis_name="sp") + dp.index + other.index
''',
    "SP006": '''"""SP006 clean: collectives through an Axis and the multihost
helpers; torch.distributed's queries are not collectives."""
import torch.distributed as dist

from cbf_tpu_torch.parallel import multihost


def total(mesh, x):
    rank = dist.get_rank() if dist.is_initialized() else 0
    multihost.barrier()
    return mesh.axis("dp").psum(x) + rank
''',
}

_SP_AST_RULES = sorted(BAD)


@pytest.mark.parametrize("rule", _SP_AST_RULES)
def test_sp_rule_fires_on_bad_fixture(rule):
    findings = spmd_rules.lint_spmd_source(BAD[rule], f"bad_{rule}.py")
    assert {f.rule for f in findings} == {rule}, findings
    assert len(findings) == 3, findings


@pytest.mark.parametrize("rule", _SP_AST_RULES)
def test_sp_rule_silent_on_clean_fixture(rule):
    findings = spmd_rules.lint_spmd_source(CLEAN[rule], f"clean_{rule}.py")
    assert findings == [], findings


@pytest.mark.parametrize("owner", spmd_rules.COLLECTIVE_OWNERS)
def test_shard_map_owner_keeps_its_import(owner):
    """The collective owners (the port's counterpart of the shard_map
    compat wrapper) keep their raw collectives — the path exemption holds
    for the real files — and the same source elsewhere is flagged."""
    with open(os.path.join(_ROOT, owner)) as fh:
        src = fh.read()
    assert [f for f in spmd_rules.lint_spmd_source(src, owner)
            if f.rule == "SP006"] == []
    assert any(f.rule == "SP006" for f in
               spmd_rules.lint_spmd_source(src, "elsewhere.py"))


def test_sp004_has_no_ast_half():
    """JAX's in_specs-arity fixture is not a port finding: the port has
    no shard_map, and SP004 is only an entry that fails in its world."""
    with open(os.path.join(_FIXTURES, "bad_sp004.py")) as fh:
        assert spmd_rules.lint_spmd_source(fh.read(), "bad_sp004.py") == []


def test_repo_spmd_ast_clean():
    """The port and chip_smoke.py: no stray axis name or raw collective."""
    assert spmd_rules.lint_spmd_paths(
        [os.path.join(_ROOT, "cbf_tpu_torch"),
         os.path.join(_ROOT, "chip_smoke.py")], repo_root=_ROOT) == []


# -- the census by kind ------------------------------------------------------

def _census_kinds_rank():
    """One rank of a (1, 2) world: each Axis collective once, then the
    census; and a size-1 axis, which issues none."""
    from cbf_tpu_torch.parallel import mesh as pmesh

    ax = pmesh.make_mesh(1, 2, devices="cpu").axis("sp")
    pmesh.zero_counts()
    ax.psum(torch.ones(4, 8))
    ax.pmax(torch.ones(4, 8))
    ax.all_gather(torch.ones(16))
    ax.ppermute(torch.ones(2, 2), [(0, 1), (1, 0)])
    out = {"census": pmesh.census(), "total": pmesh.COUNTS["collectives"]}
    pmesh.zero_counts()
    one = pmesh.Axis("dp", 1)
    one.psum(torch.ones(3))
    one.all_gather(torch.ones(3))
    out["size1"] = pmesh.census()
    return out


def test_collective_census_counts_and_bytes():
    from cbf_tpu_torch.parallel.launch import run_world
    from cbf_tpu_torch.parallel.mesh import CENSUS_KINDS

    assert CENSUS_KINDS == tuple(spmd_rules.COLLECTIVE_KINDS)
    for rank in run_world(f"{MODULE}:_census_kinds_rank", 2,
                          sys_path=(HERE,), timeout_s=300):
        census = rank["census"]
        assert set(census) == set(spmd_rules.COLLECTIVE_KINDS)
        # psum and pmax are all_reduce, on their operands' bytes.
        assert census["all_reduce"] == {"count": 2, "bytes": 2 * 4 * 8 * 4}
        assert census["all_gather"] == {"count": 1, "bytes": 16 * 4}
        assert census["ppermute"] == {"count": 1, "bytes": 2 * 2 * 4}
        assert census["reduce_scatter"] == {"count": 0, "bytes": 0}
        assert census["all_to_all"] == {"count": 0, "bytes": 0}
        assert rank["total"] == 4
        assert all(v == {"count": 0, "bytes": 0}
                   for v in rank["size1"].values())


# -- budget gate: pure --------------------------------------------------------

def _report(mesh="dp=4", peak=1000, **counts):
    colls = {k: 0 for k in spmd_rules.COLLECTIVE_KINDS}
    colls.update(counts)
    return {"mesh": mesh, "peak_bytes": peak, "collectives": colls,
            "collective_bytes": {k: 64 * c for k, c in colls.items()}}


def _row(mesh="dp=4", peak=1000, tolerance=0.5, **counts):
    return mesh_budget.BudgetRow("e", mesh, dict(counts), peak,
                                 tolerance, "pinned by test")


def test_compare_clean_and_cheaper_pass_silently():
    row = _row(all_reduce=3, peak=1000)
    assert mesh_budget.compare("e", _report(all_reduce=3), row) == []
    # fewer collectives / smaller peak: silent (asymmetric gate)
    assert mesh_budget.compare(
        "e", _report(all_reduce=1, peak=10), row) == []


def test_compare_missing_row_is_sp001():
    (f,) = mesh_budget.compare("e", _report(), None)
    assert f.rule == "SP001" and "no budget row" in f.message


def test_compare_mesh_mismatch_is_sp001():
    findings = mesh_budget.compare("e", _report(mesh="dp=2,sp=2"),
                                   _row(mesh="dp=4"))
    assert [f.rule for f in findings] == ["SP001"]
    assert "census basis changed" in findings[0].message


def test_compare_new_kind_and_count_increase_are_sp001():
    row = _row(all_reduce=2)
    (f,) = mesh_budget.compare("e", _report(all_reduce=3), row)
    assert f.rule == "SP001" and "count increase" in f.message
    (f,) = mesh_budget.compare("e", _report(all_reduce=2, all_gather=1),
                               row)
    assert f.rule == "SP001" and "new collective kind" in f.message


def test_compare_peak_regression_is_sp002():
    row = _row(peak=1000, tolerance=0.5)
    assert mesh_budget.compare("e", _report(peak=1500), row) == []
    (f,) = mesh_budget.compare("e", _report(peak=1501), row)
    assert f.rule == "SP002" and "1500 B" in f.message
    # The CPU measures no peak: SP002 is skipped, SP001 still gates.
    assert mesh_budget.compare("e", _report(peak=None), row) == []
    (f,) = mesh_budget.compare("e", _report(peak=None, ppermute=1), row)
    assert f.rule == "SP001"


def test_budget_requires_reason(tmp_path):
    p = tmp_path / "b.toml"
    p.write_text('schema = 1\n\n[[entry]]\nname = "x"\nmesh = "dp=4"\n'
                 'peak_bytes = 1\ntolerance = 0.0\nreason = ""\n')
    with pytest.raises(mesh_budget.BudgetError, match="no reason"):
        mesh_budget.load(str(p))


def test_budget_rejects_unknown_kind_and_schema(tmp_path):
    p = tmp_path / "b.toml"
    p.write_text('schema = 1\n\n[[entry]]\nname = "x"\nmesh = "dp=4"\n'
                 'peak_bytes = 1\nreason = "r"\n\n[entry.collectives]\n'
                 'broadcast = 2\n')
    with pytest.raises(mesh_budget.BudgetError, match="unknown collective"):
        mesh_budget.load(str(p))
    p.write_text("schema = 2\n")
    with pytest.raises(mesh_budget.BudgetError, match="schema"):
        mesh_budget.load(str(p))


@pytest.mark.parametrize("text", [
    'schema = 1\n\n[[entry]]\nname = "x"\nmesh = "dp=4"\n'
    'peak_bytes = 1\nreason = ""\n',
    'schema = 1\n\n[[entry]]\nname = "x"\nmesh = "dp=4"\n'
    'peak_bytes = 1\nreason = "r"\n\n[entry.collectives]\nbroadcast = 2\n',
    "schema = 2\n",
    'schema = 1\n\n[[entry]]\nname = "x"\nmesh = "dp=4"\n'
    'peak_bytes = -1\nreason = "r"\n',
    'schema = 1\n\n[[entry]]\nname = "x"\nmesh = "dp=4"\n'
    'peak_bytes = 1\nreason = "r"\n\n[[entry]]\nname = "x"\n'
    'mesh = "dp=4"\npeak_bytes = 1\nreason = "r"\n',
], ids=["reason", "kind", "schema", "peak", "duplicate"])
def test_budget_error_texts_equal_jax(tmp_path, text):
    """Every BudgetError text is the JAX package's, path aside."""
    from cbf_tpu.analysis import mesh_budget as jbudget

    p = tmp_path / "b.toml"
    p.write_text(text)
    with pytest.raises(mesh_budget.BudgetError) as ours:
        mesh_budget.load(str(p))
    with pytest.raises(jbudget.BudgetError) as theirs:
        jbudget.load(str(p))
    assert str(ours.value) == str(theirs.value)


def test_budget_liveness_both_directions():
    budget = mesh_budget.Budget(1, {"stale_row": _row()._replace(
        name="stale_row")})
    problems = mesh_budget.liveness_problems(budget, ["live_entry"])
    assert len(problems) == 2
    assert any("live_entry" in p and "no spmd_budget" in p
               for p in problems)
    assert any("stale_row" in p and "stale budget row" in p
               for p in problems)


def test_budget_writer_roundtrip(tmp_path):
    reports = {"a": _report(all_reduce=2, peak=500),
               "b": _report(mesh="unsharded", peak=100)}
    p = str(tmp_path / "budget.toml")
    mesh_budget.write(reports, p, reason="seeded by test")
    budget = mesh_budget.load(p)
    assert set(budget.entries) == {"a", "b"}
    for name, rep in reports.items():
        assert mesh_budget.compare(name, rep, budget.entries[name]) == []
    # unchanged rows keep their reason without a fresh one...
    mesh_budget.write(reports, p)
    assert mesh_budget.load(p).entries["a"].reason == "seeded by test"
    # ...changed rows demand one...
    reports["a"]["collectives"]["all_gather"] = 1
    with pytest.raises(mesh_budget.BudgetError, match="new or changed"):
        mesh_budget.write(reports, p)
    mesh_budget.write(reports, p, reason="gather added deliberately")
    row = mesh_budget.load(p).entries["a"]
    assert row.reason == "gather added deliberately"
    assert row.collectives == {"all_reduce": 2, "all_gather": 1}
    # ...and dropped entry points drop their rows (AUD009's stale case)
    del reports["b"]
    mesh_budget.write(reports, p, reason="b retired")
    assert set(mesh_budget.load(p).entries) == {"a"}


def test_budget_writer_keeps_peak_without_measurement(tmp_path):
    """On the CPU (peak None) an unchanged census leaves the row alone,
    and a changed one keeps the row's peak measured on the card."""
    p = str(tmp_path / "budget.toml")
    mesh_budget.write({"a": _report(all_reduce=2, peak=4096)}, p,
                      reason="measured on the card")
    cpu = {"a": _report(all_reduce=2, peak=None)}
    mesh_budget.write(cpu, p)
    row = mesh_budget.load(p).entries["a"]
    assert row.peak_bytes == 4096 and row.reason == "measured on the card"
    cpu["a"]["collectives"]["ppermute"] = 1
    mesh_budget.write(cpu, p, reason="halo ring added")
    row = mesh_budget.load(p).entries["a"]
    assert row.peak_bytes == 4096 and row.collectives["ppermute"] == 1


def test_budget_fallback_parser_matches_tomli():
    """The fallback reader parses what render() writes, and the committed
    file, to what tomllib parses."""
    rows = [_row(all_reduce=9, all_gather=1)._replace(name="a"),
            _row(mesh="unsharded", peak=7)._replace(name="b")]
    text = mesh_budget.render(rows)
    parsed = mesh_budget._parse_toml(text)
    assert parsed == tomllib.loads(text)
    assert parsed["schema"] == 1
    by_name = {e["name"]: e for e in parsed["entry"]}
    assert by_name["a"]["collectives"] == {"all_gather": 1,
                                           "all_reduce": 9}
    assert by_name["b"]["peak_bytes"] == 7
    assert by_name["b"]["tolerance"] == 0.5
    with open(mesh_budget.DEFAULT_PATH) as fh:
        committed = fh.read()
    assert mesh_budget._parse_toml(committed) == tomllib.loads(committed)


@pytest.mark.parametrize("which", ["jax_reads_port", "port_reads_jax"])
def test_budget_load_cross_package(which):
    """Each package's load reads the other's budget file to equal rows."""
    from cbf_tpu.analysis import mesh_budget as jbudget

    path = (mesh_budget.DEFAULT_PATH if which == "jax_reads_port"
            else jbudget.DEFAULT_PATH)
    ours = {n: tuple(r) for n, r in mesh_budget.load(path).entries.items()}
    theirs = {n: tuple(r) for n, r in jbudget.load(path).entries.items()}
    assert ours == theirs and len(ours) == 5


# -- the census world: live repo ---------------------------------------------

def test_entrypoint_reports_complete_and_clean(census):
    """Every sharded entry point runs in the 4-rank world with no
    findings, at its mesh; the CPU measures no peak (SP002/SP003 skipped)
    and the serve hot path issues zero collectives."""
    reports, findings = census
    assert findings == []
    assert set(reports) == set(spmd_rules.spmd_entrypoint_names())
    meshes = {e.name: e.mesh for e in spmd_rules.spmd_entrypoints()}
    for name, rep in reports.items():
        assert rep["mesh"] == meshes[name]
        assert rep["peak_bytes"] is None and rep["shrink"] is None
        assert set(rep["collectives"]) == set(spmd_rules.COLLECTIVE_KINDS)
    lockstep = reports["lockstep_chunk"]["collectives"]
    assert all(c == 0 for c in lockstep.values()), lockstep
    spatial = reports["spatial_rollout"]["collectives"]
    assert spatial["ppermute"] > 0 and spatial["all_gather"] > 0


def test_committed_budget_matches_live_census(census):
    """The acceptance bar: the fresh census vs the checked-in
    spmd_budget.toml at 0 findings, a row per entry point."""
    reports, _ = census
    budget = mesh_budget.load()
    assert set(budget.entries) == set(reports)
    for name, rep in reports.items():
        assert mesh_budget.compare(
            name, rep, budget.entries[name]) == [], name
        row = budget.entries[name]
        # The committed census is the live one exactly, not only under it.
        assert row.collectives == {k: c for k, c in
                                   rep["collectives"].items() if c}, name
        assert "CPU does not measure peak memory" in row.reason, name


def test_replicated_intermediate_trips_sp003():
    """A per-rank peak that does not shrink from the one-rank run of the
    same global problem trips SP003 above the floor; a sharded peak, a
    small one, an unsharded entry and the CPU's unmeasured peak pass."""
    big = 8 * spmd_rules.REPLICATION_FLOOR_BYTES

    def rep(peak, base, mesh="dp=4"):
        return {"mesh": mesh, "peak_bytes": peak,
                "baseline_peak_bytes": base}

    (f,) = spmd_rules.replication_findings("probe_bad", rep(big, big))
    assert f.rule == "SP003" and "shrinks only 1.00x" in f.message
    assert spmd_rules.replication_findings(
        "probe_good", rep(big, 4 * big)) == []
    assert spmd_rules.replication_findings(
        "probe_small", rep(1024, 1024)) == []
    assert spmd_rules.replication_findings(
        "probe_serve", rep(big, big, mesh="unsharded")) == []
    assert spmd_rules.replication_findings(
        "probe_cpu", rep(None, None)) == []


def test_failed_lowering_is_sp004_not_a_crash():
    """An entry that raises on its ranks is SP004, and the world runs the
    other entries without it."""
    broken = spmd_rules.SpmdEntry(
        "probe_broken", "dp=2", (2, 1),
        "cbf_tpu_torch.analysis.spmd_rules:no_such_entry")
    rep, findings = spmd_rules.analyze_entry(broken, device="cpu")
    assert rep == {} and [f.rule for f in findings] == ["SP004"]
    lockstep = next(e for e in spmd_rules.spmd_entrypoints()
                    if e.name == "lockstep_chunk")
    reports, findings = spmd_rules.run_entries([broken, lockstep],
                                               device="cpu")
    assert [(f.rule, f.symbol) for f in findings] == [
        ("SP004", "probe_broken")]
    assert "failed to run in its dp=2 world" in findings[0].message
    assert "AttributeError" in findings[0].message
    assert set(reports) == {"lockstep_chunk"}


def test_hand_bumped_budget_fails_lint(census, tmp_path, monkeypatch,
                                       empty_baseline):
    """The injected-regression gate: tighten one committed row below the
    measured census and the full runner exits nonzero with a typed SP001
    (SP002 needs the card's peak)."""
    rows = list(mesh_budget.load().entries.values())
    bumped = [(r._replace(collectives={}, peak_bytes=1, tolerance=0.0)
               if r.name == "sharded_rollout" else r) for r in rows]
    p = tmp_path / "budget.toml"
    p.write_text(mesh_budget.render(bumped))
    monkeypatch.setattr(mesh_budget, "DEFAULT_PATH", str(p))

    target = tmp_path / "clean_sp005.py"
    target.write_text(CLEAN["SP005"])
    res = run_lint([str(target)], repo_root=_ROOT, spmd=True,
                   baseline_path=empty_baseline, device="cpu")
    assert res.exit_code == 1
    assert {f.rule for f in res.active} == {"SP001"}
    # the regression is localized: other rows still pass
    assert all(f.symbol == "sharded_rollout" for f in res.active)


# -- JSON / CLI contract -------------------------------------------------------

def test_census_key_only_when_pass_ran(census, tmp_path, empty_baseline):
    """Same contract as lock_order_graph: the JSON key exists iff the
    pass ran, so plain-lint payloads stay byte-identical."""
    target = tmp_path / "clean_sp005.py"
    target.write_text(CLEAN["SP005"])
    plain = run_lint([str(target)], baseline_path=empty_baseline)
    assert "spmd_census" not in plain.as_dict()
    census_json = run_lint([str(target)], spmd=True, device="cpu",
                           baseline_path=empty_baseline
                           ).as_dict()["spmd_census"]
    assert census_json["schema"] == 1
    assert set(census_json["entrypoints"]) == set(
        spmd_rules.spmd_entrypoint_names())


def test_cli_lint_spmd_json(census, tmp_path, empty_baseline, capsys):
    from cbf_tpu_torch.__main__ import main

    target = tmp_path / "clean_sp005.py"
    target.write_text(CLEAN["SP005"])
    rc = main(["lint", "--spmd", "--json", "--device", "cpu",
               "--baseline", empty_baseline, str(target)])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out)
    census_json = payload["spmd_census"]
    assert census_json["devices"] == spmd_rules.WORLD_SIZE
    assert census_json["device"] == "cpu"
    rollout = census_json["entrypoints"]["sharded_rollout"]
    assert rollout["mesh"] == "dp=2,sp=2"
    assert rollout["shrink"] is None


# -- audits --------------------------------------------------------------------

def test_aud009_flags_stale_and_missing_rows(tmp_path):
    from cbf_tpu_torch.analysis.audits import spmd_budget_audit

    d = tmp_path / "cbf_tpu_torch" / "analysis"
    d.mkdir(parents=True)
    live = spmd_rules.spmd_entrypoint_names()
    rows = [mesh_budget.BudgetRow(live[0], "dp=4", {}, 1, 0.0, "r"),
            mesh_budget.BudgetRow("retired_entry", "dp=4", {}, 1, 0.0,
                                  "r")]
    (d / "spmd_budget.toml").write_text(mesh_budget.render(rows))
    problems = spmd_budget_audit(str(tmp_path))
    assert any("retired_entry" in p for p in problems)
    assert all(name in " ".join(problems) for name in live[1:])
    # malformed file is one problem, not a crash
    (d / "spmd_budget.toml").write_text("schema = 99\n")
    (problem,) = spmd_budget_audit(str(tmp_path))
    assert "schema" in problem
    assert spmd_budget_audit(_ROOT) == []


def test_chain_depth_regression():
    """The fused iteration's serialized gather/segment-sum chain is <= 4
    deep, below the default path's 7 (JAX's own count of the same
    problem), with at most half the heavy ops — the C5 repair: each
    transpose is one segment_reduce with no gather into segment order."""
    from cbf_tpu.analysis.audits import chain_profile as jax_chain_profile
    from cbf_tpu.solvers.sparse_admm import SparseADMMSettings as JS
    from cbf_tpu_torch.analysis.audits import (FUSED_CHAIN_DEPTH_BOUND,
                                               chain_depth_audit,
                                               chain_profile)
    from cbf_tpu_torch.solvers.sparse_admm import SparseADMMSettings

    default = chain_profile(SparseADMMSettings(), device="cpu")
    fused = chain_profile(SparseADMMSettings(fused=True,
                                             ksolve="chebyshev"),
                          device="cpu")
    assert FUSED_CHAIN_DEPTH_BOUND == 4
    assert fused["chain_depth"] <= 4, fused
    assert default["chain_depth"] > fused["chain_depth"], (default, fused)
    assert fused["heavy_ops"] * 2 <= default["heavy_ops"], (default, fused)
    assert default["chain_depth"] == jax_chain_profile(JS())["chain_depth"]
    assert fused["op_counts"] == {"index_select": 4, "segment_reduce": 2}
    assert chain_depth_audit(device="cpu") == []


def test_chain_depth_agent_k_path_analyzable():
    """The agent-major fast path stays analysable, and its fused iteration
    is as shallow as the generic one."""
    from cbf_tpu_torch.analysis.audits import chain_profile
    from cbf_tpu_torch.solvers.sparse_admm import SparseADMMSettings

    p = chain_profile(SparseADMMSettings(), agent_k=8, device="cpu")
    assert p["chain_depth"] >= 1 and p["heavy_ops"] >= 1
    f = chain_profile(SparseADMMSettings(fused=True, ksolve="chebyshev"),
                      agent_k=8, device="cpu")
    assert 1 <= f["chain_depth"] <= 4 < p["chain_depth"]


# -- the fused slot layout vs the two-pass row-order iteration ---------------

def _two_pass_segment_sum(values, plan, E, n):
    """The former transpose: a gather of the rows into segment order, then
    the segment sums."""
    flat = values.reshape(-1, values.shape[-1]).index_select(0, plan.perm)
    out = torch.segment_reduce(flat, "sum", offsets=plan.offsets, axis=0,
                               unsafe=True, initial=0.0)
    return out.reshape(E, n, values.shape[-1])


def _row_order_fused_solve(u_nom, I, J, coef, b_pair, lo, hi, settings,
                           agent_k, warm_state):
    """The fused iteration as the port ran it with its pair rows in row
    order and the two-pass transpose: (u, primal, dual, 5-tuple carry)."""
    from cbf_tpu_torch.solvers import sparse_admm as sa
    from cbf_tpu_torch.solvers.admm import relaxed_zy_update

    E, N = u_nom.shape[0], u_nom.shape[1]
    rho, sigma, alpha = settings.rho, settings.sigma, settings.alpha
    ops = sa._prepare_ops(u_nom, I, J, coef, b_pair, lo, hi,
                          settings._replace(fused=False), agent_k=agent_k)
    zero_rows = torch.all(ops.coef_s == 0.0, dim=2)
    Ie = I.to(torch.int64)[None].expand(E, -1)
    Je = J.to(torch.int64)
    Ig, Jg = sa._member_index(Ie, N), sa._member_index(Je, N)

    def keyed(idx, zero):
        spread = torch.arange(idx.shape[1], dtype=torch.int64) % N
        return sa._member_index(torch.where(zero, spread, idx), N)

    if agent_k is not None:
        plan = sa._segment_plan(keyed(Je, zero_rows), E * N)
    else:
        plan = sa._segment_plan(
            keyed(torch.cat([Ie, Je], dim=1),
                  torch.cat([zero_rows, zero_rows], dim=1)), E * N)

    def A_pair(v):
        return torch.sum(ops.coef_s * (sa._gather(v, Ig, E)
                                       - sa._gather(v, Jg, E)), dim=2)

    def A_pair_T(y):
        contrib = ops.coef_s * y[..., None]
        if agent_k is None:
            return _two_pass_segment_sum(torch.cat([contrib, -contrib], 1),
                                         plan, E, N)
        block = torch.sum(contrib.reshape(E, -1, agent_k, 2), dim=2)
        return block - _two_pass_segment_sum(contrib, plan, E, N)

    def apply_K(v2):
        v = v2.reshape(E, N, 2)
        return ((1.0 + sigma + rho) * v
                + rho * A_pair_T(A_pair(v))).reshape(E, 2 * N)

    if warm_state is None:
        x0 = torch.zeros_like(ops.q)
        zp0 = torch.zeros_like(ops.b_s)
        carry = (x0, zp0, x0, zp0, x0, zp0)
    else:
        carry = tuple(warm_state) + (A_pair(warm_state[0].reshape(E, N, 2)),)
    for _ in range(settings.iters):
        x, z_p, z_b, y_p, y_b, Ax = carry
        r0 = (A_pair_T(rho * z_p - y_p - rho * Ax).reshape(E, -1)
              + (rho * z_b - y_b) - ops.q - (1.0 + rho) * x)
        if settings.ksolve == "chebyshev":
            dx = sa._chebyshev(apply_K, r0, settings.cg_iters,
                               1.0 + sigma + rho, ops.ev_hi)
        else:
            dx = sa._cg(apply_K, r0, settings.cg_iters)
        x_new = x + dx
        Ax_p = A_pair(x_new.reshape(E, N, 2))
        z_p, y_p = relaxed_zy_update(Ax_p, z_p, y_p, rho, alpha,
                                     lambda w: torch.minimum(w, ops.b_s))
        z_b, y_b = relaxed_zy_update(x_new, z_b, y_b, rho, alpha,
                                     lambda w: torch.clamp(w, ops.lo,
                                                           ops.hi))
        carry = (x_new, z_p, z_b, y_p, y_b, Ax_p)
    x, y_p, y_b, Ax = carry[0], carry[3], carry[4], carry[5]
    viol_p = sa._amax0(torch.clamp(Ax / ops.d - ops.b_pair, min=0.0))
    viol_b = sa._amax0(torch.clamp(torch.maximum(ops.lo - x, x - ops.hi),
                                   min=0.0))
    dual = torch.amax(torch.abs(x + ops.q + A_pair_T(y_p).reshape(E, -1)
                                + y_b), dim=1)
    return (x.reshape(E, N, 2), torch.maximum(viol_p, viol_b), dual,
            carry[:5])


def _bits_equal(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.numpy().tobytes() == b.numpy().tobytes())


@pytest.mark.parametrize("agent_k", [None, 4], ids=["generic", "agent"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_fused_solve_bit_equal_to_two_pass(dtype, agent_k):
    from cbf_tpu_torch.solvers.sparse_admm import (
        SparseADMMSettings, solve_pair_box_qp_admm_batched)

    E, N, k = 3, 16, 4
    rng = np.random.default_rng(7)
    I = torch.as_tensor(np.repeat(np.arange(N), k))
    J = torch.as_tensor(rng.integers(0, N, (E, N * k)))
    coef = torch.as_tensor(rng.normal(size=(E, N * k, 2)), dtype=dtype)
    coef[torch.as_tensor(rng.random((E, N * k)) < 0.2)] = 0.0   # padding
    b = torch.as_tensor(rng.normal(0.1, 0.3, (E, N * k)), dtype=dtype)
    u = torch.as_tensor(rng.normal(size=(E, N, 2)), dtype=dtype)
    lo = torch.full((E, N, 2), -1.0, dtype=dtype)
    args = (u, I, J, coef, b, lo, -lo)
    for ksolve in ("chebyshev", "cg"):
        s = SparseADMMSettings(fused=True, ksolve=ksolve, iters=25)
        warm = None
        for _ in range(2):                       # cold, then warm
            u_new, info, carry = solve_pair_box_qp_admm_batched(
                *args, s, agent_k=agent_k, warm_state=warm,
                with_state=True)
            ref = _row_order_fused_solve(*args, s, agent_k, warm)
            got = (u_new, info.primal_residual, info.dual_residual) + carry
            want = ref[:3] + tuple(ref[3])
            assert all(_bits_equal(a, c) for a, c in zip(got, want)), \
                (ksolve, [(a - c).abs().max().item()
                          for a, c in zip(got, want)])
            warm = carry
