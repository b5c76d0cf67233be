"""The port's static analysis (cbf_tpu_torch/analysis/), held to the JAX
package's analyser on the CPU.

- Each capture-safety and program-cache rule (TS/RC) fires on its bad
  source string and is silent on its clean one. Each bad string is the
  JAX package's fixture (tests/analysis_fixtures/bad_*.py) translated to
  torch, and fires at exactly the lines where the JAX linter fires on
  that fixture; the scope inference's host scopes (the host_inputs hook,
  chunk_heartbeats, a cached constant, the eager branches of a step)
  stay silent.
- Parity with the JAX package: both baseline parsers read either
  package's baseline.toml to equal entries, and the two reporters render
  the same concurrency findings to byte-equal JSON.
- The program checks: utils/faults.py's leak_host_callback and
  promote_f64, a host-data constant made inside the step and a
  carry-drift wrapper trip JX001, JX002, JX001 and JX003; the seven entry
  points (the JAX checker's, n=8) are clean on the CPU, the tapped
  rollout included.
- The audits on the port (AUD001, AUD002, AUD004, AUD007, AUD008) and
  their detection of planted holes; the counterparts of
  test_platform.py's AUD007 tests and test_fleet.py's schema-audit test.
- The CLI: ``lint --all --device cpu`` exits 0 on the repo (the standing
  gate, the SPMD census included), exit codes 0/1/2, a malformed baseline
  exits 2, ``--spmd`` and ``--write-spmd-budget`` (with and without
  ``--reason``) give JAX's exit codes; every registered rule is
  documented in the README's port section.
"""

import json
import os

import pytest
import torch

from cbf_tpu.analysis import ast_rules as jast
from cbf_tpu.analysis import baseline as jbaseline
from cbf_tpu.analysis import report as jreport
from cbf_tpu_torch.analysis import RULES, rule_ids
from cbf_tpu_torch.analysis import ast_rules, audits, baseline
from cbf_tpu_torch.analysis import program_rules
from cbf_tpu_torch.analysis.report import render_json, render_text, run_lint

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURES = os.path.join(_ROOT, "tests", "analysis_fixtures")
_AST_RULES = [r for r in rule_ids() if r.startswith(("TS", "RC"))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the JAX fixtures translated to torch ----------------------------------

BAD = {
    "TS001": '''"""TS001 bad: host reads inside a step the builder returns."""
import torch


def make_step(gain):
    def step(state, t):
        state = state + gain
        total = torch.sum(state)
        peek = total.item()              # TS001: a host read
        rows = state.tolist()            # TS001 again
        del peek, rows
        return state, total

    return step
''',
    "TS002": '''"""TS002 bad: Python casts of tensors inside a rolled-out step."""
import torch

from cbf_tpu_torch.rollout.engine import rollout


def run(state0, n):
    def step(state, t):
        scale = float(torch.sum(state * state))   # TS002: a host read
        count = int(torch.sum(state > 0))         # TS002 again
        return state * scale * count, ()

    return rollout(step, state0, n)
''',
    "TS003": '''"""TS003 bad: numpy copies of tensors inside a step."""
import numpy as np
import torch


def make_step():
    def step(state, t):
        y = torch.abs(state)
        # the host copies below break a capture
        host = np.asarray(y)             # TS003: device -> host copy
        return state / np.array(y).max(), host   # TS003 again

    return step
''',
    "TS004": '''"""TS004 bad: Python `if` on tensors inside a step (the select form,
torch.where, or the redo form, exact2d.request_redo, is the fix)."""
import torch


def make_step():
    def step(state, t):
        d = torch.amin(state)
        if d < 0.1:                      # TS004: a host read per step
            state = state * 0.0
        if torch.any(state > 1e6):       # TS004 again
            state = torch.clamp(state, 0, 1e6)
        return state, d

    return step
''',
    "TS005": '''"""TS005 bad: a Python `while` on a tensor residual inside a step
(the fix: fixed rounds under torch.where, or exact2d.request_redo)."""
import torch


def make_step():
    def step(state, t):
        r = torch.sum(state * state)
        while r > 1e-6:                  # TS005: a host read per round
            state = state * 0.5
            r = torch.sum(state * state)
        return state, r

    return step
''',
    "TS006": '''"""TS006 bad: print in a rolled-out step (runs at capture time only)."""
import torch
from cbf_tpu_torch.rollout.engine import rollout


def run(state0, n):
    def step(state, t):
        print("step", t)                 # TS006: capture time only
        return state + 1.0, torch.sum(state)

    return rollout(step, state0, n)
''',
    "TS007": '''"""TS007 bad: the host clock inside a step is a capture-time constant."""
import time

import torch


def make_step():
    def step(state, t):
        t0 = time.time()                 # TS007: frozen at capture
        y = state * 2.0
        elapsed = time.perf_counter() - t0   # TS007 again
        return y, torch.full((), elapsed)

    return step
''',
    "TS008": '''"""TS008 bad: host data copied to the device inside a step — a capture
refuses the copy; build the tensor once outside the step."""
import torch


def make_step(goal):
    def step(state, t):
        # the host list goal becomes a tensor on every step
        target = torch.tensor(goal, device=state.device)   # TS008
        return state + 0.1 * (target - state), ()

    return step
''',
    "RC001": '''"""RC001 bad: program-cache keys that cannot key the cache."""
import functools

import torch


@functools.lru_cache(maxsize=None)
def scaled(n, gains=[1.0, 2.0]):     # RC001: unhashable default
    return torch.full((n,), gains[0])


stepper = functools.partial(scaled, n_agents=8)   # RC001: no such parameter
''',
    "RC002": '''"""RC002 bad: the same step built afresh every loop iteration."""
from cbf_tpu_torch.rollout.engine import rollout
from cbf_tpu_torch.scenarios import swarm


def sweep(cfg, starts):
    for x0 in starts:
        state0, step = swarm.make(cfg, device="cpu")   # RC002: recaptures
        yield rollout(step, state0._replace(x=x0), cfg.steps)
''',
    "RC003": '''"""RC003 bad: a rolled-out step closes over a tensor made from host
data — baked into the captured program; a rebuilt closure captures anew."""
import numpy as np
import torch

from cbf_tpu_torch.rollout.engine import rollout


def run(state0, n):
    weights = torch.as_tensor(np.arange(state0.shape[0]))   # host data
    def step(state, t):                   # RC003: closes over `weights`
        return state * weights[:, None], ()

    return rollout(step, state0, n)
''',
}

CLEAN = {
    "TS001": '''"""TS001 clean: .item() in host functions and in the host_inputs hook."""
import torch


def summarize(outs):
    return float(outs.sum().item())      # a plain host function


def make_step(table):
    def step(state, t, inputs=None):
        return state + inputs, torch.sum(state)

    def host_inputs(t0, n):              # runs between chunks
        return table[t0:t0 + n] * table.max().item()

    step.host_inputs = host_inputs
    return step
''',
    "TS002": '''"""TS002 clean: casts of plain config and metadata are not host reads."""
import torch


def make_step(cfg_gain="2.5"):
    def step(state, t):
        gain = float(cfg_gain)           # a Python string
        n = int(state.shape[0])          # metadata
        return state * gain / n, torch.sum(state)

    return step
''',
    "TS003": '''"""TS003 clean: numpy on static config, and constants built outside
the step."""
import numpy as np
import torch


def make_step(offsets=(0.5, -0.5)):
    base = torch.as_tensor(np.asarray(offsets))    # once, outside the step

    def step(state, t):
        shift = np.asarray(offsets).sum()          # a static tuple
        return state + base.sum() + shift, ()

    return step
''',
    "TS004": '''"""TS004 clean: branches on config, None and shapes, the select form,
and the host branch of the eager loop (exact2d.in_guarded_body)."""
import torch

from cbf_tpu_torch.solvers import exact2d


def make_step(mode="fast", cap=None):
    def step(state, t):
        if mode == "fast":               # static Python config
            state = state + 1.0
        if cap is not None:              # the optional-argument pattern
            state = torch.minimum(state, cap)
        if state.shape[0] > 4:           # static metadata
            state = state * 2.0
        low = torch.amin(state) < 0.1
        if exact2d.in_guarded_body():
            exact2d.request_redo(low)    # the redo form
        elif low:                        # the eager loop's host branch
            state = state * 0.0
        return torch.where(low, state * 0.0, state), ()

    return step
''',
    "TS005": '''"""TS005 clean: a fixed Python trip count unrolls statically; a data-
dependent exit is fixed rounds under torch.where (the select form)."""
import torch


def make_step(rounds=8):
    def step(state, t):
        k = 0
        while k < rounds:                # static Python counter
            going = torch.sum(state * state) > 1e-6
            state = torch.where(going, state * 0.5, state)
            k += 1
        return state, ()

    return step
''',
    "TS006": '''"""TS006 clean: printing in host functions and between chunks."""
import torch

from cbf_tpu_torch.rollout.engine import rollout


def report(result):
    print("final:", result)              # a host function


def run(state0, n, table):
    def step(state, t, inputs=None):
        return state + inputs, torch.sum(state)

    def hook(t0, k):
        print("chunk at", t0)            # the host_inputs hook
        return table[t0:t0 + k]

    step.host_inputs = hook
    return rollout(step, state0, n)
''',
    "TS007": '''"""TS007 clean: timing around the compiled rollout, on the host."""
import time

import torch

from cbf_tpu_torch.rollout.engine import rollout


def make_step():
    def step(state, t):
        return state * 2.0, torch.sum(state)

    return step


def bench(state0, n):
    t0 = time.perf_counter()             # host scope: fine
    final, outs = rollout(make_step(), state0, n)
    torch.cuda.synchronize()
    return final, time.perf_counter() - t0
''',
    "TS008": '''"""TS008 clean: constants built once outside the step, or cached on
their first (uncaptured) call."""
import functools

import torch


@functools.lru_cache(maxsize=None)
def _pattern(device):
    return torch.tensor([1.0, -1.0], device=device)


def make_step(goal, device):
    target = torch.as_tensor(goal, device=device)

    def step(state, t):
        return state + 0.1 * (target - state) * _pattern(state.device), ()

    return step
''',
    "RC001": '''"""RC001 clean: hashable program-cache keys naming real parameters."""
import functools

import torch


@functools.lru_cache(maxsize=None)
def scaled(n, mode="fast"):
    return torch.full((n,), 2.0 if mode == "fast" else 1.0)


stepper = functools.partial(scaled, mode="slow")
''',
    "RC002": '''"""RC002 clean: the step is built once; the loop only rolls it out
(a loop over configs builds one step per config, as it must)."""
from cbf_tpu_torch.rollout.engine import rollout
from cbf_tpu_torch.scenarios import swarm


def sweep(cfg, starts):
    state0, step = swarm.make(cfg, device="cpu")
    for x0 in starts:
        yield rollout(step, state0._replace(x=x0), cfg.steps)


def grid(cfgs):
    for cfg in cfgs:                     # a new config: a new program
        state0, step = swarm.make(cfg, device="cpu")
        yield rollout(step, state0, cfg.steps)
''',
    "RC003": '''"""RC003 clean: the tensor rides in the carry; the closure captures only
a static Python scalar."""
import torch

from cbf_tpu_torch.rollout.engine import rollout


def run(state0, n, gain=2.0):
    def step(carry, t):
        state, weights = carry
        return (state * weights[:, None] * gain, weights), ()

    weights = torch.arange(state0.shape[0], dtype=state0.dtype)
    return rollout(step, (state0, weights), n)
''',
}


def _jax_lines(rule: str) -> set:
    name = f"bad_{rule.lower()}.py"
    with open(os.path.join(_FIXTURES, name)) as fh:
        found = jast.lint_source(fh.read(), name)
    return {f.line for f in found if f.rule == rule}


@pytest.mark.parametrize("rule", _AST_RULES)
def test_rule_fires_on_bad_string_at_jax_lines(rule):
    found = ast_rules.lint_source(BAD[rule], f"bad_{rule.lower()}.py")
    assert {f.rule for f in found} == {rule}, found
    assert {f.line for f in found} == _jax_lines(rule), found


@pytest.mark.parametrize("rule", _AST_RULES)
def test_rule_silent_on_clean_string(rule):
    found = ast_rules.lint_source(CLEAN[rule], f"clean_{rule.lower()}.py")
    assert found == [], found


def test_bad_strings_cover_every_ast_rule():
    """The JAX fixture corpus trips all 11 AST rules; so do the
    translations, each rule on its own string."""
    fired = set()
    for rule in _AST_RULES:
        fired |= {f.rule for f in ast_rules.lint_source(BAD[rule], "x.py")}
    assert fired == set(_AST_RULES)


def test_host_scopes_override_captured():
    """The tap's chunk_heartbeats, a host_inputs lambda, a cached
    constant and the eager branches of a step stay silent; the same
    reads on the captured side of the split are flagged."""
    src = '''
import functools

import torch

from cbf_tpu_torch.solvers import exact2d


def chunk_heartbeats(tap, t0, outs):
    def emit():
        return float(outs.sum().item())
    return emit


@functools.lru_cache(maxsize=None)
def _rows(device):
    return torch.tensor([1.0, 2.0], device=device)


def make_step(table):
    def step(state, t, inputs=None):
        stale = torch.amax(state) > 1.0
        if exact2d.takes_every_branch():
            state = torch.where(stale, state * 0.5, state)
        elif exact2d.in_guarded_body():
            exact2d.request_redo(stale)
        elif bool(stale):
            state = state * 0.5
        return state * _rows(state.device), ()

    step.host_inputs = lambda t0, n: torch.tensor(table[t0:t0 + n])
    return step


def make_member_step():
    def step(state, t):
        going = torch.amax(state) > 1.0
        if exact2d.in_guarded_body():
            exact2d.request_redo(going)
            return state, ()
        if bool(going):
            state = state * 0.5
        return state, ()
    return step


def make_bad_step():
    def step(state, t):
        if not exact2d.in_guarded_body():
            return state, ()
        return state, float(torch.amax(state))
    return step
'''
    found = ast_rules.lint_source(src, "scopes.py")
    assert [(f.rule, f.symbol) for f in found] == [
        ("TS002", "make_bad_step.step")], found


def test_name_resolution_is_lexical():
    """A local variable named like a nested def elsewhere is not that def:
    rolling out a step taken from a builder's return does not make the
    builder's nested `step` an engine root (RC003), while the builder's
    returned step is still captured scope (TS004)."""
    src = '''
import numpy as np
import torch

from cbf_tpu_torch.rollout.engine import rollout


def make(n):
    goal = torch.as_tensor(np.zeros(n))
    def step(state, t):
        if torch.any(state > goal):
            state = state * 0.5
        return state, ()
    return step


def run(n, state0):
    step = make(n)
    return rollout(step, state0, 4)
'''
    found = ast_rules.lint_source(src, "lexical.py")
    assert [(f.rule, f.symbol) for f in found] == [
        ("TS004", "make.step")], found


def test_port_steps_are_captured_scope():
    """The inference reaches the port's real steps: the swarm builders'
    returned steps and the serving program are captured scope, the
    host_inputs lambda, the tap's chunk_heartbeats and the cached
    constants are host scope."""
    def scopes(rel):
        with open(os.path.join(_ROOT, rel)) as fh:
            m = ast_rules.ModuleLinter(fh.read(), rel)
        return ({f.qualname for f in m.funcs if f.traced and not f.host},
                {f.qualname for f in m.funcs if f.host})

    traced, host = scopes("cbf_tpu_torch/scenarios/swarm.py")
    assert {"_build_step.step", "_step_body.step",
            "make_step_traced.step", "verlet_gating"} <= traced
    assert "_dynamics_rows" in host
    traced, host = scopes("cbf_tpu_torch/parallel/ensemble.py")
    assert {"_traced_program.program", "_traced_program.lane",
            "_over_members"} <= traced
    assert "_traced_program" in host
    traced, host = scopes("cbf_tpu_torch/obs/tap.py")
    assert "instrument_step.wrapped" in traced
    assert "chunk_heartbeats" in host


# -- baseline --------------------------------------------------------------

def test_baseline_roundtrip_suppresses_and_shows(tmp_path):
    target = tmp_path / "bad_ts001.py"
    target.write_text(BAD["TS001"])
    findings = run_lint([str(target)], repo_root=str(tmp_path)).active
    assert findings
    sups = [baseline.Suppression(f.rule, f.path, f.symbol,
                                 "fixture: known-bad by construction")
            for f in findings]
    bpath = str(tmp_path / "baseline.toml")
    baseline.write(bpath, sups)
    res = run_lint([str(target)], repo_root=str(tmp_path),
                   baseline_path=bpath)
    assert res.exit_code == 0
    assert res.active == []
    assert len(res.suppressed) == len(findings)
    text = render_text(res, show_suppressed=True)
    assert "suppressed: fixture: known-bad by construction" in text
    assert "TS001" in text
    assert "known-bad by construction" not in render_text(res)


def test_stale_baseline_entry_fails(tmp_path):
    bpath = str(tmp_path / "baseline.toml")
    baseline.write(bpath, [baseline.Suppression(
        "TS006", "cbf_tpu_torch/nonexistent.py", "gone", "fixed long ago")])
    target = tmp_path / "clean.py"
    target.write_text(CLEAN["TS001"])
    res = run_lint([str(target)], baseline_path=bpath)
    assert res.exit_code == 1
    assert len(res.stale) == 1
    assert "stale" in render_text(res)


def test_baseline_requires_reason(tmp_path):
    (tmp_path / "baseline.toml").write_text(
        '[[suppress]]\nrule = "TS001"\npath = "x.py"\nsymbol = "f"\n'
        'reason = ""\n')
    with pytest.raises(baseline.BaselineError):
        baseline.load(str(tmp_path / "baseline.toml"))


def test_baseline_rejects_unknown_and_unported_rules(tmp_path):
    """An unknown ID is refused; the SPMD rules and the chain-depth and
    spmd-budget audits are registered, so their entries load."""
    for rule in ("ZZ999", "SP001", "AUD003", "AUD009"):
        (tmp_path / "baseline.toml").write_text(
            f'[[suppress]]\nrule = "{rule}"\npath = "x.py"\n'
            'symbol = "f"\nreason = "typo"\n')
        if rule == "ZZ999":
            with pytest.raises(baseline.BaselineError):
                baseline.load(str(tmp_path / "baseline.toml"))
        else:
            (sup,) = baseline.load(str(tmp_path / "baseline.toml"))
            assert sup.rule == rule


def test_baseline_fallback_parser_matches_render():
    sups = [baseline.Suppression("TS001", "a/b.py", "f.g", "why not"),
            baseline.Suppression("RC002", "c.py", "<module>", "legacy")]
    parsed = baseline._parse_toml(baseline.render(sups))
    assert [baseline.Suppression(e["rule"], e["path"], e["symbol"],
                                 e["reason"]) for e in parsed] == sups


@pytest.mark.parametrize("which", ["jax", "port"])
def test_baseline_parsers_agree_with_jax(which):
    """Both packages' loaders read either package's baseline.toml to the
    same entries."""
    path = (jbaseline.DEFAULT_BASELINE if which == "jax"
            else baseline.DEFAULT_BASELINE)
    ours = [tuple(s) for s in baseline.load(path)]
    theirs = [tuple(s) for s in jbaseline.load(path)]
    assert ours == theirs and len(ours) > 0


def test_port_baseline_reasons_and_scope():
    """Every entry of the port's baseline has a reason and names a port
    file; none is stale on the repo (the standing gate below)."""
    sups = baseline.load()
    assert sups
    for s in sups:
        assert s.reason.strip() and s.path.startswith("cbf_tpu_torch/")


def test_render_json_byte_equal_to_jax(tmp_path):
    """The same concurrency findings and graph render to byte-equal JSON
    in both packages (the CC rules' summaries are the JAX package's)."""
    empty = str(tmp_path / "none.toml")
    paths = [os.path.join(_FIXTURES, n) for n in
             ("bad_cc001.py", "bad_cc002.py", "bad_cc003.py",
              "clean_cc002.py")]
    ours = run_lint(paths, repo_root=_ROOT, baseline_path=empty,
                    concurrency=True)
    theirs = jreport.run_lint(paths, repo_root=_ROOT, baseline_path=empty,
                              concurrency=True)
    assert ours.active and ours.lock_graph
    for show in (False, True):
        assert render_json(ours, show_suppressed=show) == \
            jreport.render_json(theirs, show_suppressed=show)
    assert render_text(ours) == jreport.render_text(theirs)


def test_render_json_contract(tmp_path):
    target = tmp_path / "bad_ts007.py"
    target.write_text(BAD["TS007"])
    payload = json.loads(render_json(run_lint([str(target)]),
                                     show_suppressed=True))
    assert set(payload) == {"findings", "suppressed",
                            "stale_suppressions", "rules", "exit_code"}
    assert payload["rules"]["TS007"]["severity"] == "warning"


# -- program checks ---------------------------------------------------------

@pytest.fixture(scope="module")
def swarm_step():
    from cbf_tpu_torch.scenarios import swarm

    return swarm.make(swarm.Config(n=8, steps=4, k_neighbors=4),
                      device="cpu")


def test_program_checks_detect_leak_host_callback(swarm_step):
    """faults.leak_host_callback reads a device value on the host inside
    the step: JX001, located in utils/faults.py (the JAX test locates the
    unapproved callback's module the same way)."""
    from cbf_tpu_torch.utils import faults

    state0, step = swarm_step
    found = program_rules.check_body(
        faults.leak_host_callback(step, every=2), state0, entry="leaky")
    assert [f.rule for f in found] == ["JX001"], found
    assert "cbf_tpu_torch/utils/faults.py" in found[0].message
    assert "Tensor.item()" in found[0].message


def test_program_checks_detect_forced_f64_promotion(swarm_step):
    from cbf_tpu_torch.utils import faults

    state0, step = swarm_step
    found = program_rules.check_body(faults.promote_f64(step), state0,
                                     entry="drifty")
    assert {f.rule for f in found} == {"JX002"}, found
    assert "promote_f64" in found[0].message


def test_program_checks_detect_host_constant_in_step(swarm_step):
    """A constant made from host data inside the step — the copy that
    breaks a capture on the card — is JX001 on the CPU too."""
    state0, step = swarm_step

    def constant(state, t, inputs=None):
        state, out = step(state, t)
        nudge = torch.tensor([0.0, 0.0], dtype=state.x.dtype,
                             device=state.x.device)
        return state._replace(x=state.x + nudge), out

    found = program_rules.check_body(constant, state0, entry="const")
    assert [f.rule for f in found] == ["JX001"], found
    assert "torch.tensor() of host data" in found[0].message


def test_program_checks_detect_carry_drift(swarm_step):
    state0, step = swarm_step

    def drifting(state, t, inputs=None):
        state, out = step(state, t)
        return state._replace(x=state.x.to(torch.float64)), out

    found = program_rules.check_body(drifting, state0, entry="drift")
    assert "JX003" in {f.rule for f in found}, found
    drift = [f for f in found if f.rule == "JX003"]
    assert "torch.float32[8, 2] on cpu -> torch.float64[8, 2]" in \
        drift[0].message


def test_program_checks_carry_stability_direct():
    a = (torch.zeros(3), torch.zeros(2, dtype=torch.int32))
    assert program_rules.check_carry_stability(a, a) == []
    b = (torch.zeros(3, dtype=torch.float64), a[1])
    assert [f.rule for f in program_rules.check_carry_stability(a, b)] == \
        ["JX003"]


@pytest.mark.parametrize("name", sorted(program_rules.entrypoint_specs(
    "cpu")))
def test_entrypoint_specs_clean_on_cpu(name):
    """Every production entry point's captured body runs under the modes
    and comes back clean: no host traffic (the tapped rollout included,
    as JAX's test_jaxpr_approves_telemetry_tap holds), float32 only but
    for the approved sqrt of the plain k-NN versions, a stable carry."""
    stats = {}
    assert program_rules.entrypoint_specs("cpu")[name](stats=stats) == []
    assert stats["ops"] > 100 and set(stats["devices"]) == {"cpu"}
    assert stats["host_calls"] == []
    assert set(stats["f64_allowed"]) <= {
        "cbf_tpu_torch/ops/knn.py:_sqrt_rn"}


def test_wrapped_python_numbers_are_not_host_traffic():
    """Under vmap functorch wraps a Python number into a 0-dim CPU tensor
    for a scalar operand; the audit tracks it as a constant (on the card
    it would otherwise look like a CPU tensor fed into CUDA work)."""
    stats = {}
    found = program_rules.trace_and_check(
        torch.func.vmap(lambda p: p * 2.5), (torch.ones(4),), entry="vmap",
        stats=stats)
    assert found == [] and stats["wrapped_scalars"] >= 1
    assert stats["host_calls"] == []


def test_approved_host_calls_is_empty():
    assert program_rules.APPROVED_HOST_CALLS == ()


# -- audits -----------------------------------------------------------------

def test_audits_clean_on_repo():
    assert audits.run_audits(_ROOT, device="cpu") == []


def test_aud007_green_on_shipped_registry():
    assert audits.scenario_coverage_audit() == []


def test_aud007_detects_coverage_holes(tmp_path):
    """A registered scenario with a dead adapter key and a missing parity
    needle, and a scenario module on disk that never registers."""
    from cbf_tpu_torch.scenarios import swarm
    from cbf_tpu_torch.scenarios.platform import registry

    (tmp_path / "tests").mkdir()
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "API.md").write_text(
        "`swarm` `meet_at_center` `cross_and_rescue` `antipodal`\n")
    scen_dir = tmp_path / "cbf_tpu_torch" / "scenarios"
    scen_dir.mkdir(parents=True)
    (scen_dir / "stale_scenario.py").write_text("Config = None\n")
    bogus = registry.ScenarioEntry(
        name="bogus-cov", module="cbf_tpu_torch.scenarios.swarm",
        make_config=swarm.Config, adapter="no-such-builder",
        steps_field="steps", servable=True,
        parity_test="test_needle_that_does_not_exist", generated=True)
    registry.register(bogus)
    try:
        probs = audits.scenario_coverage_audit(str(tmp_path))
    finally:
        registry._REGISTRY.pop("bogus-cov", None)
    blob = "\n".join(probs)
    assert "no-such-builder" in blob
    assert "stale_scenario.py" in blob
    assert "test_margin_parity_vs_numpy" in blob


def test_schema_audit_has_no_fleet_gaps():
    assert [p for p in audits.obs_schema_audit()
            if "fleet" in p.lower()] == []


def test_aud004_flags_torch_global_draws(tmp_path):
    """AUD004's torch leg: draws with no generator= and global seeding are
    flagged; seeded generators pass."""
    pkg = tmp_path / "cbf_tpu_torch"
    pkg.mkdir()
    (pkg / "draws.py").write_text(
        "import numpy as np\nimport torch\n"
        "a = torch.rand(3)\n"
        "b = torch.randn(3, generator=torch.Generator().manual_seed(0))\n"
        "c = torch.zeros(3).uniform_()\n"
        "torch.manual_seed(0)\n"
        "d = np.random.default_rng()\n"
        "e = np.random.default_rng(0).normal()\n")
    (tmp_path / "chip_smoke.py").write_text("x = 1\n")
    probs = audits.reproducibility_audit(str(tmp_path))
    lines = sorted(int(p.split(":")[1]) for p in probs)
    assert lines == [3, 5, 6, 7], probs


def test_aud008_flags_missing_and_stale_rows(tmp_path):
    """AUD008 against a README whose map lacks a discovered lock and
    keeps a row for one that no longer exists."""
    with open(os.path.join(_ROOT, "README.md")) as fh:
        text = fh.read()
    text = text.replace("| `Tracer._lock` |", "| `Tracer._gone` |")
    (tmp_path / "README.md").write_text(text)
    os.symlink(os.path.join(_ROOT, "cbf_tpu_torch"),
               tmp_path / "cbf_tpu_torch")
    probs = audits.concurrency_map_audit(str(tmp_path))
    assert any("`Tracer._lock` has no row" in p for p in probs), probs
    assert any("`Tracer._gone` matches no" in p for p in probs), probs
    assert len(probs) == 2


# -- fixed port faults --------------------------------------------------------

def test_separation_floor_eval_builds_one_step(monkeypatch):
    """RC002 found the trainer example building (and, on the card,
    capturing) the same step once per member; it now builds it once, and
    the floor it reports is unchanged."""
    import numpy as np

    from cbf_tpu_torch.examples import train_safety_params as tsp
    from cbf_tpu_torch.learn import tuning
    from cbf_tpu_torch.rollout.engine import rollout
    from cbf_tpu_torch.scenarios import swarm

    from cbf_tpu_torch.parallel.ensemble import ensemble_initial_states

    cfg = swarm.Config(n=16, k_neighbors=4)
    params = tuning.init_params(gamma=0.15, dmin=0.10, k=0.5, device="cpu")
    state0 = ensemble_initial_states(cfg, [0, 1], device="cpu")
    calls = []
    real_make = swarm.make
    monkeypatch.setattr(swarm, "make", lambda *a, **k: calls.append(1)
                        or real_make(*a, **k))
    floor = tsp._eval_separation_floor(cfg, params, state0, steps=5)
    assert len(calls) == 1
    monkeypatch.setattr(swarm, "make", real_make)
    cbf = tuning.params_to_cbf(params, swarm.default_cbf(
        cfg, device="cpu").max_speed)
    cbf = cbf._replace(**{f: float(getattr(cbf, f))
                          for f in ("dmin", "k", "gamma")})
    want = np.inf
    for e in range(2):
        s0, step = swarm.make(swarm.Config(n=16, k_neighbors=4, steps=5),
                              cbf, device="cpu")
        s0 = s0._replace(x=state0[0][e], v=state0[1][e])
        _, outs = rollout(step, s0, 5)
        want = min(want, float(outs.min_pairwise_distance.min()))
    assert floor == want


# -- the CLI and the standing gate -------------------------------------------

@pytest.fixture(scope="module")
def repo_lint():
    return run_lint([os.path.join(_ROOT, "cbf_tpu_torch"),
                     os.path.join(_ROOT, "chip_smoke.py")],
                    repo_root=_ROOT, jaxpr=True, audits=True,
                    concurrency=True, spmd=True, device="cpu")


def test_repo_is_lint_clean(repo_lint):
    """The standing gate: AST rules over the port and chip_smoke.py, the
    program checks on the CPU, the audits, the concurrency analyser and
    the SPMD census exit 0 against the port's baseline, with no stale
    entry."""
    assert repo_lint.exit_code == 0, "\n" + render_text(repo_lint)
    assert repo_lint.stale == []
    assert {f.rule for f, _ in repo_lint.suppressed} <= set(RULES)


def test_cli_lint_all_cpu_exit_zero(capsys):
    from cbf_tpu_torch.__main__ import main

    assert main(["lint", "--all", "--device", "cpu", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["exit_code"] == 0 and payload["findings"] == []
    assert "lock_order_graph" in payload
    assert len(payload["spmd_census"]["entrypoints"]) == 5


def test_cli_lint_bad_string_exit_one(tmp_path, capsys):
    from cbf_tpu_torch.__main__ import main

    target = tmp_path / "bad_ts004.py"
    target.write_text(BAD["TS004"])
    assert main(["lint", str(target)]) == 1
    assert "TS004" in capsys.readouterr().out


def test_cli_lint_json(tmp_path, capsys):
    from cbf_tpu_torch.__main__ import main

    target = tmp_path / "bad_rc002.py"
    target.write_text(BAD["RC002"])
    assert main(["lint", "--json", str(target)]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["exit_code"] == 1
    assert any(f["rule"] == "RC002" for f in payload["findings"])
    assert payload["rules"]["RC002"]["severity"] == "error"
    assert "lock_order_graph" not in payload


def test_cli_lint_malformed_baseline_exit_two(tmp_path, capsys):
    from cbf_tpu_torch.__main__ import main

    bad = tmp_path / "b.toml"
    bad.write_text('[[suppress]]\nrule = "TS001"\n')
    target = tmp_path / "clean.py"
    target.write_text(CLEAN["TS001"])
    assert main(["lint", "--baseline", str(bad), str(target)]) == 2
    assert "missing" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--spmd"], ["--write-spmd-budget"],
                                   ["--write-spmd-budget", "--reason", "x"]])
def test_cli_lint_spmd_is_out_of_slice(flags, tmp_path, monkeypatch,
                                       capsys):
    """The SPMD flags run (no out-of-slice exit): ``--spmd`` lints a clean
    file with the census at exit 0; ``--write-spmd-budget`` over a budget
    with no rows exits 2 asking for a reason, and with ``--reason`` writes
    every entry point's row (into a copy, never the committed file)."""
    from cbf_tpu_torch.__main__ import main
    from cbf_tpu_torch.analysis import mesh_budget

    budget = tmp_path / "spmd_budget.toml"
    budget.write_text("schema = 1\n")
    if "--write-spmd-budget" in flags:
        monkeypatch.setattr(mesh_budget, "DEFAULT_PATH", str(budget))
    empty = tmp_path / "none.toml"
    empty.write_text("")
    target = tmp_path / "clean.py"
    target.write_text(CLEAN["TS001"])
    rc = main(["lint", *flags, "--device", "cpu", "--baseline", str(empty),
               str(target)])
    out, err = capsys.readouterr()
    assert "not ported yet" not in err
    if flags == ["--spmd"]:
        assert rc == 0, out + err
        assert "lint: 0 findings" in out
    elif "--reason" not in flags:
        assert rc == 2 and "pass a reason" in err
        assert budget.read_text() == "schema = 1\n"
    else:
        assert rc == 0 and "(5 entries)" in out
        rows = mesh_budget.load(str(budget)).entries
        assert len(rows) == 5 and {r.reason for r in rows.values()} == {"x"}


def test_rules_documented():
    """Every registered rule ID appears in the README's port section (the
    static-analysis table), the SPMD rules, AUD003 and AUD009 among them,
    and no longer marked as waiting for Queue A12b."""
    with open(os.path.join(_ROOT, "README.md")) as fh:
        readme = fh.read()
    port = readme[readme.index("## PyTorch/CUDA port"):
                  readme.index("## Testing")]
    missing = [rid for rid in RULES if f"| `{rid}` |" not in port]
    assert not missing, f"undocumented rules: {missing}"
    for needle in ("lint --all --device cpu", "lint --spmd --device cpu",
                   "spmd_budget.toml", "check_subgraph",
                   audits.MAP_START, audits.MAP_END):
        assert needle in port, needle
    spmd = {"SP001", "SP002", "SP003", "SP004", "SP005", "SP006", "AUD003",
            "AUD009"}
    assert spmd <= set(RULES)
    assert "Queue A12b" not in port
