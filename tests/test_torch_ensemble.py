"""The port's ensembles on one device (cbf_tpu_torch.parallel) held to the
JAX package's on the CPU, from the same seeds.

- ``sharded_swarm_rollout`` on a (1, 1) mesh against JAX's: single,
  double and unicycle members, the lockstep batched
  certificate at E = 2 (cold, and warm with the adaptive budget), the
  Verlet cache at E = 1, chunked against unchunked, and resumed runs with
  and without the solver carry. Tolerances are tests/test_torch_swarm.py's
  float32 ones: final x and v atol 1e-5, the per-step nearest distance
  rtol 1e-6, every count equal; the certificate's residual atol 1e-6, as
  tests/test_fused_batched.py holds its lockstep route.
- The compiled ensemble step ``torch.equal`` to ``engine.eager_rollout``
  (per member, lockstep, Verlet; a forced redo too), chunked and resumed
  runs bit-equal to the straight run, and the lockstep batched solve
  against the members solved one by one (the same test's x atol 2e-5).
- Queue C1: the sparse certificate's K solve under ``torch.func.vmap``
  keeps its implicit gradient — equal to the per-member gradient to
  1e-12 and to JAX's ``vmap(grad)`` to tests/test_torch_diff.py's 1e-9
  (float64).
- The mesh, the rejections (JAX's messages word for word): outside a
  world a mesh across devices raises JAX's ValueError text, and
  ``partition="spatial"`` runs on one tile (test_mesh_and_what_still_raises
  and test_make_mesh_default_is_the_current_card, rewritten when the
  mesh across ranks was ported; tests/test_torch_parallel.py holds it).

JAX 0.9's ``shard_map`` cannot infer that the ensemble's carry extras
(the Verlet cache, the warm solver carry) are replicated over ``sp``, so
the JAX package's own call raises for them today (ROADMAP.md, "Findings
on the reference"). Those runs are taken with the same function through
``shard_map`` with the check off (``check_vma=False``, as the error
suggests), patched for the duration of one fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.parallel import ensemble as jens
from cbf_tpu.parallel import make_mesh as jax_mesh
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.solvers import sparse_admm as jadmm
from cbf_tpu_torch import convert
from cbf_tpu_torch.parallel import ensemble as tens
from cbf_tpu_torch.parallel.mesh import Mesh, make_mesh
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.scenarios import swarm as tsw
from cbf_tpu_torch.solvers import sparse_admm as tadmm

X_ATOL, MD_RTOL, RES_ATOL, LOCKSTEP_ATOL = 1e-5, 1e-6, 1e-6, 2e-5
# tests/test_torch_rollout.py's orbit, whose QPs relax from step 5 on: the
# compiled run must redo a chunk there. The obstacle rows reach the
# compiled body through the step's host_inputs hook; held against the
# eager loop, which computes them from t (the rows' parity with JAX:
# tests/test_torch_obstacles.py).
ORBIT_RELAX = (dict(n=96, steps=12, k_neighbors=6, n_obstacles=8,
                    obstacle_omega=2.0), [2, 3], False)
GRAD_SELF_ATOL, GRAD_JAX_RTOL = 1e-12, 1e-9
COUNTS = ("engaged_count", "infeasible_count", "dropped_count",
          "certificate_dropped", "certificate_iterations")
MESH = make_mesh(devices="cpu")

# name -> (JAX Config fields, seeds, needs the unchecked shard_map)
CASES = {
    "single": (dict(n=64, steps=20), [0, 1], False),
    "double": (dict(n=64, steps=20, dynamics="double"), [0, 1], False),
    "unicycle": (dict(n=64, steps=20, dynamics="unicycle"), [0, 1], False),
    "lockstep": (dict(n=32, steps=10, certificate=True,
                      certificate_backend="sparse"), [0, 1], False),
    "lockstep_warm_tol": (dict(n=32, steps=10, certificate=True,
                               certificate_backend="sparse",
                               certificate_warm_start=True,
                               certificate_tol=1e-5), [0, 1], True),
    "verlet": (dict(n=128, steps=30, k_neighbors=16,
                    gating_rebuild_skin=0.15), [0], True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _unchecked_shard_map(f, mesh, in_specs, out_specs, check_rep=False):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


@pytest.fixture(scope="module")
def jax_runs():
    """Every case's JAX run, and the warm case split at step 5 with its
    carry (``with_solver_state``), computed once."""
    mp = pytest.MonkeyPatch()
    mesh = jax_mesh(n_dp=1, n_sp=1)
    out = {}
    try:
        for name, (fields, seeds, unchecked) in CASES.items():
            jens._rollout_executable.cache_clear()
            if unchecked:
                mp.setattr(jens, "shard_map", _unchecked_shard_map)
            else:
                mp.undo()
            out[name] = jens.sharded_swarm_rollout(jsw.Config(**fields),
                                                   mesh, seeds)
        fields, seeds, _ = CASES["lockstep_warm_tol"]
        mp.setattr(jens, "shard_map", _unchecked_shard_map)
        jens._rollout_executable.cache_clear()
        cfg = jsw.Config(**fields)
        out["warm_head"] = jens.sharded_swarm_rollout(
            cfg, mesh, seeds, steps=5, with_solver_state=True)
        out["warm_tail"] = jens.sharded_swarm_rollout(
            cfg, mesh, seeds, steps=5, t0=5,
            initial_state=out["warm_head"][0])
        out["warm_tail_cold"] = jens.sharded_swarm_rollout(
            cfg, mesh, seeds, steps=5, t0=5,
            initial_state=out["warm_head"][0][:2])
    finally:
        mp.undo()
        jens._rollout_executable.cache_clear()
    return out


def _port_cfg(fields):
    jcfg = jsw.Config(**fields)
    f = dataclasses.asdict(jcfg)
    f["dtype"] = np.dtype(f["dtype"]).name
    return convert.config_from_fields(f)


def _assert_close(jstate, jmets, tstate, tmets):
    for j, t in zip(jstate, tstate):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=X_ATOL)
    tm = convert.ensemble_metrics_from_reference(tmets)
    jm = convert.ensemble_metrics_from_reference(jmets)
    np.testing.assert_allclose(tm.nearest_distance, jm.nearest_distance,
                               rtol=MD_RTOL)
    np.testing.assert_allclose(tm.certificate_residual,
                               jm.certificate_residual, rtol=0,
                               atol=RES_ATOL)
    np.testing.assert_allclose(tm.saturation_deficit, jm.saturation_deficit,
                               rtol=0, atol=X_ATOL)
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_rollout_matches_jax(name, jax_runs):
    fields, seeds, _ = CASES[name]
    (jstate, jmets) = jax_runs[name]
    tstate, tmets = tens.sharded_swarm_rollout(_port_cfg(fields), MESH,
                                               seeds)
    assert len(tstate) == len(jstate)
    for field in tmets._fields:
        assert tuple(getattr(tmets, field).shape) == (len(seeds),
                                                      fields["steps"])
    _assert_close(jstate, jmets, tstate, tmets)
    assert int(tmets.engaged_count.sum()) > 0


def test_resume_matches_jax_with_and_without_the_carry(jax_runs):
    """JAX's warm run split at step 5: the state and carry carried across
    (``convert``) resume in the port as in JAX, with the carry and
    without it (seeded cold, the residual gate still held)."""
    fields, seeds, _ = CASES["lockstep_warm_tol"]
    cfg = _port_cfg(fields)
    head = convert.ensemble_state_from_reference(
        jax_runs["warm_head"][0], device="cpu", dtype=cfg.dtype)
    assert len(head) == 3 and len(head[2]) == 5
    for key, init in (("warm_tail", head), ("warm_tail_cold", head[:2])):
        tstate, tmets = tens.sharded_swarm_rollout(
            cfg, MESH, seeds, steps=5, t0=5, initial_state=init)
        _assert_close(*jax_runs[key], tstate, tmets)
        assert float(tmets.certificate_residual.max()) < 1e-4


def _program(fields, seeds, **override):
    cfg = dataclasses.replace(_port_cfg(fields), **override)
    cbf = tsw.default_cbf(cfg, device="cpu")
    step = tens._build_executable(cfg, MESH, len(seeds), cbf)
    return cfg, step, tens._initial_carry(cfg, MESH, seeds)


@pytest.mark.parametrize("name", ["single", "orbit_relax",
                                  "lockstep_warm_tol", "verlet"])
def test_compiled_equals_eager(name):
    """The step program the rollout compiles (per member under vmap,
    lockstep, E = 1 with the Verlet cache) equals the eager loop, bit for
    bit; with no guarded relax rounds and no guarded ADMM blocks, a chunk
    whose QPs relax (the orbit) or whose adaptive certificate iterates
    (the warm lockstep) is redone, and still equals it."""
    fields, seeds, _ = ORBIT_RELAX if name == "orbit_relax" else CASES[name]
    cfg, step, carry = _program(fields, seeds)
    ef, eo = teng.eager_rollout(step, carry, cfg.steps)
    for rounds, blocks in ((step.relax_rounds, step.admm_blocks), (0, 0)):
        step.relax_rounds, step.admm_blocks = rounds, blocks
        teng.COUNTS.update(dict.fromkeys(teng.COUNTS, 0))
        cf, co = teng.rollout(step, carry, cfg.steps)
        assert all(torch.equal(a, b) for a, b in zip(teng._leaves(cf),
                                                     teng._leaves(ef)))
        assert all(torch.equal(a, b) for a, b in zip(co, eo))
    assert teng.COUNTS["redos"] == int(name in ("orbit_relax",
                                                "lockstep_warm_tol"))


def test_lockstep_under_tol_runs_compiled_without_redo():
    """The lockstep program runs the whole ADMM budget (its loop stops at
    the slowest member, past a one-swarm guarded budget), so a warm
    run under certificate_tol finishes compiled — no chunk redone — and
    equals the eager loop."""
    fields, seeds, _ = CASES["lockstep_warm_tol"]
    cfg, step, carry = _program(fields, seeds)
    assert step.admm_blocks is None
    ef, eo = teng.eager_rollout(step, carry, cfg.steps)
    teng.COUNTS.update(dict.fromkeys(teng.COUNTS, 0))
    cf, co = teng.rollout(step, carry, cfg.steps)
    assert teng.COUNTS["redos"] == 0
    assert int(co.certificate_iterations.max()) > 0
    assert all(torch.equal(a, b) for a, b in zip(teng._leaves(cf),
                                                 teng._leaves(ef)))
    assert all(torch.equal(a, b) for a, b in zip(co, eo))


def test_equal_cbf_values_replay_one_program():
    """Mixed dynamics' filter parameters are (N,) tensors, new ones on
    every default_cbf call: equal values still reach one cached program,
    which runs it again; new values of the same shape reach it too, and
    the run reads them (equal to a program built for them alone)."""
    cfg = tsw.Config(n=32, steps=3, dynamics="mixed", n_double=12)
    seeds = [0, 1]
    cbf_a = tsw.default_cbf(cfg, device="cpu")
    cbf_b = tsw.default_cbf(cfg, device="cpu")
    assert cbf_a.k is not cbf_b.k
    step = tens._rollout_executable(cfg, MESH, 2, cbf_a)
    assert tens._rollout_executable(cfg, MESH, 2, cbf_b) is step
    first = tens.sharded_swarm_rollout(cfg, MESH, seeds, cbf=cbf_a)
    again = tens.sharded_swarm_rollout(cfg, MESH, seeds, cbf=cbf_b)
    assert len(step._rollout_programs) == 1
    assert all(torch.equal(a, b) for a, b in zip(teng._leaves(first),
                                                 teng._leaves(again)))
    cbf_c = cbf_a._replace(max_speed=cbf_a.max_speed * 0.5)
    got = tens.sharded_swarm_rollout(cfg, MESH, seeds, cbf=cbf_c)
    assert len(step._rollout_programs) == 1
    alone = tens._build_executable(cfg, MESH, 2, cbf_c)
    want_final, want = teng.eager_rollout(
        alone, tens._initial_carry(cfg, MESH, seeds), cfg.steps)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want_final))
    assert all(torch.equal(a, torch.swapaxes(b, 0, 1))
               for a, b in zip(got[1], want))
    assert not torch.equal(got[0][0], first[0][0])


def _raise(name):
    def fn(*args, **kwargs):
        raise AssertionError(f"{name} inside the capture body")
    return fn


@pytest.mark.parametrize("name", ["single", "unicycle", "orbit_relax",
                                  "lockstep_warm_tol", "verlet"])
def test_capture_body_makes_no_host_traffic(name):
    """tests/test_torch_rollout.py's capture probe on the ensemble's step
    program: after the warm-up body, two steps run as one body with host
    copies (torch.tensor, torch.as_tensor) and host reads patched to
    raise, and equal the eager loop."""
    fields, seeds, _ = ORBIT_RELAX if name == "orbit_relax" else CASES[name]
    cfg, step, carry = _program(fields, seeds)
    prog = teng._program(step, carry, 3, unroll=2)
    prog.load(carry)
    prog.start(0)
    prog.body(step, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "tensor", _raise("torch.tensor"))
        mp.setattr(torch, "as_tensor", _raise("torch.as_tensor"))
        for attr in ("item", "__bool__", "cpu", "__float__", "__int__",
                     "__index__", "tolist", "numpy"):
            mp.setattr(torch.Tensor, attr, _raise(f"Tensor.{attr}"))
        prog.body(step, 2)
    assert not bool(prog.flag)
    want_final, want = teng.eager_rollout(step, carry, 3)
    assert all(torch.equal(a, b) for a, b in zip(
        teng._leaves(prog.carry), teng._leaves(want_final)))
    assert all(torch.equal(a, b) for a, b in zip(prog.outs, want))


def test_chunked_and_resumed_runs_equal_the_straight_run():
    """chunk=3 over 8 steps (a short last chunk) and a warm run split at
    step 5 with its carry are bit-equal to the straight run; metrics of a
    chunked run come back as numpy arrays."""
    fields, seeds, _ = CASES["lockstep_warm_tol"]
    cfg = dataclasses.replace(_port_cfg(fields), steps=8)
    straight, mets = tens.sharded_swarm_rollout(cfg, MESH, seeds,
                                                with_solver_state=True)
    chunked, mets_c = tens.sharded_swarm_rollout(cfg, MESH, seeds, chunk=3,
                                                 with_solver_state=True)
    assert all(torch.equal(a, b) for a, b in zip(teng._leaves(chunked),
                                                 teng._leaves(straight)))
    for a, b in zip(mets_c, mets):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b.numpy())
    head, _ = tens.sharded_swarm_rollout(cfg, MESH, seeds, steps=5,
                                         with_solver_state=True)
    tail, _ = tens.sharded_swarm_rollout(cfg, MESH, seeds, steps=3, t0=5,
                                         initial_state=head,
                                         with_solver_state=True)
    assert all(torch.equal(a, b) for a, b in zip(teng._leaves(tail),
                                                 teng._leaves(straight)))


def test_lockstep_matches_members_solved_alone():
    """tests/test_fused_batched.py's lockstep test, on one card: the
    lockstep batched certificate at E = 2 against each seed run alone
    (E = 1, the certificate inline)."""
    fields, seeds, _ = CASES["lockstep"]
    cfg = dataclasses.replace(_port_cfg(fields), steps=6)
    (xb, _), mb = tens.sharded_swarm_rollout(cfg, MESH, seeds)
    assert float(mb.certificate_residual.max()) < 1e-4
    for e, seed in enumerate(seeds):
        (xs, _), ms = tens.sharded_swarm_rollout(cfg, MESH, [seed])
        np.testing.assert_allclose(xb[e].numpy(), xs[0].numpy(), rtol=0,
                                   atol=LOCKSTEP_ATOL)
        np.testing.assert_allclose(mb.certificate_residual[e].numpy(),
                                   ms.certificate_residual[0].numpy(),
                                   rtol=0, atol=RES_ATOL)


def test_verlet_matches_exact_below_truncation():
    """tests/test_gating_truncation.py's ensemble Verlet test at E = 1:
    the cached run's trajectory equals the exact search's below
    truncation, the sound floor above 0.13, no infeasible QP."""
    fields, seeds, _ = CASES["verlet"]
    cfg = _port_cfg(fields)
    (xc, _), mc = tens.sharded_swarm_rollout(cfg, MESH, seeds)
    exact = dataclasses.replace(cfg, gating_rebuild_skin=0.0)
    (xe, _), _ = tens.sharded_swarm_rollout(exact, MESH, seeds)
    assert torch.equal(xc, xe)
    assert float(mc.nearest_distance.min()) > 0.13
    assert int(mc.infeasible_count.sum()) == 0


@pytest.mark.parametrize("dynamics", ["single", "unicycle"])
def test_initial_states_equal_jax(dynamics):
    jcfg = jsw.Config(n=64, dynamics=dynamics)
    want = jens.ensemble_initial_states(jcfg, [0, 1, 2])
    got = tens.ensemble_initial_states(_port_cfg(dataclasses.asdict(jcfg)),
                                       [0, 1, 2], device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_convert_carries_metrics_and_solver_state():
    mets = jens.EnsembleMetrics(*(
        jnp.arange(6, dtype=dt).reshape(2, 3)
        for dt in (jnp.float32, jnp.int32, jnp.int32, jnp.int32,
                   jnp.float32, jnp.int32, jnp.float32, jnp.int32)))
    got = convert.ensemble_metrics_from_reference(mets)
    assert got._fields == mets._fields
    for g, w in zip(got, mets):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    carry = tuple(np.full((2, s), float(s), np.float32)
                  for s in (8, 12, 8, 12, 8))
    state = convert.solver_state_from_reference(carry, device="cpu",
                                                dtype=torch.float64)
    assert len(state) == 5
    for g, w in zip(state, carry):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="5-tuple"):
        convert.solver_state_from_reference(carry[:4], device="cpu",
                                            dtype=torch.float32)


@pytest.mark.parametrize("override,kwargs", [
    (dict(gating_rebuild_skin=0.1), dict(seeds=[0, 1])),
    (dict(certificate=True, certificate_rebuild_skin=0.1), {}),
    ({}, dict(with_solver_state=True)),
    ({}, dict(chunk=0)),
    ({}, dict(partition="tiles")),
    ({}, dict(partition="spatial", chunk=4)),
    ({}, dict(initial_state=(np.zeros((1, 16, 2)),))),
    ({}, dict(initial_state=(np.zeros((1, 15, 2)), np.zeros((1, 15, 2))))),
    (dict(dynamics="unicycle"),
     dict(initial_state=(np.zeros((1, 16, 2)), np.zeros((1, 16, 2)),
                         np.zeros((1, 15))))),
])
def test_rejections_match_jax(override, kwargs):
    """Every combination the JAX ensemble rejects raises the same error
    type with the same message."""
    fields = dict(n=16, steps=2, **override)
    kw = {"seeds": [0], **kwargs}
    with pytest.raises(ValueError) as jerr:
        jens.sharded_swarm_rollout(jsw.Config(**fields),
                                   jax_mesh(n_dp=1, n_sp=1), **kw)
    if "initial_state" in kw:
        kw["initial_state"] = tuple(torch.as_tensor(a)
                                    for a in kw["initial_state"])
    with pytest.raises(ValueError) as terr:
        tens.sharded_swarm_rollout(_port_cfg(fields), MESH, **kw)
    assert str(terr.value) == str(jerr.value)


class _ListSink:
    def __init__(self):
        self.beats = []

    def heartbeat(self, step, values, ensemble_members=None):
        self.beats.append((step, values, ensemble_members))


def test_mesh_and_what_still_raises():
    """Outside a torch.distributed world there is one rank, so only the
    (1, 1) mesh exists: a wider one raises the JAX package's ValueError
    text (a list of devices names the rank's own); a (dp, sp) Mesh built
    by hand without a world raises; partition="spatial" runs on one tile
    and equals the flat run; telemetry runs. (Meshes over several ranks:
    tests/test_torch_parallel.py.)"""
    assert MESH.shape == {"dp": 1, "sp": 1} and tuple(MESH) == (1, 1)
    assert MESH.device == torch.device("cpu")
    assert make_mesh(n_dp=1, n_sp=1, devices=["cpu"]) == MESH
    for kw, text in ((dict(n_dp=2), "mesh 2x1 exceeds 1 devices"),
                     (dict(n_sp=2), "n_sp=2 must divide device count 1"),
                     (dict(n_dp=1, n_sp=4),
                      "n_sp=4 must divide device count 1")):
        with pytest.raises(ValueError) as err:
            make_mesh(devices="cpu", **kw)
        assert str(err.value) == text
    assert make_mesh(devices=["cpu", "cpu"]) == MESH
    cfg = tsw.Config(n=16, steps=2)
    with pytest.raises(ValueError, match="torch.distributed world"):
        tens.sharded_swarm_rollout(cfg, Mesh(2, 1, torch.device("cpu")),
                                   [0, 1])
    (xs, vs), ms = tens.sharded_swarm_rollout(cfg, MESH, [0],
                                              partition="spatial")
    (xf, vf), mf = tens.sharded_swarm_rollout(cfg, MESH, [0])
    np.testing.assert_allclose(xs.numpy(), xf.numpy(), rtol=0, atol=X_ATOL)
    np.testing.assert_array_equal(ms.engaged_count, mf.engaged_count.numpy())
    # Telemetry (Queue A9) runs: heartbeats from the host metrics.
    sink = _ListSink()
    tens.sharded_swarm_rollout(cfg, MESH, [0, 1], telemetry=sink,
                               telemetry_every=1)
    assert [(step, members) for step, _, members in sink.beats] == [
        (0, 2), (1, 2)]


def test_make_mesh_default_is_the_current_card(monkeypatch):
    """make_mesh() takes the current card alone, however many are visible:
    outside a world there is one rank, so dp > 1 raises the JAX
    package's ValueError text (ranks are started by torchrun or
    parallel.launch)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    mesh = make_mesh()
    assert tuple(mesh) == (1, 1) and mesh.device == torch.device("cuda", 2)
    with pytest.raises(ValueError, match="mesh 4x1 exceeds 1 devices"):
        make_mesh(n_dp=4)


# -- Queue C1: the K solve's implicit gradient under torch.func.vmap --------

def _c1_problem():
    """The re-anchor's probe: N = 6 positions, all 15 pairs, rows
    coef = -2 (x_I - x_J), b = |x_I - x_J|^2 - 0.04, box +-1."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.3, 0.3, (3, 6, 2))
    u_nom = rng.normal(0, 0.5, (6, 2))
    w = rng.normal(size=(6, 2))
    return x, u_nom, w


def _c1_solve_t(u_nom):
    I, J = torch.triu_indices(6, 6, 1)
    settings = tadmm.SparseADMMSettings(iters=30, cg_iters=3)
    box = torch.ones((6, 2), dtype=torch.float64)

    def solve(x):
        d = x[I] - x[J]
        u, _ = tadmm.solve_pair_box_qp_admm(
            torch.as_tensor(u_nom), I, J, -2.0 * d,
            torch.sum(d * d, dim=-1) - 0.04, -box, box, settings)
        return u
    return solve


def test_solve_K_gradient_under_vmap_matches_member_and_jax(x64):
    x, u_nom, w = _c1_problem()
    solve = _c1_solve_t(u_nom)
    wt = torch.as_tensor(w)
    xv = torch.tensor(x, requires_grad=True)
    g_vmap, = torch.autograd.grad(
        torch.sum(torch.func.vmap(solve)(xv) * wt), xv)

    I, J = np.triu_indices(6, 1)
    settings = jadmm.SparseADMMSettings(iters=30, cg_iters=3)

    def loss_j(xm):
        d = xm[I] - xm[J]
        u, _ = jadmm.solve_pair_box_qp_admm(
            jnp.asarray(u_nom), jnp.asarray(I, jnp.int32),
            jnp.asarray(J, jnp.int32), -2.0 * d,
            jnp.sum(d * d, axis=-1) - 0.04, -jnp.ones((6, 2)),
            jnp.ones((6, 2)), settings)
        return jnp.sum(u * w)

    g_jax = np.asarray(jax.vmap(jax.grad(loss_j))(jnp.asarray(x)))
    scale = np.abs(g_jax).max()
    np.testing.assert_allclose(g_vmap.numpy(), g_jax, rtol=0,
                               atol=GRAD_JAX_RTOL * scale)
    for b in range(x.shape[0]):
        xb = torch.tensor(x[b], requires_grad=True)
        g_one, = torch.autograd.grad(torch.sum(solve(xb) * wt), xb)
        np.testing.assert_allclose(g_vmap[b].numpy(), g_one.numpy(),
                                   rtol=0, atol=GRAD_SELF_ATOL)


def test_solve_K_forward_under_vmap_unchanged(x64):
    """Under vmap the Function's fold gives the same forward, bit for
    bit, as the K solve's plain operations batched by vmap."""
    x, u_nom, _ = _c1_problem()
    solve = _c1_solve_t(u_nom)

    def solve_plain(xm):
        with torch.no_grad():         # the K solve outside its Function
            return solve(xm)

    xt = torch.as_tensor(x)
    assert torch.equal(torch.func.vmap(solve)(xt),
                       torch.func.vmap(solve_plain)(xt))
