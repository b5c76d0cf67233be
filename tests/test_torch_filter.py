"""The port's filter stack (cbf_tpu_torch.core / .solvers) against the JAX
package's (cbf_tpu.core.barrier, cbf_tpu.core.filter,
cbf_tpu.solvers.exact2d) on the same numpy inputs — the torch twin of
tests/test_exact2d.py and tests/test_filter_parity.py.

Tolerances: float64 atol 1e-12, float32 atol 1e-5 (the two packages sum
the 4-term contractions and reduce in their own orders); feasibility
flags and relax-round counts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.core import barrier as jbar
from cbf_tpu.core import filter as jfil
from cbf_tpu.oracle.reference_filter import OracleCBF, solve_qp_slsqp
from cbf_tpu.solvers import exact2d as jqp
from cbf_tpu_torch.core import barrier as tbar
from cbf_tpu_torch.core import filter as tfil
from cbf_tpu_torch.solvers import exact2d as tqp

ATOL = {np.float64: 1e-12, np.float32: 1e-5}
# Continuous rows (meet_at_center.py:26-27) and the discrete rows the
# swarm's barrier="discrete" builds (f couples position to velocity).
FX = 0.1 * np.zeros((4, 4))
GX = 0.1 * np.array([[1.0, 0], [0, 1.0], [0, 0], [0, 0]])
FD = 0.033 * np.array([[0, 0, 1.0, 0], [0, 0, 0, 1.0], [0, 0, 0, 0],
                       [0, 0, 0, 0]])
GD = 0.033 * np.array([[1.0, 0], [0, 1.0], [0, 0], [0, 0]])
DYN = {"continuous": (FX, GX), "discrete": (FD, GD)}
KW = dict(dmin=0.2, k=1.0, gamma=0.5, max_speed=15.0)


def _j(a, dt):
    return jnp.asarray(np.asarray(a, dt))


def _t(a, dt):
    return torch.as_tensor(np.asarray(a, dt))


def _close(got, want, dt, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=ATOL[dt], **kw)


def _batch(rng, N=64, K=7):
    """Random agents/obstacles with the subtle cases pinned: agent 0 an
    infeasible sandwich (relax rounds), agent 1 an all-False mask (empty
    sign classes), agent 2 an obstacle at d == 0 on one axis (sign +1)."""
    states = rng.uniform(-1, 1, size=(N, 4))
    obs = rng.uniform(-1, 1, size=(N, K, 4))
    mask = rng.uniform(size=(N, K)) < 0.6
    u0 = rng.uniform(-0.5, 0.5, size=(N, 2))
    states[0] = [0.0, 0.0, 50.0, 0.0]
    obs[0, :2] = [[0.01, 0.0, -50.0, 0.0], [-0.01, 0.0, 50.0, 0.0]]
    mask[0] = np.r_[True, True, np.zeros(K - 2, bool)]
    u0[0] = 0.0
    mask[1] = False
    obs[2, 0, 0] = states[2, 0]
    mask[2, 0] = True
    priority = rng.uniform(size=(N, K)) < 0.3
    return states, obs, mask, u0, priority


@pytest.fixture(params=[np.float64, np.float32], ids=["f64", "f32"])
def dt(request):
    if request.param is np.float64:
        request.getfixturevalue("x64")
    return request.param


@pytest.mark.parametrize("dyn", ["continuous", "discrete"])
@pytest.mark.parametrize("layout,vel_box", [(True, True), (False, True),
                                            (True, False)])
@pytest.mark.parametrize("with_priority", [False, True])
def test_assemble_qp_dedup_matches_jax(dt, dyn, layout, vel_box,
                                       with_priority):
    states, obs, mask, u0, priority = _batch(np.random.default_rng(3))
    f, g = DYN[dyn]
    kw = dict(KW, reference_layout=layout, vel_box_rows=vel_box)
    pri_j = _j(priority, bool) if with_priority else None
    pri_t = _t(priority, bool) if with_priority else None
    want = jbar.assemble_qp_dedup(_j(states, dt), _j(obs, dt),
                                  _j(mask, bool), _j(f, dt), _j(g, dt),
                                  _j(u0, dt), priority_mask=pri_j, **kw)
    got = tbar.assemble_qp_dedup(_t(states, dt), _t(obs, dt),
                                 _t(mask, bool), _t(f, dt), _t(g, dt),
                                 _t(u0, dt), priority_mask=pri_t, **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.from_numpy(np.zeros(1, dt)).dtype
        _close(a, b, dt)


@pytest.mark.parametrize("dyn", ["continuous", "discrete"])
@pytest.mark.parametrize("with_priority", [False, True])
def test_assemble_qp_matches_jax(dt, dyn, with_priority):
    states, obs, mask, u0, priority = _batch(np.random.default_rng(4), N=6)
    f, g = DYN[dyn]
    for i in range(states.shape[0]):
        pj = _j(priority[i], bool) if with_priority else None
        pt = _t(priority[i], bool) if with_priority else None
        want = jbar.assemble_qp(_j(states[i], dt), _j(obs[i], dt),
                                _j(mask[i], bool), _j(f, dt), _j(g, dt),
                                _j(u0[i], dt), priority_mask=pj, **KW)
        got = tbar.assemble_qp(_t(states[i], dt), _t(obs[i], dt),
                               _t(mask[i], bool), _t(f, dt), _t(g, dt),
                               _t(u0[i], dt), priority_mask=pt, **KW)
        for a, b in zip(got, want):
            _close(a, b, dt, err_msg=f"agent {i}")


# -- exact 2-D QP (mirrors tests/test_exact2d.py) ---------------------------

QP_CASES = {
    "origin": ([[1.0, 0.0], [0.0, 1.0]], [5.0, 5.0], None),
    "one_row": ([[1.0, 0.0]], [-2.0], None),
    "two_rows": ([[1.0, 0.0], [0.0, 1.0]], [-1.0, -1.0], None),
    "masked_rows": ([[1.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
                    [-2.0, 1e6, 1e6], None),
    "infeasible": ([[1.0, 0.0], [-1.0, 0.0]], [-1.0, -1.0], None),
    "relax_once": ([[1.0, 0.0], [-1.0, 0.0]], [-1.0, -1.0], [1.0, 1.0]),
    "relax_twice": ([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0]],
                    [-1.5, -1.5, 3.0], [1.0, 1.0, 0.0]),
}


def _qp_pair(A, b, relax, dt, unroll=0, cap=None):
    jkw = {} if unroll == 0 else {"unroll_relax": unroll}
    xj, ij = jqp.solve_qp_2d(
        _j(A, dt), _j(b, dt), None if relax is None else _j(relax, dt),
        relax_cap=None if cap is None else _j(cap, dt), **jkw)
    xt, it = tqp.solve_qp_2d(
        _t(A, dt), _t(b, dt), None if relax is None else _t(relax, dt),
        unroll_relax=unroll, relax_cap=None if cap is None else _t(cap, dt))
    return (xj, ij), (xt, it)


def _assert_info(it, ij, dt):
    assert bool(it.feasible) == bool(ij.feasible)
    assert float(it.relax_rounds) == float(ij.relax_rounds)
    _close(it.max_violation, ij.max_violation, dt)


@pytest.mark.parametrize("unroll", [0, 8])
@pytest.mark.parametrize("case", sorted(QP_CASES))
def test_solve_qp_2d_cases_match_jax(dt, case, unroll):
    A, b, relax = QP_CASES[case]
    (xj, ij), (xt, it) = _qp_pair(A, b, relax, dt, unroll)
    _close(xt, xj, dt)
    _assert_info(it, ij, dt)


def test_solve_qp_2d_relax_cap_matches_jax(x64):
    # Row 0 capped at 0.5 total slack: the uncapped row 1 relaxes alone.
    A, b = [[1.0, 0.0], [-1.0, 0.0]], [-1.0, -1.0]
    for unroll in (0, 8):
        (xj, ij), (xt, it) = _qp_pair(A, b, [1.0, 1.0], np.float64, unroll,
                                      cap=[0.5, np.inf])
        _close(xt, xj, np.float64)
        _assert_info(it, ij, np.float64)
        assert float(it.relax_rounds) == 2.0


@pytest.mark.parametrize("m", [1, 3, 8, 16])
def test_random_polyhedra_match_jax_and_slsqp(x64, m):
    rng = np.random.default_rng(m)
    for trial in range(10):
        A = rng.normal(size=(m, 2))
        b = rng.normal(size=(m,)) + 0.5
        (xj, ij), (xt, it) = _qp_pair(A, b, None, np.float64)
        _close(xt, xj, np.float64, err_msg=f"trial {trial}")
        _assert_info(it, ij, np.float64)
        x_ref, feas_ref = solve_qp_slsqp(A, b)
        if feas_ref and bool(it.feasible):
            np.testing.assert_allclose(xt.numpy(), x_ref, atol=1e-5)
        xp, vp, violp = tqp.project_polyhedron_2d(_t(A, np.float64),
                                                  _t(b, np.float64))
        _close(xp, xt, np.float64)


def _relax_batch(rng, B=48, M=10):
    A = rng.normal(size=(B, M, 2))
    b = rng.normal(size=(B, M)) + 0.5
    relax = (rng.uniform(size=(B, M)) < 0.5).astype(float)
    # Lanes 0-2: infeasible strips of width 1, 3 and 5 in x, which open
    # after one, two and three +1 relax rounds.
    for lane, gap in enumerate((1.0, 3.0, 5.0)):
        A[lane, :2] = [[1.0, 0.0], [-1.0, 0.0]]
        b[lane, :2] = [-gap / 2, -gap / 2]
        relax[lane, :2] = 1.0
    return A, b, relax


@pytest.mark.parametrize("with_cap", [False, True])
def test_solve_qp_2d_batch_matches_jax(dt, with_cap):
    A, b, relax = _relax_batch(np.random.default_rng(5))
    cap = None
    if with_cap:
        cap = np.where(np.random.default_rng(6).uniform(size=b.shape) < 0.3,
                       0.25, np.inf)
        cap[:3, 1] = np.inf         # the strips keep an uncapped row
    xj, ij = jqp.solve_qp_2d_batch(
        _j(A, dt), _j(b, dt), _j(relax, dt),
        relax_cap=None if cap is None else _j(cap, dt))
    xt, it = tqp.solve_qp_2d_batch(
        _t(A, dt), _t(b, dt), _t(relax, dt),
        relax_cap=None if cap is None else _t(cap, dt))
    assert float(it.relax_rounds.max()) >= 3.0
    np.testing.assert_array_equal(it.feasible.numpy(),
                                  np.asarray(ij.feasible))
    np.testing.assert_array_equal(it.relax_rounds.numpy(),
                                  np.asarray(ij.relax_rounds))
    _close(xt, xj, dt)
    _close(it.max_violation, ij.max_violation, dt)


def test_solve_qp_2d_batch_respects_max_relax(x64):
    # A strip no +1 schedule can open within 3 rounds stops at the cap,
    # reported infeasible with t == max_relax.
    A = np.array([[[1.0, 0.0], [-1.0, 0.0]]])
    b = np.array([[-10.0, -10.0]])
    relax = np.ones((1, 2))
    xj, ij = jqp.solve_qp_2d_batch(_j(A, np.float64), _j(b, np.float64),
                                   _j(relax, np.float64), max_relax=3)
    xt, it = tqp.solve_qp_2d_batch(_t(A, np.float64), _t(b, np.float64),
                                   _t(relax, np.float64), max_relax=3)
    assert not bool(it.feasible[0]) and float(it.relax_rounds[0]) == 3.0
    _assert_info(_lane0(it), _lane0(ij), np.float64)
    _close(xt, xj, np.float64)


def _lane0(info):
    return type(info)(*(v[0] for v in info))


# -- the filter (mirrors tests/test_filter_parity.py) -----------------------

def _filter_pair(dt, rng, *, with_priority, relax_cap=None, unroll=0,
                 dyn="continuous"):
    states, obs, mask, u0, priority = _batch(rng, N=48, K=6)
    if relax_cap is not None:
        # The caps' caller contract: every agent keeps an uncapped
        # (priority) row, else an infeasible QP can only end on a
        # least-violating control, which is not unique.
        priority[:, 0] = True
    f, g = DYN[dyn]
    params_j = jfil.CBFParams(max_speed=15.0, k=1.0)
    params_t = tfil.CBFParams(max_speed=15.0, k=1.0)
    kw = dict(relax_cap=relax_cap, unroll_relax=unroll)
    uj, ij = jfil.safe_controls(
        _j(states, dt), _j(obs, dt), _j(mask, bool), _j(f, dt), _j(g, dt),
        _j(u0, dt), params_j,
        priority_mask=_j(priority, bool) if with_priority else None, **kw)
    ut, it = tfil.safe_controls(
        _t(states, dt), _t(obs, dt), _t(mask, bool), _t(f, dt), _t(g, dt),
        _t(u0, dt), params_t,
        priority_mask=_t(priority, bool) if with_priority else None, **kw)
    return (uj, ij), (ut, it)


@pytest.mark.parametrize("dyn", ["continuous", "discrete"])
@pytest.mark.parametrize("unroll", [0, 4])
@pytest.mark.parametrize("with_priority", [False, True])
def test_safe_controls_match_jax(dt, with_priority, unroll, dyn):
    (uj, ij), (ut, it) = _filter_pair(dt, np.random.default_rng(8),
                                      with_priority=with_priority,
                                      unroll=unroll, dyn=dyn)
    _close(ut, uj, dt)
    np.testing.assert_array_equal(it.feasible.numpy(),
                                  np.asarray(ij.feasible))
    np.testing.assert_array_equal(it.relax_rounds.numpy(),
                                  np.asarray(ij.relax_rounds))
    assert float(it.relax_rounds[0]) >= 1.0      # the sandwich relaxed


@pytest.mark.parametrize("unroll", [0, 4])
def test_safe_controls_relax_cap_matches_jax(x64, unroll):
    (uj, ij), (ut, it) = _filter_pair(np.float64, np.random.default_rng(9),
                                      with_priority=True, relax_cap=0.05,
                                      unroll=unroll)
    _close(ut, uj, np.float64)
    np.testing.assert_array_equal(it.relax_rounds.numpy(),
                                  np.asarray(ij.relax_rounds))
    if unroll == 0:
        # Only the sandwich (agent 0) outlasts 64 eps rounds of its
        # priority row; every other agent ends feasible under the cap.
        assert bool(it.feasible[1:].all())


def test_safe_control_single_agent_matches_jax_and_oracle(x64):
    rng = np.random.default_rng(10)
    oracle = OracleCBF(max_speed=15.0)
    for trial in range(10):
        robot = rng.uniform(-1.5, 1.5, size=4)
        robot[2:] = rng.uniform(-0.3, 0.3, size=2)
        obs = np.tile(robot, (3, 1))
        obs[:, :2] += rng.uniform(-0.2, 0.2, size=(3, 2))
        obs[:, 2:] = rng.uniform(-0.3, 0.3, size=(3, 2))
        u0 = rng.uniform(-0.5, 0.5, size=2)
        uj, ij = jfil.safe_control(*(_j(a, np.float64) for a in
                                     (robot, obs)), jnp.ones(3, bool),
                                   _j(FX, np.float64), _j(GX, np.float64),
                                   _j(u0, np.float64))
        ut, it = tfil.safe_control(*(_t(a, np.float64) for a in
                                     (robot, obs)), torch.ones(3, dtype=bool),
                                   _t(FX, np.float64), _t(GX, np.float64),
                                   _t(u0, np.float64))
        _close(ut, uj, np.float64, err_msg=f"trial {trial}")
        _assert_info(it, ij, np.float64)
        np.testing.assert_allclose(
            ut.numpy(), oracle.get_safe_control(robot, obs, FX, GX, u0),
            atol=1e-6)


def test_relax_cap_needs_priority_mask():
    (states, obs, mask, u0, _) = _batch(np.random.default_rng(11), N=4)
    args = (_t(states, np.float32), _t(obs, np.float32), _t(mask, bool),
            _t(FX, np.float32), _t(GX, np.float32), _t(u0, np.float32))
    for unroll in (0, 2):
        with pytest.raises(ValueError, match="relax_cap requires"):
            tfil.safe_controls(*args, relax_cap=0.05, unroll_relax=unroll)


def test_per_agent_dynamics_path_matches_jax(dt):
    """Per-agent f (N, 4, 4) and g (N, 4, 2) — here every lane the same
    discrete rows — through the full-row per-agent path: equal to JAX's
    vmap and to the port's shared-dynamics (deduplicated) path."""
    (states, obs, mask, u0, _) = _batch(np.random.default_rng(12), N=12)
    f3 = np.broadcast_to(FD, (12, 4, 4))
    g3 = np.broadcast_to(GD, (12, 4, 2))
    args = [states, obs, mask, f3, g3, u0]
    uj, ij = jfil.safe_controls(*(_j(a, bool if a is mask else dt)
                                  for a in args))
    ut, it = tfil.safe_controls(*(_t(a, bool if a is mask else dt)
                                  for a in args))
    _close(ut, uj, dt)
    np.testing.assert_array_equal(it.feasible.numpy(),
                                  np.asarray(ij.feasible))
    np.testing.assert_array_equal(it.relax_rounds.numpy(),
                                  np.asarray(ij.relax_rounds))
    us, _ = tfil.safe_controls(*(_t(a, bool if a is mask else dt) for a in
                                 (states, obs, mask, FD, GD, u0)))
    _close(ut, us, dt)


def test_masked_row_constants_match():
    assert tbar.MASKED_ROW_RHS == jbar.MASKED_ROW_RHS
    assert tqp._BIG == jqp._BIG
    assert tqp._feas_tol(torch.float64) == jqp._feas_tol(jnp.float64)
    assert tqp._feas_tol(torch.float32) == jqp._feas_tol(jnp.float32)
