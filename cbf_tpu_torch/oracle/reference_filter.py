"""Pure-numpy oracle of the reference CBF safety filter (a copy of
cbf_tpu/oracle/reference_filter.py, kept in the port so a check on a
machine without the JAX package has an independent oracle).

A float64 numpy re-implementation of the behavioural contract of the
reference ``ControlBarrierFunction`` (its cbf.py:5-92), backed by an
independent QP solver (scipy SLSQP).

Behavioural contract (line numbers in the reference's cbf.py):

1. Per-obstacle barrier rows (cbf.py:38-59):
   d = robot_state - obs_state;  hs_p = [sx, sy, k*sx, k*sy] with
   sx = -1 iff d[0] < 0 else +1 (cbf.py:47-53; d == 0 keeps +1).
   A_row = -hs_p @ g (cbf.py:56)
   b_row = gamma*(hs_p@d - dmin) + hs_p@(f@d) + hs_p@(g@u0)  (cbf.py:58-59)
2. Box rows (cbf.py:66-70) in the reference's exact layout, including its
   row/RHS pairing quirk: G rows are
   [1,0],[0,1],[-1,0],[0,-1],[1,0],[-1,0],[0,1],[0,-1] and the RHS vector is
   [ms-u0x, ms+u0x, ms-u0y, ms+u0y, ms-vx-u0x, ms+vx+u0x, ms-vy-u0y,
    ms+vy+u0y] — rows 1-3 pair a y-direction row with an x bound (and
   vice versa).
3. QP: min ||du||^2 s.t. A du <= b (cbf.py:61-76), the decision variable
   is the delta around the nominal control.
4. Infeasibility relaxation (cbf.py:78-87): on solver failure, add +1 to
   the RHS of every CBF row (not the box rows) and retry.
5. Output (cbf.py:89-92): u = du + u0, componentwise clamp to ±max_speed.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize


def _box_rows(robot_state: np.ndarray, u0: np.ndarray, max_speed: float):
    """Reference box-constraint block, exact layout of cbf.py:66-70."""
    G = np.array(
        [
            [1.0, 0.0],
            [0.0, 1.0],
            [-1.0, 0.0],
            [0.0, -1.0],
            [1.0, 0.0],
            [-1.0, 0.0],
            [0.0, 1.0],
            [0.0, -1.0],
        ]
    )
    ms = max_speed
    vx, vy = float(robot_state[2]), float(robot_state[3])
    u0x, u0y = float(u0[0]), float(u0[1])
    S = np.array(
        [
            ms - u0x,
            ms + u0x,
            ms - u0y,
            ms + u0y,
            ms - vx - u0x,
            ms + vx + u0x,
            ms - vy - u0y,
            ms + vy + u0y,
        ]
    )
    return G, S


def solve_qp_slsqp(A: np.ndarray, b: np.ndarray, tol: float = 1e-10):
    """min ||x||^2 s.t. A x <= b via SLSQP. Returns (x, feasible).

    Independent of the framework's enumeration solver so that parity tests
    cross-check two different algorithms. Infeasibility is signaled by
    SLSQP failure or a residual violation > 1e-7 (the oracle analogue of
    cvxopt's ValueError at cbf.py:84).
    """
    res = minimize(
        lambda x: float(x @ x),
        x0=np.zeros(2),
        jac=lambda x: 2.0 * x,
        constraints=[{"type": "ineq", "fun": lambda x: b - A @ x, "jac": lambda x: -A}],
        method="SLSQP",
        tol=tol,
        options={"maxiter": 600},
    )
    x = res.x
    viol = float(np.max(A @ x - b)) if len(b) else 0.0
    feasible = bool(res.success) and viol <= 1e-7
    return x, feasible


class OracleCBF:
    """Float64 oracle with the reference ControlBarrierFunction's interface.

    Reference: cbf.py:5-16 (constructor: max_speed, dmin=0.2, k=1, gamma=0.5).
    """

    def __init__(self, max_speed, dmin=0.2, k=1.0, gamma=0.5, max_relax=64,
                 qp_backend=None):
        self.max_speed = float(max_speed)
        self.dmin = float(dmin)
        self.k = float(k)
        self.gamma = float(gamma)
        self.max_relax = int(max_relax)
        self.qp_backend = qp_backend or solve_qp_slsqp
        # Diagnostics from the most recent solve.
        self.last_relax_rounds = 0

    def barrier_rows(self, robot_state, obs_states, f, g, u0):
        """CBF constraint rows A_cbf (m,2), b_cbf (m,). Reference: cbf.py:38-59."""
        robot_state = np.asarray(robot_state, dtype=np.float64).reshape(4)
        obs_states = np.asarray(obs_states, dtype=np.float64).reshape(-1, 4)
        u0 = np.asarray(u0, dtype=np.float64).reshape(2)
        rows_A, rows_b = [], []
        for obs in obs_states:
            d = robot_state - obs
            sx = -1.0 if d[0] < 0 else 1.0
            sy = -1.0 if d[1] < 0 else 1.0
            hs = np.array([sx, sy, self.k * sx, self.k * sy])
            h = hs @ d - self.dmin
            L_f = hs @ (f @ d)
            rows_A.append(-hs @ g)
            rows_b.append(self.gamma * h + L_f + hs @ (g @ u0))
        return np.array(rows_A).reshape(-1, 2), np.array(rows_b).reshape(-1)

    def get_safe_control(self, robot_state, obs_states, f, g, u0):
        """Filtered control u. Mirrors cbf.py:18-92 end to end."""
        robot_state = np.asarray(robot_state, dtype=np.float64).reshape(4)
        u0 = np.asarray(u0, dtype=np.float64).reshape(2)
        f = np.asarray(f, dtype=np.float64)
        g = np.asarray(g, dtype=np.float64)

        A_cbf, b_cbf = self.barrier_rows(robot_state, obs_states, f, g, u0)
        G, S = _box_rows(robot_state, u0, self.max_speed)
        A = np.vstack([A_cbf, G])

        # Relax-retry loop (cbf.py:78-87), bounded instead of unbounded.
        du = None
        for t in range(self.max_relax):
            b = np.concatenate([b_cbf + float(t), S])
            du, feasible = self.qp_backend(A, b)
            self.last_relax_rounds = t
            if feasible:
                break
        else:
            # The reference would spin forever here; the oracle fails loudly
            # so parity tests never compare against an unvetted control.
            raise RuntimeError(
                f"oracle QP still infeasible after {self.max_relax} relax rounds"
            )
        u = du + u0
        return np.clip(u, -self.max_speed, self.max_speed)
