"""Runtime-assurance primitives (counterpart: cbf_tpu/rta/core.py).

Plain torch ops on signals the swarm step already computes, with no host
read, so they run inside the compiled rollout's captured body:

- a per-agent int32 **health word** (:func:`health_word`) of the bits
  below;
- the **rungs** it demands (:func:`demanded_rung`, highest wins): 1, a
  boosted-budget re-solve of the flagged agents' QPs; 2, the closed-form
  braking-to-stop :func:`backup_control`; 3, the lane scrub to the
  last-known-good row plus a stop command;
- the engagement **latch** with recovery hysteresis
  (:func:`latch_update`): escalation is immediate, release waits for
  ``recover_steps`` consecutive healthy steps.
"""

from __future__ import annotations

import torch

from cbf_tpu_torch.utils.math import l2_cap

# -- health-word bits (per agent, int32) -----------------------------------

BIT_INFEASIBLE = 1 << 0          # rung 1: relax-budget/cap exhaustion
BIT_CERT_RESIDUAL = 1 << 1       # rung 2: certificate residual > gate
BIT_CARRY_RESET = 1 << 2         # rung 2: non-finite warm carry reset
BIT_ACTUATION_DEFICIT = 1 << 3   # rung 2: unicycle saturation deficit
BIT_STATE_NONFINITE = 1 << 4     # rung 3: non-finite state row
BIT_CONTROL_NONFINITE = 1 << 5   # rung 3: non-finite control row

#: bit name -> value, the monitor's decode table.
HEALTH_BIT_NAMES: dict[str, int] = {
    "infeasible": BIT_INFEASIBLE,
    "cert_residual": BIT_CERT_RESIDUAL,
    "carry_reset": BIT_CARRY_RESET,
    "actuation_deficit": BIT_ACTUATION_DEFICIT,
    "state_nonfinite": BIT_STATE_NONFINITE,
    "control_nonfinite": BIT_CONTROL_NONFINITE,
}

# -- ladder rungs ----------------------------------------------------------

RUNG_NOMINAL = 0
RUNG_RESOLVE = 1    # boosted-budget selective QP re-solve
RUNG_BACKUP = 2     # closed-form braking-to-stop backup controller
RUNG_SCRUB = 3      # lane scrub: last-known-good state + stop command

_RUNG3_MASK = BIT_STATE_NONFINITE | BIT_CONTROL_NONFINITE
_RUNG2_MASK = BIT_CERT_RESIDUAL | BIT_CARRY_RESET | BIT_ACTUATION_DEFICIT
_RUNG1_MASK = BIT_INFEASIBLE


def finite_rows(*leaves):
    """(N,) bool — per agent, every given leaf's row finite. Leaves are
    (N,), (N, d), ... tensors; ``()`` (a disabled channel) is skipped. At
    least one tensor leaf is required."""
    ok = None
    for leaf in leaves:
        if isinstance(leaf, tuple):
            continue
        f = torch.isfinite(leaf)
        if f.dim() > 1:
            f = torch.all(f.reshape(f.shape[0], -1), dim=1)
        ok = f if ok is None else ok & f
    if ok is None:
        raise ValueError("finite_rows needs at least one non-() leaf")
    return ok


def health_word(n: int, *, infeasible=None, cert_residual=None,
                carry_reset=None, actuation_deficit=None,
                state_nonfinite=None, control_nonfinite=None, device=None):
    """(N,) int32 health word from the step's signals (None = the bit is
    absent in this configuration). A flag is an (N,) or 0-dim bool tensor
    (0-dim flags, the swarm-wide certificate bits, reach every agent) or a
    Python bool. ``device`` defaults to the first tensor flag's."""
    flags = ((BIT_INFEASIBLE, infeasible),
             (BIT_CERT_RESIDUAL, cert_residual),
             (BIT_CARRY_RESET, carry_reset),
             (BIT_ACTUATION_DEFICIT, actuation_deficit),
             (BIT_STATE_NONFINITE, state_nonfinite),
             (BIT_CONTROL_NONFINITE, control_nonfinite))
    if device is None:
        device = next((f.device for _, f in flags
                       if isinstance(f, torch.Tensor)), "cpu")
    word = torch.zeros((n,), dtype=torch.int32, device=device)
    for bit, flag in flags:
        if flag is None:
            continue
        if isinstance(flag, torch.Tensor):
            hit = flag.to(torch.bool).expand(n)
        else:
            hit = torch.full((n,), bool(flag), dtype=torch.bool,
                             device=device)
        word = torch.where(hit, word | bit, word)
    return word


def demanded_rung(health):
    """(N,) int32 rung demanded by a health word — highest wins."""
    zero = torch.zeros_like(health)
    rung = torch.where((health & _RUNG1_MASK) > 0, RUNG_RESOLVE, zero)
    rung = torch.where((health & _RUNG2_MASK) > 0, RUNG_BACKUP, rung)
    return torch.where((health & _RUNG3_MASK) > 0, RUNG_SCRUB, rung)


def latch_update(mode, streak, demanded, recover_steps: int):
    """One latch step: ``(mode', streak')`` (int32) from the carried
    per-agent latch and this step's demanded rung. Escalation is
    immediate (``max``); release needs ``recover_steps`` consecutive
    demanded-0 steps and resets the streak, which is clamped at
    ``recover_steps``."""
    streak = torch.where(demanded > 0, 0,
                         torch.clamp(streak + 1, max=recover_steps))
    latched = torch.maximum(mode, demanded)
    recovered = (demanded == 0) & (streak >= recover_steps) & (latched > 0)
    return (torch.where(recovered, RUNG_NOMINAL, latched),
            torch.where(recovered, 0, streak))


def backup_control(v, *, dynamics: str, vel_tracking_tau: float = 0.2,
                   accel_limit: float = 1.0, dynamics_mask=None):
    """(N, 2) closed-form backup command (rungs 2-3), no iterative solve.

    single/unicycle (velocity commands): zero — the agent holds its
    (projection) point. double (acceleration commands): maximal braking,
    the velocity-tracking PD at a zero setpoint capped at the actuator
    limit. mixed: ``dynamics_mask`` (N,) bool picks the double rows, which
    brake while single rows hold; the mask is required there."""
    if dynamics == "double":
        return l2_cap(-v / vel_tracking_tau, accel_limit)
    if dynamics == "mixed":
        if dynamics_mask is None:
            raise ValueError(
                'backup_control(dynamics="mixed") requires dynamics_mask')
        return torch.where(dynamics_mask[:, None],
                           l2_cap(-v / vel_tracking_tau, accel_limit),
                           torch.zeros_like(v))
    return torch.zeros_like(v)


def rta_seed(x, v, theta=()):
    """Fresh RTA carry for ``State.rta``: ``(mode (N,) int32, streak (N,)
    int32, lkg_x, lkg_v, lkg_theta)`` — everyone nominal, last-known-good
    the given (finite) state. ``theta`` is ``()`` outside unicycle mode."""
    n = x.shape[0]
    zeros = torch.zeros((n,), dtype=torch.int32, device=x.device)
    return (zeros, zeros.clone(), x, v, theta)
