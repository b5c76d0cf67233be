"""Robustness margins: the falsification subsystem's property layer
(counterpart: cbf_tpu/verify/properties.py).

Each property is a scalar margin computed from a rollout's record
(:class:`cbf_tpu_torch.rollout.engine.StepOutputs` stacked over time and
the final positions) with ``margin < 0 <=> violated``, so search engines
can descend on it and the shrinker can bisect it. The torch forms run on
the rollout's device after the rollout and differentiate where the step
does; a NumPy twin (:func:`rollout_margins_np`) recomputes them on host
records. Vacuous properties are +inf, never 0. See the JAX module for
each property's rationale.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class Margins(NamedTuple):
    """One scalar margin per property; ``< 0`` <=> violation."""
    separation: Any
    boundary: Any
    obstacle_clearance: Any
    sustained_infeasibility: Any
    goal_reach: Any
    rta_soundness: Any


PROPERTY_NAMES: tuple[str, ...] = Margins._fields

#: Properties with a usable gradient w.r.t. the initial state.
DIFFERENTIABLE_PROPERTIES: tuple[str, ...] = (
    "separation", "boundary", "obstacle_clearance", "goal_reach")


@dataclasses.dataclass(frozen=True)
class PropertyThresholds:
    """Per-scenario constants the margins are signed against (the JAX
    package's calibrated defaults)."""
    separation_floor: float = 0.13
    boundary_half: float | None = None
    obstacle_floor: float = 0.13
    infeasible_streak_limit: int = 25
    goal_slack: float = 0.5
    goal_radius: float | None = None
    rta_floor: float | None = None


def thresholds_for(scenario: str, cfg) -> PropertyThresholds:
    """Calibrated default thresholds per scenario, the JAX package's."""
    if scenario == "meet_at_center":
        return PropertyThresholds(separation_floor=0.05, boundary_half=2.0)
    if scenario == "cross_and_rescue":
        return PropertyThresholds(separation_floor=0.13, boundary_half=2.0)
    if scenario == "antipodal":
        return PropertyThresholds(
            separation_floor=0.13,
            boundary_half=float(cfg.circle_radius) + 1.0)
    if scenario != "swarm":
        raise ValueError(f"no calibrated thresholds for scenario "
                         f"{scenario!r}")
    floor = {"single": 0.13, "double": 0.08, "mixed": 0.08,
             "unicycle": 0.11}[cfg.dynamics]
    half = (cfg.arena_half_override if cfg.arena_half_override
            is not None else 1.5 * cfg.spawn_half_width)
    if cfg.spawn != "grid" or cfg.goal != "rendezvous":
        from cbf_tpu_torch.scenarios import swarm as _swarm
        lay, spacing = _swarm.spawn_layout(cfg)
        lay_max = float(np.max(np.abs(lay))) + 0.25 * spacing
        goals = _swarm.goal_layout(cfg)
        if goals is not None:
            lay_max = max(lay_max, float(np.max(np.abs(goals))))
        half = max(float(half), lay_max + 1.0)
        floor = min(floor, 0.08)
    goal_radius = None
    if cfg.goal == "rendezvous":
        d0max = float(np.sqrt(2.0) * cfg.spawn_half_width) + 0.3
        travel = 0.5 * cfg.speed_limit * cfg.dt * cfg.steps
        goal_radius = (float(cfg.pack_radius)
                       if travel >= d0max - cfg.pack_radius else None)
    return PropertyThresholds(
        separation_floor=floor, boundary_half=float(half),
        obstacle_floor=0.13, goal_radius=goal_radius)


def _longest_true_run(flags):
    """Longest run of True in a (T,) bool tensor, in closed form: each
    step's run length is its index less the index of the last False at or
    before it (a running max), so no loop over T runs."""
    idx = torch.arange(flags.shape[-1], device=flags.device)
    last_false = torch.cummax(torch.where(flags, -1, idx), dim=-1).values
    return torch.amax(idx - last_false, dim=-1)


def rollout_margins(th: PropertyThresholds, outs, final_positions, *,
                    trajectory=None, obstacle_fn: Callable | None = None
                    ) -> Margins:
    """All property margins of one rollout record: ``outs`` stacked over
    time, ``final_positions`` (N, 2), an optional (T, N, 2)
    ``trajectory`` (whole-run boundary check, obstacle clearance) and
    ``obstacle_fn(T) -> (T, M, 2)`` obstacle positions on the record's
    device. Composes with ``torch.func.vmap`` and autograd."""
    dt_ = final_positions.dtype
    dev = final_positions.device
    inf = torch.full((), torch.inf, dtype=dt_, device=dev)

    separation = (torch.amin(outs.min_pairwise_distance)
                  - th.separation_floor).to(dt_)
    if th.boundary_half is None:
        boundary = inf
    else:
        pos = final_positions if trajectory is None else trajectory
        boundary = (th.boundary_half - torch.amax(torch.abs(pos))).to(dt_)
    if trajectory is not None and obstacle_fn is not None:
        obs_t = obstacle_fn(trajectory.shape[0])              # (T, M, 2)
        d = torch.linalg.norm(
            trajectory[:, :, None, :] - obs_t[:, None, :, :], dim=-1)
        obstacle_clearance = (torch.amin(d) - th.obstacle_floor).to(dt_)
    else:
        obstacle_clearance = inf
    longest = _longest_true_run(outs.infeasible_count > 0)
    lim = float(th.infeasible_streak_limit)
    sustained = ((lim - longest.to(dt_)) / lim).to(dt_)
    if th.goal_radius is None:
        goal = inf
    else:
        c = torch.mean(final_positions, dim=0)
        d_c = torch.linalg.norm(final_positions - c[None], dim=1)
        goal = (th.goal_radius + th.goal_slack - torch.amax(d_c)).to(dt_)
    rm = outs.rta_mode
    if isinstance(rm, tuple):
        rta_soundness = inf
    else:
        rta_floor = (th.separation_floor if th.rta_floor is None
                     else th.rta_floor)
        rta_soundness = (torch.amin(torch.where(
            rm > 0, outs.min_pairwise_distance, inf)) - rta_floor).to(dt_)
    return Margins(separation=separation, boundary=boundary,
                   obstacle_clearance=obstacle_clearance,
                   sustained_infeasibility=sustained, goal_reach=goal,
                   rta_soundness=rta_soundness)


def stack_margins(m: Margins):
    """(P,) tensor of margins in :data:`PROPERTY_NAMES` order."""
    return torch.stack([torch.as_tensor(v) for v in m])


def worst_property(margins_vec) -> tuple:
    """(worst_margin, property_index) of a (P,) margin vector."""
    i = torch.argmin(margins_vec)
    return margins_vec[i], i


# ------------------------------------------------------------- NumPy twin

def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def margin_series_np(th: PropertyThresholds, outs, *, trajectory=None,
                     obstacle_fn_np: Callable | None = None,
                     prop: str = "separation") -> np.ndarray | None:
    """Per-step margin series of a property (NumPy), or None where the
    property has no per-step form. The rollout's margin is its minimum;
    the shrinker's earliest violating step is its first negative."""
    if prop == "separation":
        return (_np(outs.min_pairwise_distance).astype(np.float64)
                - th.separation_floor)
    if prop == "boundary":
        if trajectory is None or th.boundary_half is None:
            return None
        traj = _np(trajectory).astype(np.float64)
        return th.boundary_half - np.abs(traj).max(axis=(1, 2))
    if prop == "obstacle_clearance":
        if trajectory is None or obstacle_fn_np is None:
            return None
        traj = _np(trajectory).astype(np.float64)
        out = np.empty(traj.shape[0])
        for t in range(traj.shape[0]):
            opos = np.asarray(obstacle_fn_np(t), np.float64)
            d = np.linalg.norm(traj[t][:, None] - opos[None], axis=-1)
            out[t] = d.min() - th.obstacle_floor
        return out
    if prop == "sustained_infeasibility":
        flags = _np(outs.infeasible_count) > 0
        run, runs = 0, np.empty(len(flags))
        for t, f in enumerate(flags):
            run = (run + 1) if f else 0
            runs[t] = run
        lim = float(th.infeasible_streak_limit)
        return (lim - runs) / lim
    if prop == "rta_soundness":
        rm = outs.rta_mode
        if isinstance(rm, tuple):
            return None
        floor = (th.separation_floor if th.rta_floor is None
                 else th.rta_floor)
        mpd = _np(outs.min_pairwise_distance).astype(np.float64)
        return np.where(_np(rm) > 0, mpd - floor, np.inf)
    if prop == "goal_reach":
        return None
    raise KeyError(prop)


def rollout_margins_np(th: PropertyThresholds, outs, final_positions, *,
                       trajectory=None,
                       obstacle_fn_np: Callable | None = None) -> dict:
    """Host float64 recomputation of :func:`rollout_margins` — the
    independent parity oracle. Returns property name -> float margin."""
    out = {}
    for prop in ("separation", "boundary", "obstacle_clearance",
                 "sustained_infeasibility", "rta_soundness"):
        series = margin_series_np(th, outs, trajectory=trajectory,
                                  obstacle_fn_np=obstacle_fn_np, prop=prop)
        if series is not None:
            out[prop] = float(series.min())
    if "rta_soundness" not in out:
        out["rta_soundness"] = np.inf
    fp = _np(final_positions).astype(np.float64)
    if "boundary" not in out:
        out["boundary"] = (float(th.boundary_half - np.abs(fp).max())
                           if th.boundary_half is not None else np.inf)
    if "obstacle_clearance" not in out:
        out["obstacle_clearance"] = np.inf
    if th.goal_radius is None:
        out["goal_reach"] = np.inf
    else:
        c = fp.mean(axis=0)
        d_c = np.linalg.norm(fp - c[None], axis=1)
        out["goal_reach"] = float(th.goal_radius + th.goal_slack
                                  - d_c.max())
    return {name: out[name] for name in PROPERTY_NAMES}
