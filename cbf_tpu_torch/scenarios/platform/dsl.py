"""The composable scenario-generator DSL (counterpart:
cbf_tpu/scenarios/platform/dsl.py).

A :class:`ScenarioSpec` is a tiny frozen value — ingredient choices
(spawn distribution, goal structure, obstacle field, dynamics family)
plus size/horizon/seed — that lowers to a plain ``swarm.Config`` via
:meth:`ScenarioSpec.to_config`. Because the lowering target is
``swarm.Config``, every generated scenario rides the whole stack: the
serve engine's bucket signature (the ingredient fields are static Config
fields), the verify subsystem's swarm adapter, the RTA ladder and the
telemetry channels.

:func:`generate` is the seeded procedural generator: one
``np.random.default_rng(seed)`` stream drives every choice in the JAX
package's order, so the same seed gives the same spec list — field for
field the JAX package's — on any host. The sampled ranges are
conservative (spawn spacings >= 0.4, small-to-mid n) so every generated
scenario passes the default filter's falsification round: the platform
generates traffic and attack surface, not counterexamples.

:func:`run_config` and :func:`run_spec` run on ``device`` (None = the
card; without one they raise — pass ``device="cpu"`` for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: The event types this module emits (``obs.schema.SCENARIO_EVENT_TYPES``).
EMITTED_EVENT_TYPES: tuple[str, ...] = ("scenario.generated",
                                        "scenario.run")

SPAWNS = ("grid", "ring", "clusters", "corridor")
GOALS = ("rendezvous", "coverage", "corridor", "formation")
OBSTACLE_LAYOUTS = ("orbit", "static", "scatter")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A generated scenario: ingredient choices + size/horizon/seed.

    ``dynamics`` is "single", "double", or "mixed" (``n_double`` double-
    integrator rows in one swarm — the heterogeneous-swarm axis);
    ``n_obstacles == 0`` means no obstacle field (``obstacle_layout`` is
    then forced to the default "orbit": a non-default layout with zero
    obstacles is rejected by ``swarm.validate_config``).
    """
    name: str
    n: int = 24
    steps: int = 200
    spawn: str = "grid"
    goal: str = "rendezvous"
    obstacle_layout: str = "orbit"
    n_obstacles: int = 0
    dynamics: str = "single"
    n_double: int = 0
    rta: bool = False
    seed: int = 0

    def to_config(self):
        """Lower to the runnable ``swarm.Config`` (validated)."""
        from cbf_tpu_torch.scenarios import swarm
        cfg = swarm.Config(
            n=self.n, steps=self.steps, spawn=self.spawn, goal=self.goal,
            obstacle_layout=(self.obstacle_layout if self.n_obstacles
                             else "orbit"),
            n_obstacles=self.n_obstacles, dynamics=self.dynamics,
            n_double=self.n_double, rta=self.rta, seed=self.seed)
        swarm.validate_config(cfg)
        return cfg


def generate(seed: int, count: int = 20, *,
             telemetry=None) -> tuple[ScenarioSpec, ...]:
    """Seeded procedural generation of ``count`` distinct runnable specs.

    Deterministic: one rng stream, choices in a fixed order — same
    ``(seed, count)`` always yields the same tuple. At ``count >= 4`` at
    least one spec is a mixed single+double heterogeneous swarm (spec 3
    is pinned mixed; others may sample it too). Obstacle fields only
    pair with the rendezvous goal — the clearance-repaired spawn plus
    packing-disk obstacle placement is calibrated for the converging
    swarm; fixed goal layouts could park an agent inside an orbit lane
    for the whole horizon.
    """
    if count < 1:
        raise ValueError(f"count must be >= 1, got {count}")
    rng = np.random.default_rng(seed)
    specs: list[ScenarioSpec] = []
    for i in range(count):
        n = int(rng.integers(8, 33))
        steps = int(rng.integers(120, 280))
        spawn = SPAWNS[int(rng.integers(len(SPAWNS)))]
        goal = GOALS[int(rng.integers(len(GOALS)))]
        dyn = ("mixed" if i == 3
               else ("single", "double", "mixed")[int(rng.integers(3))])
        n_double = int(rng.integers(1, n)) if dyn == "mixed" else 0
        n_obstacles = 0
        layout = "orbit"
        if goal == "rendezvous" and dyn == "single" and rng.random() < 0.5:
            n_obstacles = int(rng.integers(1, 4))
            layout = OBSTACLE_LAYOUTS[int(rng.integers(
                len(OBSTACLE_LAYOUTS)))]
        spec = ScenarioSpec(
            name=f"gen{seed}-{i:02d}-{spawn}-{goal}-{dyn}",
            n=n, steps=steps, spawn=spawn, goal=goal,
            obstacle_layout=layout, n_obstacles=n_obstacles,
            dynamics=dyn, n_double=n_double,
            rta=bool(rng.random() < 0.5), seed=int(rng.integers(2**31)))
        spec.to_config()  # validate now — a bad sample must fail loudly
        specs.append(spec)
    if telemetry is not None:
        telemetry.event("scenario.generated", {
            "seed": seed, "count": len(specs),
            "names": [s.name for s in specs]})
    return tuple(specs)


def enroll(specs, *, replace: bool = False) -> None:
    """Register every spec with the scenario registry: each generated
    scenario gets the swarm adapter (falsification), a servable bucket
    signature, and the shared generated-ingredient parity needle."""
    from cbf_tpu_torch.scenarios.platform import registry

    for spec in specs:
        registry.register(registry.ScenarioEntry(
            name=spec.name, module="cbf_tpu_torch.scenarios.swarm",
            make_config=spec.to_config, adapter="swarm",
            steps_field="steps", servable=True,
            parity_test="test_generated_ingredient_parity",
            generated=True), replace=replace)


def run_summary(outs) -> tuple[float, int]:
    """(min pairwise distance, infeasible count) of a run's outputs, read
    in one host copy."""
    both = torch.stack([
        outs.min_pairwise_distance.min().to(torch.float64),
        outs.infeasible_count.sum().to(torch.float64)]).cpu()
    return float(both[0]), int(both[1])


def run_config(name: str, cfg, *, telemetry=None, device=None):
    """Run one scenario-platform config end to end on ``device``. Returns
    ``(final_state, outputs)`` from ``swarm.run``, emitting the
    ``scenario.run`` safety record when a telemetry sink is given — the
    one emit site both :func:`run_spec` and the ``scenario run`` CLI
    share."""
    from cbf_tpu_torch.scenarios import swarm

    state, outs = swarm.run(cfg, device=device)
    if telemetry is not None:
        md, infeasible = run_summary(outs)
        telemetry.event("scenario.run", {
            "scenario": name, "n": cfg.n, "steps": cfg.steps,
            "dynamics": cfg.dynamics, "min_pairwise_distance": md,
            "infeasible_count": infeasible})
    return state, outs


def run_spec(spec: ScenarioSpec, *, telemetry=None, device=None,
             **overrides):
    """Run one generated scenario end to end: ``swarm.run`` on the
    spec's Config (with optional field ``overrides``) through
    :func:`run_config`."""
    cfg = spec.to_config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return run_config(spec.name, cfg, telemetry=telemetry, device=device)
