"""Scenario platform (counterpart: cbf_tpu/scenarios/platform/): the
registry (:mod:`.registry`), the one place the rest of the stack learns
what a scenario is, and the composable generator DSL (:mod:`.dsl`),
which generates seeded deterministic ``swarm.Config``-producing specs
from composable ingredients (spawn distribution x goal structure x
obstacle field x dynamics family, mixed single+double swarms included)
and enrolls them through the registry."""

from cbf_tpu_torch.scenarios.platform.dsl import (  # noqa: F401
    ScenarioSpec, enroll, generate, run_config, run_spec)
from cbf_tpu_torch.scenarios.platform.registry import (  # noqa: F401
    ScenarioEntry, builtin_entries, entries, get, names, register)
