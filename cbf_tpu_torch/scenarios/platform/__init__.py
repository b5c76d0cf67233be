"""Scenario platform (counterpart: cbf_tpu/scenarios/platform/): the
registry of the four hand-written scenarios. The seeded generator DSL
(``dsl.py``) is the serving slice's (ROADMAP.md item 11): its entry
points raise."""

from cbf_tpu_torch.errors import SLICE_SERVE, OutOfSliceError
from cbf_tpu_torch.scenarios.platform.registry import (  # noqa: F401
    ScenarioEntry, builtin_entries, entries, get, names, register)


def generate(*args, **kwargs):
    """The seeded procedural generator: not ported yet."""
    raise OutOfSliceError("the scenario generator DSL (generate)",
                          SLICE_SERVE)


def enroll(*args, **kwargs):
    """Registering generated scenarios: not ported yet."""
    raise OutOfSliceError("the scenario generator DSL (enroll)", SLICE_SERVE)
