"""The scenario registry (counterpart: cbf_tpu/scenarios/platform/
registry.py): the one place the verify subsystem learns what a scenario
is — its default config, its adapter key
(:data:`cbf_tpu_torch.verify.search.ADAPTER_FACTORIES`) and the name of
its horizon field. The four builtin entries are the hand-written
scenario modules; the generator DSL (:mod:`.dsl`) registers its seeded
specs through the same :func:`register` door (``generated=True``)."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple


class ScenarioEntry(NamedTuple):
    """One registered scenario: ``make_config()`` gives its default
    config, ``adapter`` keys the verify adapter factory, ``steps_field``
    names the horizon field, ``servable`` marks swarm configs, and
    ``parity_test`` names the JAX package's twin-parity test of it."""
    name: str
    module: str
    make_config: Callable[[], Any]
    adapter: str
    steps_field: str
    servable: bool
    parity_test: str
    generated: bool = False


_REGISTRY: dict[str, ScenarioEntry] = {}


def register(entry: ScenarioEntry, *, replace: bool = False) -> None:
    """Register a scenario; re-registering a name raises unless
    ``replace``."""
    if entry.name in _REGISTRY and not replace:
        raise ValueError(f"scenario {entry.name!r} is already registered")
    _REGISTRY[entry.name] = entry


def get(name: str) -> ScenarioEntry:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {', '.join(names())}")
    return _REGISTRY[name]


def names() -> tuple[str, ...]:
    """Registered scenario names, in registration order."""
    return tuple(_REGISTRY)


def entries() -> tuple[ScenarioEntry, ...]:
    return tuple(_REGISTRY.values())


def builtin_entries() -> tuple[ScenarioEntry, ...]:
    return tuple(e for e in _REGISTRY.values() if not e.generated)


def _config_of(module: str):
    def make_config():
        import importlib

        return importlib.import_module(
            f"cbf_tpu_torch.scenarios.{module}").Config()
    return make_config


for _name, _steps, _servable, _parity in (
        ("swarm", "steps", True, "test_margin_parity_vs_numpy"),
        ("meet_at_center", "iterations", False,
         "test_meet_at_center_trace_oracle_parity"),
        ("cross_and_rescue", "iterations", False,
         "test_cross_and_rescue_full_horizon_oracle_parity"),
        ("antipodal", "steps", False, "test_antipodal_margins_numpy_parity")):
    register(ScenarioEntry(
        name=_name, module=f"cbf_tpu_torch.scenarios.{_name}",
        make_config=_config_of(_name), adapter=_name, steps_field=_steps,
        servable=_servable, parity_test=_parity))
