"""Event-driven network scenario engine (deadline rounds + trace replay).

Three layers:

* ``worlds``  — registry of named stochastic network worlds
  (``scenario:<name>`` in ``FFTConfig.failure_mode``).
* ``engine``  — discrete-event wall-clock simulator turning link capacities
  into upload durations; a server deadline decides participation.
* ``trace``   — NDJSON record/replay of realized rounds, bit-exact.
"""
from repro_torch.fl.scenarios.engine import (ArrayRoundEvents, CAUSE_DEADLINE,
                                             CAUSE_LINK_DOWN, CAUSE_OK,
                                             ClientRoundEvent, DeadlineSimulator,
                                             ENGINES, LinkArrays, LinkState,
                                             RoundEvents, ScenarioFailureModel)
from repro_torch.fl.scenarios.trace import (ReplayFailureModel, TraceRecorder,
                                            load_trace)
from repro_torch.fl.scenarios.worlds import (SCENARIOS, Scenario,
                                             available_scenarios, make_scenario,
                                             register)

__all__ = [
    "ArrayRoundEvents", "CAUSE_DEADLINE", "CAUSE_LINK_DOWN", "CAUSE_OK",
    "ClientRoundEvent", "DeadlineSimulator", "ENGINES", "LinkArrays",
    "LinkState", "RoundEvents", "ScenarioFailureModel",
    "ReplayFailureModel", "TraceRecorder", "load_trace",
    "SCENARIOS", "Scenario", "available_scenarios", "make_scenario",
    "register", "make_scenario_model",
    "PopulationRoundStats", "simulate_population",
]


def make_scenario_model(name: str, n_clients: int, *, model_bytes: float,
                        deadline_s: float, compute_s: float = 2.0,
                        seed: int = 0, channels=None,
                        engine: str = "vectorized",
                        **scenario_kwargs) -> ScenarioFailureModel:
    """Scenario world + deadline simulator, wired as a ``FailureModel``.

    ``channels`` forwards the runner's physical channel list (including any
    ResourceOpt intervention) to worlds grounded in the path-loss model;
    ``engine`` picks the timing engine (``"vectorized"`` closed-form batch,
    ``"heap"`` reference event loop — bit-identical, see ``ENGINES``)."""
    scenario = make_scenario(name, n_clients, seed=seed, channels=channels,
                             **scenario_kwargs)
    sim = DeadlineSimulator(n_clients, model_bytes=model_bytes,
                            deadline_s=deadline_s, compute_s=compute_s,
                            seed=seed + 1, engine=engine)
    return ScenarioFailureModel(scenario, sim)


# imported last: population builds on make_scenario_model above
from repro_torch.fl.scenarios.population import (PopulationRoundStats,  # noqa: E402
                                                 simulate_population)
