"""Algorithm 1 on the flat plane: rules, strategies, the round, the engine."""
from repro_torch.core.comm import (CommStrategy, register, strategy_for,
                                   strategy_kinds)
from repro_torch.core.engine import (CADAEngine, CohortEngineState,
                                     EngineState, cohorts_to_participation,
                                     make_cohort_sampler, make_sampler,
                                     sample_cohorts)
from repro_torch.core.local_update import LocalState, LocalUpdateEngine
from repro_torch.core.rules import RULES, CommRule

__all__ = [
    "CADAEngine", "EngineState", "make_sampler",
    "CohortEngineState", "sample_cohorts", "cohorts_to_participation",
    "make_cohort_sampler",
    "LocalState", "LocalUpdateEngine",
    "CommRule", "RULES",
    "CommStrategy", "register", "strategy_for", "strategy_kinds",
]
