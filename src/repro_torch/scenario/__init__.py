"""Trace-driven scenario harness of the port (the reference's
``repro.scenario``, docs/SCENARIOS.md).

Deterministic trace generators (``repro_torch.scenario.traces``) compose
into named scenarios (``repro_torch.scenario.presets``) that a vectorized
replay engine (``repro_torch.scenario.engine``) drives against any store
topology, producing per-scenario SLO verdicts
(``repro_torch.scenario.slo``).  The population and every random draw are
the reference's numpy; the models, folds and EWC steps are tensors on the
store's device (``device=None``: CUDA)::

    from repro_torch.scenario import diurnal_churn, run_scenario

    report = run_scenario(diurnal_churn(100_000, 24), topology="sharded",
                          device="cuda")
    report.assert_slo(lost_updates=0, staleness_p95=48,
                      effective_round_regressions=0)
"""

from repro_torch.scenario.engine import (
    Scenario,
    ScenarioConfig,
    TOPOLOGIES,
    make_store,
    run_scenario,
)
from repro_torch.scenario.presets import (
    PRESETS,
    diurnal_churn,
    drift_ewc,
    flash_crowd_burst,
    regional_outage,
)
from repro_torch.scenario.slo import ScenarioReport, compute_slos
from repro_torch.scenario.traces import (
    TraceEvent,
    by_tick,
    churn,
    compose,
    diurnal,
    flash_crowd,
    region_outage,
    replay_population,
    seasonal_drift,
    stragglers,
)

__all__ = [
    "PRESETS",
    "Scenario",
    "ScenarioConfig",
    "ScenarioReport",
    "TOPOLOGIES",
    "TraceEvent",
    "by_tick",
    "churn",
    "compose",
    "compute_slos",
    "diurnal",
    "diurnal_churn",
    "drift_ewc",
    "flash_crowd",
    "flash_crowd_burst",
    "make_store",
    "region_outage",
    "regional_outage",
    "replay_population",
    "run_scenario",
    "seasonal_drift",
    "stragglers",
]
