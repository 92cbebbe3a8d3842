"""Named scenarios, the reference's (``repro.scenario.presets``) with the
same seeds and knobs: the composed traces the tests and ``chip_smoke.py``
replay.  Each preset function returns a
:class:`repro_torch.scenario.engine.Scenario`; every stochastic choice derives
from the function's ``seed``, so a preset is one deterministic workload."""

from __future__ import annotations

from repro_torch.scenario.engine import Scenario, ScenarioConfig
from repro_torch.scenario.traces import (
    churn,
    compose,
    diurnal,
    flash_crowd,
    region_outage,
    seasonal_drift,
    stragglers,
)


def diurnal_churn(n_clients: int = 100_000, n_ticks: int = 24, *,
                  n_clusters: int = 16, n_regions: int = 4,
                  participation: float = 0.01, seed: int = 0,
                  **cfg_kw) -> Scenario:
    """The acceptance workload: a day of solar-diurnal availability over
    ``n_regions`` longitudes with background churn and a straggler cohort.
    At the default 10^5 clients the server sees tens of thousands of
    submits riding batched queues — the population itself stays flat
    numpy."""
    cfg = ScenarioConfig(name="diurnal_churn", n_clients=n_clients,
                         n_ticks=n_ticks, n_clusters=n_clusters,
                         n_regions=n_regions, participation=participation,
                         seed=seed, **cfg_kw)
    events = compose(
        diurnal(n_ticks, n_regions=n_regions, seed=seed + 1),
        churn(n_clients, n_ticks, leave_prob=0.02, return_prob=0.3,
              seed=seed + 2),
        stragglers(n_clients, frac=0.05, fetch_every=6, seed=seed + 3),
    )
    return Scenario(cfg, events)


def flash_crowd_burst(n_clients: int = 20_000, n_ticks: int = 12, *,
                      n_clusters: int = 8, seed: int = 0,
                      **cfg_kw) -> Scenario:
    """Steady availability, then a submit spike mid-run (tariff push):
    queue-pressure drains and the coalesce path absorb the burst."""
    cfg = ScenarioConfig(name="flash_crowd", n_clients=n_clients,
                         n_ticks=n_ticks, n_clusters=n_clusters, seed=seed,
                         participation=0.02, **cfg_kw)
    events = compose(
        churn(n_clients, n_ticks, leave_prob=0.005, return_prob=0.5,
              seed=seed + 1),
        flash_crowd(n_ticks // 2, factor=8.0, width=2),
    )
    return Scenario(cfg, events)


def regional_outage(n_clients: int = 20_000, n_ticks: int = 16, *,
                    n_clusters: int = 8, n_regions: int = 4,
                    region: int = 1, seed: int = 0,
                    **cfg_kw) -> Scenario:
    """One region dark for a third of the run, then a recovery burst of
    deferred submits — the storm the chaos tests overlay migrations and
    worker kills onto."""
    cfg = ScenarioConfig(name="region_outage", n_clients=n_clients,
                         n_ticks=n_ticks, n_clusters=n_clusters,
                         n_regions=n_regions, participation=0.03,
                         seed=seed, **cfg_kw)
    events = compose(
        diurnal(n_ticks, n_regions=n_regions, base=0.3, peak=0.9,
                seed=seed + 1),
        churn(n_clients, n_ticks, leave_prob=0.01, return_prob=0.4,
              seed=seed + 2),
        region_outage(region, n_ticks // 4, n_ticks // 2),
    )
    return Scenario(cfg, events)


def drift_ewc(n_clients: int = 5_000, n_ticks: int = 32, *,
              period: int = 32, ewc_lambda: float = 0.0, seed: int = 0,
              **cfg_kw) -> Scenario:
    """Seasonal concept drift with a task boundary at the half period:
    cluster targets swing with the season, and ``ewc_lambda > 0`` anchors
    post-boundary training through the fused EWC kernel
    (``repro_torch.core.continual.ewc_adjusted_gradient``, the
    ``ewc_update`` kernel on a card).  Run it at
    ``ewc_lambda=0`` for the forgetting baseline."""
    cfg = ScenarioConfig(name="drift_ewc", n_clients=n_clients,
                         n_ticks=n_ticks, n_clusters=4,
                         participation=0.05, ewc_lambda=ewc_lambda,
                         seed=seed, **cfg_kw)
    events = compose(
        churn(n_clients, n_ticks, leave_prob=0.005, return_prob=0.5,
              seed=seed + 1),
        seasonal_drift(n_ticks, period=period, magnitude=1.0),
    )
    return Scenario(cfg, events)


PRESETS = {
    "diurnal_churn": diurnal_churn,
    "flash_crowd": flash_crowd_burst,
    "region_outage": regional_outage,
    "drift_ewc": drift_ewc,
}
