"""Per-scenario SLO verdicts from store stats + telemetry windows.

The replay engine hands this module the three things a scenario run
produces — the engine's own tallies (submits, fetches, monotonicity
violations), the store's ``agg_stats()`` after the final drain, and the
scenario-scoped metric window (``repro_torch.obs.metrics.MetricsWindow`` diff
over the merged multi-site telemetry dump) — and gets back a flat
``{verdict_name: value}`` dict plus :class:`ScenarioReport`, the
pytest-facing result object.

SLO taxonomy (docs/SCENARIOS.md):

* **integrity** — ``lost_updates`` (submitted vs folded after the final
  drain; must be 0 in every topology, including mid-scenario worker
  kills), ``effective_round_regressions`` (the staleness reference may
  never move backwards under a reader).
* **staleness** — percentiles of the ``staleness_at_fold`` histogram in
  rounds (how far behind the server a folded update's base round was).
* **latency** — submit/drain/fetch nanosecond histograms, as p50/p95.
  ``drain_p95_ns`` merges every fold route a site may record: the
  reference's ``host`` and ``pallas`` and the port's ``cuda``, so a torch
  parent reads a JAX worker's folds and a torch CUDA worker's alike.  On a
  card a fold is asynchronous, so its span is the host time of the call.
* **pressure** — ``queue_depth_max``, ``coalesce_factor``.
* **privacy** — ``epsilon`` spent by the heaviest-hit client under the
  scenario's participation pattern (None when DP accounting is off).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.obs.metrics import merge_hist_dumps, percentile_from_buckets


def _hist(metrics: dict, name: str) -> dict | None:
    h = metrics.get("histograms", {}).get(name)
    return h if h and h.get("count") else None


def compute_slos(*, submitted: int, stats: dict, metrics: dict,
                 round_regressions: int, epsilon: float | None) -> dict:
    """Flatten one scenario run into the verdict dict (see module
    docstring for the taxonomy)."""
    slo: dict = {
        "lost_updates": submitted - int(stats.get("updates", 0)),
        "effective_round_regressions": int(round_regressions),
        "queue_depth_max": int(stats.get("max_queue_depth", 0)),
        "coalesce_factor": float(stats.get("coalesce_factor", 0.0)),
        "drain_timeouts": int(stats.get("drain_timeouts", 0)),
        "epsilon": epsilon,
    }
    stale = _hist(metrics, "staleness_at_fold")
    if stale is not None:
        slo["staleness_p50"] = percentile_from_buckets(stale, 0.50)
        slo["staleness_p95"] = percentile_from_buckets(stale, 0.95)
        slo["staleness_max"] = float(stale["max"])
    for name, out in (("submit_latency_ns", "submit"),
                      ("fetch_latency_ns", "fetch")):
        h = _hist(metrics, name)
        if h is not None:
            slo[f"{out}_p95_ns"] = percentile_from_buckets(h, 0.95)
    drain = None
    for route in ("host", "pallas", "cuda"):
        h = _hist(metrics, f"drain_fold_ns_{route}")
        if h is not None:
            drain = h if drain is None else merge_hist_dumps(drain, h)
    if drain is not None:
        slo["drain_p95_ns"] = percentile_from_buckets(drain, 0.95)
    return slo


@dataclass
class ScenarioReport:
    """Everything a scenario run measured.  ``slo`` is the flat verdict
    dict (:func:`compute_slos`); ``stats`` the store's final
    ``agg_stats()``; ``metrics`` the scenario-scoped telemetry window."""

    name: str
    topology: str
    n_clients: int
    n_ticks: int
    submitted: int
    fetched: int
    population_peak: int
    wall_s: float
    stats: dict
    metrics: dict
    slo: dict
    ewc: dict | None = None
    ticks: list = field(default_factory=list, repr=False)

    def assert_slo(self, **bounds) -> "ScenarioReport":
        """Assert upper bounds on verdict values: ``assert_slo(
        lost_updates=0, staleness_p95=32)`` fails if any named verdict is
        missing or exceeds its bound.  All violations are reported in one
        AssertionError, so a red CI run shows the full picture."""
        failures = []
        for name, bound in bounds.items():
            value = self.slo.get(name)
            if value is None:
                failures.append(f"{name}: not measured "
                                f"(have: {sorted(self.slo)})")
            elif value > bound:
                failures.append(f"{name}: {value} > bound {bound}")
        if failures:
            raise AssertionError(
                f"scenario {self.name!r} ({self.topology}, "
                f"{self.n_clients} clients) violated SLOs:\n  "
                + "\n  ".join(failures))
        return self

    def summary(self) -> dict:
        """JSON-ready flat summary (one row of a scenario table)."""
        out = {"name": self.name, "topology": self.topology,
               "n_clients": self.n_clients, "n_ticks": self.n_ticks,
               "submitted": self.submitted, "fetched": self.fetched,
               "population_peak": self.population_peak,
               "wall_s": self.wall_s,
               "submits_per_s": self.submitted / max(self.wall_s, 1e-9)}
        out.update({f"slo_{k}": v for k, v in self.slo.items()
                    if v is not None})
        return out
