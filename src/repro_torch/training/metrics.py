"""Paper §IV.B metrics.

Power Error  = |predicted - actual| / kWp * 100            (per 15-min step)
Energy Error = |E_pred - E_actual| / (kWp * 12 h) * 100     (per day)

Inputs are *normalized* (production / kWp), so kWp cancels: power error is
|p - a| * 100 and daily energy is sum(y) * 0.25 kWp-hours.
Daytime window: 06:00-21:00 (minutes 360..1260).
"""

from __future__ import annotations

import numpy as np

DAY_START_MIN = 6 * 60
DAY_END_MIN = 21 * 60
THEORETICAL_MAX_HOURS = 12.0
HOURS_PER_STEP = 0.25


def power_error(pred: np.ndarray, actual: np.ndarray) -> np.ndarray:
    """(n, 96) -> per-step percentage errors (n, 96)."""
    return np.abs(pred - actual) * 100.0


def energy_error(pred: np.ndarray, actual: np.ndarray) -> np.ndarray:
    """(n, 96) -> per-day percentage errors (n,)."""
    e_pred = pred.sum(-1) * HOURS_PER_STEP
    e_act = actual.sum(-1) * HOURS_PER_STEP
    return np.abs(e_pred - e_act) / THEORETICAL_MAX_HOURS * 100.0


def daytime_mask(minute: np.ndarray) -> np.ndarray:
    return (minute >= DAY_START_MIN) & (minute < DAY_END_MIN)


def summarize_errors(pred: np.ndarray, actual: np.ndarray,
                     minute: np.ndarray) -> dict:
    """The six Table-II statistics for one model on one site's test days."""
    pe = power_error(pred, actual)
    ee = energy_error(pred, actual)
    dmask = daytime_mask(minute)
    day_pe = pe[dmask]
    day_pred = np.where(dmask, pred, 0.0)
    day_act = np.where(dmask, actual, 0.0)
    day_ee = energy_error(day_pred, day_act)
    return {
        "mean_error_power": float(pe.mean()),
        "max_error_power": float(pe.max()),
        "mean_error_energy": float(ee.mean()),
        "mean_error_day_power": float(day_pe.mean()) if day_pe.size else 0.0,
        "mean_error_day_energy": float(day_ee.mean()),
    }


def aggregate_runs(per_run: list[dict]) -> dict:
    """mean ± std across runs, Table-II style."""
    keys = per_run[0].keys()
    out = {}
    for k in keys:
        vals = np.array([r[k] for r in per_run])
        out[k] = (float(vals.mean()), float(vals.std()))
    return out
