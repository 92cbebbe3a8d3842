"""Windowing: 7-day history + next-day forecast -> 96 prediction targets

(paper §III.A).  Produces aligned (history, forecast, target, meta) arrays
for training and evaluation.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.solar_lstm import (
    HISTORY_STEPS,
    HORIZON_STEPS,
    STEPS_PER_DAY,
)


def make_windows(site_data: dict, stride: int = STEPS_PER_DAY,
                 history_steps: int = HISTORY_STEPS,
                 horizon_steps: int = HORIZON_STEPS) -> dict:
    """Returns dict of arrays:
      history:  (n, history_steps, F+1)  — features + past production
      forecast: (n, horizon_steps, F)    — weather forecast for target day
      target:   (n, horizon_steps)       — normalized production
      minute:   (n, horizon_steps)       — minute-of-day (daytime filtering)
    """
    X = site_data["features"]
    y = site_data["production_norm"]
    minute = site_data["minute"]
    T = len(y)
    starts = np.arange(0, T - history_steps - horizon_steps + 1, stride)
    hist, fore, targ, mins = [], [], [], []
    for s in starts:
        h_end = s + history_steps
        f_end = h_end + horizon_steps
        hist.append(np.concatenate([X[s:h_end], y[s:h_end, None]], axis=1))
        fore.append(X[h_end:f_end])
        targ.append(y[h_end:f_end])
        mins.append(minute[h_end:f_end])
    return {
        "history": np.stack(hist).astype(np.float32),
        "forecast": np.stack(fore).astype(np.float32),
        "target": np.stack(targ).astype(np.float32),
        "minute": np.stack(mins).astype(np.int32),
    }


def split_windows(windows: dict, train_frac: float = 0.8, seed: int = 0,
                  shuffle: bool = False) -> tuple[dict, dict]:
    """80-20 train/test split (paper §IV.A).  Default is chronological
    (realistic for forecasting); shuffle=True gives the iid variant."""
    n = len(windows["target"])
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    cut = int(n * train_frac)
    tr = {k: v[idx[:cut]] for k, v in windows.items()}
    te = {k: v[idx[cut:]] for k, v in windows.items()}
    return tr, te


def batch_iter(windows: dict, batch_size: int, rng: np.random.Generator):
    n = len(windows["target"])
    order = rng.permutation(n)
    for i in range(0, n, batch_size):
        sel = order[i:i + batch_size]
        yield {k: v[sel] for k, v in windows.items()}
