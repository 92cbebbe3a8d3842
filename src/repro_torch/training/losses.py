"""Loss of the solar case study."""

from __future__ import annotations

import torch


def solar_loss(forecaster, params, batch: dict):
    """MSE on normalized production (the paper trains MSE, evaluates MAPE)."""
    preds = forecaster.forward(params, batch["history"], batch["forecast"])
    err = preds - batch["target"]
    return torch.mean(torch.square(err)), preds
