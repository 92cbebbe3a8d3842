"""Case-study forecaster (paper §III): LSTM encoder over 7-day history +

forecast-conditioned LSTM decoder emitting 96 quarter-hour power predictions.
Each scan takes its route from its shape alone
(``kernels.lstm_cell.ops.seq_fits``): where the whole-sequence kernels
have a launch shape it is one
``kernels.lstm_cell.LSTMSeqFn`` (on CUDA tensors one launch of the sequence
kernel forward and one of its reverse scan backward), elsewhere a chain of
``LSTMCellFn`` steps (one step kernel launch a step, its backward in
PyTorch ops); on CPU tensors both routes run their plain versions.
Parameters are a plain dict with the JAX package's keys; ``forward`` takes
that dict.
"""

from __future__ import annotations

import torch

from repro_torch.configs.solar_lstm import CONFIG, SolarLSTMConfig
from repro_torch.kernels.lstm_cell.ops import LSTMCellFn, LSTMSeqFn, seq_fits
from repro_torch.sharding.logical import ParamSpec, init_from_schema
from repro_torch.utils.device import resolve_device


def lstm_cell_schema(in_dim: int, hidden: int) -> dict:
    # single fused weight for [i, f, g, o] gates
    return {
        "wx": ParamSpec((in_dim, 4 * hidden), ("embed", "mlp")),
        "wh": ParamSpec((hidden, 4 * hidden), ("embed", "mlp")),
        "b": ParamSpec((4 * hidden,), ("mlp",), init="zeros"),
    }


def lstm_scan(p, xs, h0, c0):
    """xs: (b, t, in) -> outputs (b, t, hidden), (hT, cT)."""
    xt = xs.transpose(0, 1).contiguous()                          # (t, b, in)
    if seq_fits(h0.shape[1], xs.shape[2]) is not None:
        ys, h, c = LSTMSeqFn.apply(xt, h0, c0, p["wx"], p["wh"], p["b"])
        return ys.transpose(0, 1), (h, c)
    h, c, ys = h0, c0, []
    for x in xt:
        h, c = LSTMCellFn.apply(x, h, c, p["wx"], p["wh"], p["b"])
        ys.append(h)
    ys = torch.stack(ys, dim=1) if ys else xs.new_zeros(
        (xs.shape[0], 0, h0.shape[1]))
    return ys, (h, c)


class SolarForecaster:
    def __init__(self, cfg: SolarLSTMConfig):
        self.cfg = cfg

    def schema(self) -> dict:
        c = self.cfg
        return {
            "encoder": lstm_cell_schema(c.history_channels, c.hidden_size),
            "decoder": lstm_cell_schema(c.forecast_channels, c.hidden_size),
            "head_w": ParamSpec((c.hidden_size, 1), ("embed", "state")),
            "head_b": ParamSpec((1,), ("state",), init="zeros"),
        }

    def init(self, generator: torch.Generator, device=None) -> dict:
        return init_from_schema(self.schema(), generator,
                                resolve_device(device))

    def forward(self, params, history, forecast):
        """history: (b, 672, hist_ch); forecast: (b, 96, fc_ch) -> (b, 96)."""
        b = history.shape[0]
        hsz = self.cfg.hidden_size
        h0 = torch.zeros((b, hsz), dtype=history.dtype, device=history.device)
        c0 = torch.zeros_like(h0)
        _, (h, c) = lstm_scan(params["encoder"], history, h0, c0)
        ys, _ = lstm_scan(params["decoder"], forecast, h, c)
        preds = ys @ params["head_w"] + params["head_b"]        # (b, 96, 1)
        # -2.5 offset: sigmoid starts near typical normalized production
        # (~0.08) instead of 0.5, so early training isn't spent unlearning
        # a large constant bias.
        return torch.sigmoid(preds[..., 0] - 2.5)               # normalized to kWp


def build_forecaster(cfg: SolarLSTMConfig | None = None) -> SolarForecaster:
    return SolarForecaster(cfg or CONFIG)
