"""Model FLOPs of the forecaster's forward and backward (3x the forward's
products) for the training windows consumed in the window, over the
window's seconds at the float32 peak (the LSTM runs outside the tensor
cores)."""

from fedbench.peaks import F32_FLOP_PER_S


def forward_flops(m: dict) -> float:
    """One window's forward: the encoder's and decoder's gate products a
    step, then the head."""
    h = m["hidden_size"]
    gates = 2 * 4 * h * ((m["history_channels"] + h) * m["history_steps"]
                         + (m["forecast_channels"] + h) * m["horizon_steps"])
    return gates + 2 * h * m["horizon_steps"]


def read(ctx):
    windows = sum(n for _, n in ctx.rec.window_steps())
    flops = 3 * forward_flops(ctx.config["model"]) * windows
    return 100.0 * flops / (ctx.seconds * F32_FLOP_PER_S)
