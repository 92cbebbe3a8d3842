"""The LSTM sequence kernels' share of their roofline: the least time the
scans of the SGD steps in the traced window could take (each launch's
larger of operations over the float32 peak and bytes over the memory's
rate; each input read once, each output written once) over the device
time of ``lstm_seq_fwd_kernel`` and ``lstm_seq_bwd_kernel``.  A step of
batch b runs a forward and a reverse scan over the history (T 672, I 10)
and over the forecast (T 96, I 9)."""

from fedbench.peaks import bound_s

KERNELS = ("lstm_seq_fwd_kernel", "lstm_seq_bwd_kernel")


def seq_bounds(t: int, b: int, i: int, h: int) -> tuple[float, float]:
    """(forward, reverse scan) least seconds of one launch."""
    fwd_bytes = 4 * (t * b * i + 2 * b * h + (i + h) * 4 * h + 4 * h
                     + 2 * t * b * h + t * b * 4 * h + 2 * b * h)
    fwd_flops = 2 * t * b * (i + h) * 4 * h
    bwd_bytes = 4 * (t * b * h + 2 * b * h + t * b * 4 * h + t * b * h
                     + b * h + h * 4 * h + t * b * 4 * h + 2 * b * h)
    bwd_flops = 2 * t * b * 4 * h * h
    return bound_s(fwd_bytes, fwd_flops), bound_s(bwd_bytes, bwd_flops)


def step_bound_s(m: dict, b: int) -> float:
    h = m["hidden_size"]
    return (sum(seq_bounds(m["history_steps"], b, m["history_channels"], h))
            + sum(seq_bounds(m["horizon_steps"], b, m["forecast_channels"],
                             h)))


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    busy, n = tr.op_seconds(lambda name: any(k in name for k in KERNELS))
    steps = [b for t, b in ctx.rec.steps if tr.t0 <= t <= tr.t1]
    if not n or not steps:
        return None
    m = ctx.config["model"]
    return 100.0 * sum(step_bound_s(m, b) for b in steps) / busy
