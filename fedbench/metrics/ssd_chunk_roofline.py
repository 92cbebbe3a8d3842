"""The SSD chunk kernels' share of their roofline: the least time of the
forward (``ssd_chunk_tf32_kernel``) and backward (``ssd_chunk_bwd_kernel``
with its fold) launches of the steps in the traced window, one of each a
layer a step, over their device time.  Operations and bytes as the port's
kernel table counts them: each input read once, each output written
once; C B^T once a group, the other products once a head over the i >= j
half of a chunk; at the float32 peak (the kernels' exact three-way tf32
split is bound by its CUDA-core work)."""

from fedbench.peaks import bound_s

KERNELS = ("ssd_chunk_tf32_kernel", "ssd_chunk_bwd_kernel",
           "ssd_chunk_bwd_fold_kernel")


def ssd_bounds(b, c, l, h, p, g, n) -> tuple[float, float]:
    """(forward, backward) least seconds of one launch over b rows of c
    chunks of length l, h heads of width p, g groups of state n."""
    xdt, dA, bc = b * c * l * h * p, b * c * l * h, b * c * l * g * n
    states = b * c * h * n * p
    tri = l * (l + 1) // 2
    fwd_bytes = 4 * (xdt + dA + 2 * bc + xdt + states)
    fwd_flops = b * c * (g * 2 * tri * n
                         + h * (tri + 2 * tri * p + l * p + 2 * l * n * p))
    bwd_bytes = 4 * 2 * (xdt + dA + 2 * bc) + 4 * (xdt + states)
    bwd_flops = b * c * (g * 2 * tri * n + h * (
        2 * tri * p + 2 * tri * p + 2 * tri * n + 2 * tri * n
        + 2 * 2 * l * n * p + 4 * tri))
    return bound_s(fwd_bytes, fwd_flops), bound_s(bwd_bytes, bwd_flops)


def step_bound_s(m: dict, rows: int, seq: int) -> float:
    l = m["chunk_size"]
    h = m["expand"] * m["d_model"] // m["head_dim"]
    fwd, bwd = ssd_bounds(rows, -(-seq // l), l, h, m["head_dim"],
                          m["n_groups"], m["d_state"])
    return m["n_layers"] * (fwd + bwd)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    busy, n = tr.op_seconds(lambda name: any(k in name for k in KERNELS))
    steps = [t for t, _ in ctx.rec.steps if tr.t0 <= t <= tr.t1]
    if not n or not steps:
        return None
    up = ctx.work["update"]
    bound = step_bound_s(ctx.config["model"], up["batch"], up["seq"])
    return 100.0 * bound * len(steps) / busy
