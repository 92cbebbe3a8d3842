"""6 N D: six times the parameter count for every token of the client steps
finished in the window, over the window's seconds at the bf16 peak."""

from fedbench.peaks import BF16_FLOP_PER_S


def n_params(m: dict) -> int:
    """A Mamba-2 model's parameters: embedding (tied head), per layer the
    block's norm and the mixer's projections, convolution, A, dt bias,
    D and gated norm, and the final norm."""
    d, di = m["d_model"], m["expand"] * m["d_model"]
    nh = di // m["head_dim"]
    gn = m["n_groups"] * m["d_state"]
    conv = di + 2 * gn
    layer = (d + d * (2 * di + 2 * gn + nh) + m["conv_width"] * conv + conv
             + 3 * nh + di + di * d)
    head = 0 if m["tie_embeddings"] else d * m["vocab_size"]
    return m["vocab_size"] * d + m["n_layers"] * layer + d + head


def read(ctx):
    tokens = sum(n for _, n in ctx.rec.window_steps())
    flops = 6.0 * n_params(ctx.config["model"]) * tokens
    return 100.0 * flops / (ctx.seconds * BF16_FLOP_PER_S)
