"""Training windows of site data consumed by client SGD steps that
returned inside the window, over the window's seconds."""


def read(ctx):
    return sum(n for _, n in ctx.rec.window_steps()) / ctx.seconds
