"""Tokens of client AdamW steps that finished inside the window, over the
window's seconds (pulls, anchors, submits and folds included)."""


def read(ctx):
    return sum(n for _, n in ctx.rec.window_steps()) / ctx.seconds
