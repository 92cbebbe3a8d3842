"""The share of the window outside the benchmark's train_fn spans (each
ends with the device synchronised): pulls, anchors, submits and folds."""


def read(ctx):
    inside = sum(min(t1, ctx.rec.t_close) - max(t0, ctx.rec.t0)
                 for t0, t1 in ctx.rec.window_train_spans())
    return 100.0 * (1.0 - inside / ctx.seconds)
