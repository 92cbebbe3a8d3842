"""The share of the window's updates' request-to-submit time spent in the
client's train_fn (the benchmark's spans around it): the rest is pulling
the model, waiting and submitting."""


def read(ctx):
    ups = ctx.rec.window_updates()
    total = sum(t1 - t0 for t0, t1, _ in ups)
    if not ups or total <= 0:
        return None
    return 100.0 * sum(tr for _, _, tr in ups) / total
