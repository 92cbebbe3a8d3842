"""The device's idle share of the traced window: one minus the union of
its operations' intervals (kernels, copies, sets) over the window."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
