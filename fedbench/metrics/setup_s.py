"""Set-up time: from the process's start to the window's, on the host's
clock: imports, data, weights, the federation's set-up and the warm-up
round (with the kernels' build in a checkout's first run)."""


def read(ctx):
    return ctx.setup_s
