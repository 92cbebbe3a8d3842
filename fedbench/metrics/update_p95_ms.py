"""The 95th percentile (nearest rank) over every update whose submit
returned inside the window, of the time from the client requesting its
model from the store to its submit returning."""

import math


def read(ctx):
    lat = sorted(t1 - t0 for t0, t1, _ in ctx.rec.window_updates())
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
