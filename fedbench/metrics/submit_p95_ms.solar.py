"""The 95th percentile of the store's own ``submit_latency_ns`` histogram
(``repro_torch.obs``; telemetry is on in the traced run only), over the
whole run."""


def read(ctx):
    if not ctx.telemetry:
        return None
    h = ctx.telemetry["histograms"].get("submit_latency_ns")
    if not h or not h["count"]:
        return None
    return h["p95"] / 1e6
