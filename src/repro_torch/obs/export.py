"""Exporters: Prometheus text, JSON percentiles, Perfetto trace events.

All three consume the *multi-site* dump shape every store's
``telemetry_dump()`` returns::

    {"sites": [<Telemetry.dump()>, ...]}

— site 0 is the parent process, later sites are shard workers / remote
shard servers (fetched over the wire via the ``obsdump`` command).  Metric
exporters merge the sites (bucket-additive, see ``repro_torch.obs.metrics``);
the trace exporter keeps them apart as Perfetto processes and re-anchors
each site's monotonic timestamps onto the shared wall clock through its
``anchor`` pair, so one cross-host drain lines up on a single timeline.
"""

from __future__ import annotations

import json

from repro_torch.obs.metrics import (
    N_BUCKETS,
    bucket_le,
    merge_metric_dumps,
    percentile_from_buckets,
)

_EMPTY = {"counters": {}, "gauges": {}, "histograms": {}}


def merged_metrics(dump: dict) -> dict:
    """One registry dump merged across every site."""
    out = _EMPTY
    for site in dump["sites"]:
        out = merge_metric_dumps(out, site["metrics"])
    return out


# ------------------------------------------------------------------- JSON

def metrics_json(dump: dict) -> dict:
    """Merged metrics with p50/p95/p99 summaries per histogram — the
    ``FedCCL.metrics_report()`` payload."""
    m = merged_metrics(dump)
    hists = {}
    for name, h in m["histograms"].items():
        hists[name] = {
            "count": h["count"],
            "sum": h["sum"],
            "mean": (h["sum"] / h["count"]) if h["count"] else 0.0,
            "max": h["max"],
            "p50": percentile_from_buckets(h, 0.50),
            "p95": percentile_from_buckets(h, 0.95),
            "p99": percentile_from_buckets(h, 0.99),
        }
    return {
        "sites": [s["site"] for s in dump["sites"]],
        "dropped_events": sum(s["dropped"] for s in dump["sites"]),
        "counters": m["counters"],
        "gauges": m["gauges"],
        "histograms": hists,
    }


# -------------------------------------------------------------- Prometheus

def _prom_name(name: str) -> str:
    return "fedccl_" + "".join(
        c if (c.isalnum() or c == "_") else "_" for c in name.lower())


def prometheus_text(dump: dict) -> str:
    """Prometheus text exposition format (one scrape page)."""
    m = merged_metrics(dump)
    lines: list[str] = []
    for name, v in m["counters"].items():
        pn = _prom_name(name)
        lines += [f"# TYPE {pn}_total counter", f"{pn}_total {v}"]
    for name, v in m["gauges"].items():
        pn = _prom_name(name)
        lines += [f"# TYPE {pn} gauge", f"{pn} {v}"]
    for name, h in m["histograms"].items():
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        last_nonzero = max((i for i, n in enumerate(h["buckets"]) if n),
                           default=0)
        for idx in range(min(last_nonzero + 1, N_BUCKETS)):
            cum += h["buckets"][idx]
            lines.append(f'{pn}_bucket{{le="{bucket_le(idx)}"}} {cum}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{pn}_sum {h['sum']}")
        lines.append(f"{pn}_count {h['count']}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- Perfetto

def _wall_us(site: dict, t_ns: int) -> float:
    """Re-anchor one site-monotonic timestamp onto the wall clock, in
    microseconds (the trace-event time unit)."""
    wall_ns, mono_ns = site["anchor"]
    return (wall_ns + (t_ns - mono_ns)) / 1000.0


def perfetto_trace(dump: dict) -> dict:
    """Chrome trace-event JSON (loads in Perfetto / chrome://tracing).

    One Perfetto *process* per site, one track per recording thread.
    Every event becomes a complete ("X") duration event; events that share
    a nonzero trace id — plus events linked by a wire *seq* (a traced
    parent enqueue stamps ``args["seq"]``, the worker fold that consumes it
    stamps ``args["seqs"]``; both join chain ``seq + 1``) — are chained
    with flow arrows ("s"/"t"/"f"), which is what draws one submit's span
    chain across the parent -> worker process/TCP boundary.
    """
    trace_events: list[dict] = []
    chains: dict[int, list[tuple[float, dict]]] = {}
    for pid, site in enumerate(dump["sites"]):
        trace_events.append({
            "ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": f"fedccl:{site['site']}"},
        })
        for t0, dur, name, trace, tid, args in site["events"]:
            ts = _wall_us(site, t0)
            ev = {"ph": "X", "pid": pid, "tid": tid, "ts": ts,
                  "dur": max(dur / 1000.0, 0.001), "name": name,
                  "cat": "fedccl",
                  "args": dict(args or {}, trace=trace)}
            trace_events.append(ev)
            seqs = list((args or {}).get("seqs") or ())
            if (args or {}).get("seq") is not None:
                seqs.append(args["seq"])
            # the set dedups the trace == seq + 1 coincidence (stores mint
            # trace ids from the submit seq counter, so a traced enqueue
            # would otherwise join its own chain twice)
            for cid in sorted({trace, *(int(s) + 1 for s in seqs)} - {0}):
                chains.setdefault(cid, []).append((ts, ev))
    for trace, hops in sorted(chains.items()):
        if len(hops) < 2:
            continue
        hops.sort(key=lambda h: h[0])
        for i, (ts, ev) in enumerate(hops):
            ph = "s" if i == 0 else ("f" if i == len(hops) - 1 else "t")
            flow = {"ph": ph, "cat": "fedccl.flow", "name": "submit",
                    "id": trace, "pid": ev["pid"], "tid": ev["tid"],
                    "ts": ts + 0.001}
            if ph == "f":
                flow["bp"] = "e"
            trace_events.append(flow)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_perfetto(dump: dict, path) -> None:
    with open(path, "w") as f:
        json.dump(perfetto_trace(dump), f)
