"""Federation observability for the port: spans, metrics, traces.

The port's own copy of ``repro.obs`` (``docs/OBSERVABILITY.md``), module for
module and name for name.  It is stdlib-only and imports no torch, so every
process of a federation (the parent store, spawned shard workers,
standalone TCP shard servers, of either package) carries its own
``Telemetry`` and ships its dump over the msgpack wire (``obsdump``); a
dump of either package merges and exports in the other.

  * ``repro_torch.obs.clock``   - the one clock site of the port;
  * ``repro_torch.obs.metrics`` - counters, gauges, log-bucketed histograms;
  * ``repro_torch.obs.record``  - per-thread ring-buffer recorders, the
    ``Telemetry`` facade and the thread-local trace context that rides wire
    frames across process and TCP boundaries;
  * ``repro_torch.obs.export``  - Prometheus text, JSON percentiles and
    Chrome/Perfetto trace events.

A store built without a ``Telemetry`` holds ``None`` and its hot paths pay
one attribute check.
"""

from repro_torch.obs import clock, export, metrics, record
from repro_torch.obs.export import (
    metrics_json,
    perfetto_trace,
    prometheus_text,
    write_perfetto,
)
from repro_torch.obs.metrics import MetricsRegistry, MetricsWindow
from repro_torch.obs.record import Telemetry, current_trace, trace_scope

__all__ = [
    "MetricsRegistry",
    "MetricsWindow",
    "Telemetry",
    "clock",
    "current_trace",
    "export",
    "metrics",
    "metrics_json",
    "perfetto_trace",
    "prometheus_text",
    "record",
    "trace_scope",
    "write_perfetto",
]
