"""Counters, gauges, and log-bucketed (HDR-style) histograms.

Histogram buckets are powers of two: bucket ``i`` holds values whose
``int(v).bit_length() == i`` (bucket 0 holds 0), i.e. ``[2**(i-1), 2**i)``.
64 buckets cover every nanosecond duration and byte count we record, the
observe path is one ``bit_length`` + one list increment, and two sites'
histograms merge by adding bucket counts — which is what makes
cross-process aggregation (parent + shard workers) exact: the merged
histogram is identical to the one a single recorder would have produced.

Dumps are plain dicts of ints/floats/lists so they survive the msgpack
wire codec unchanged (the ``obsdump`` worker command ships them).
"""

from __future__ import annotations

import threading

N_BUCKETS = 64


class Counter:
    """Monotone counter (thread-safe)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value (thread-safe)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class LogHistogram:
    """Log2-bucketed histogram: O(1) observe, exact merge, ~2x value error
    on percentile estimates (a bucket spans one octave)."""

    __slots__ = ("_lock", "buckets", "count", "sum", "max")

    def __init__(self):
        self._lock = threading.Lock()
        self.buckets = [0] * N_BUCKETS
        self.count = 0
        self.sum = 0
        self.max = 0

    def observe(self, v) -> None:
        iv = int(v)
        if iv < 0:
            iv = 0
        idx = min(iv.bit_length(), N_BUCKETS - 1)
        with self._lock:
            self.buckets[idx] += 1
            self.count += 1
            self.sum += iv
            if iv > self.max:
                self.max = iv

    def snapshot(self) -> dict:
        with self._lock:
            return {"buckets": list(self.buckets), "count": self.count,
                    "sum": self.sum, "max": self.max}


# ------------------------------------------------------------- dump algebra

def bucket_le(idx: int) -> int:
    """Inclusive upper bound of bucket ``idx`` (0 for the zero bucket)."""
    return 0 if idx == 0 else (1 << idx) - 1


def percentile_from_buckets(hist: dict, q: float) -> float:
    """Approximate q-quantile (0 < q <= 1) of a histogram *dump*: the
    geometric midpoint of the bucket where the cumulative count crosses
    ``q * count``.  Exact for bucket 0, within one octave elsewhere."""
    count = hist["count"]
    if count == 0:
        return 0.0
    rank = q * count
    cum = 0
    for idx, n in enumerate(hist["buckets"]):
        cum += n
        if cum >= rank and n:
            if idx == 0:
                return 0.0
            return 1.5 * float(1 << (idx - 1))   # mid of [2^(i-1), 2^i)
    return float(hist["max"])


def merge_hist_dumps(a: dict, b: dict) -> dict:
    return {
        "buckets": [x + y for x, y in zip(a["buckets"], b["buckets"],
                                          strict=True)],
        "count": a["count"] + b["count"],
        "sum": a["sum"] + b["sum"],
        "max": max(a["max"], b["max"]),
    }


def merge_metric_dumps(a: dict, b: dict) -> dict:
    """Merge two registry dumps: counters add, gauges add (every gauge we
    export is a per-site absolute total — bytes on the wire, dirty
    mirrors — so the cross-site sum is the fleet total), histograms merge
    bucket-wise."""
    out = {"counters": dict(a["counters"]), "gauges": dict(a["gauges"]),
           "histograms": dict(a["histograms"])}
    for name, v in b["counters"].items():
        out["counters"][name] = out["counters"].get(name, 0) + v
    for name, v in b["gauges"].items():
        out["gauges"][name] = out["gauges"].get(name, 0.0) + v
    for name, h in b["histograms"].items():
        if name in out["histograms"]:
            out["histograms"][name] = merge_hist_dumps(
                out["histograms"][name], h)
        else:
            out["histograms"][name] = dict(h)
    return out


def diff_hist_dumps(after: dict, before: dict) -> dict:
    """Histogram dump covering only what ``after`` observed beyond
    ``before`` (bucket counts are monotone, so bucket-wise subtraction is
    exact; ``max`` is the after-side max — a histogram cannot un-observe
    its peak, so a window's max is an upper bound, never an undercount)."""
    return {
        "buckets": [x - y for x, y in zip(after["buckets"],
                                          before["buckets"], strict=True)],
        "count": after["count"] - before["count"],
        "sum": after["sum"] - before["sum"],
        "max": after["max"],
    }


def diff_metric_dumps(after: dict, before: dict) -> dict:
    """Scenario-scoped window over two registry dumps of the SAME site(s):
    counters and histogram buckets subtract (both monotone), gauges keep
    the after-side value (last-write-wins instruments have no delta).
    Instruments that first appear in ``after`` pass through unchanged."""
    out = {"counters": {}, "gauges": dict(after["gauges"]),
           "histograms": {}}
    for name, v in after["counters"].items():
        out["counters"][name] = v - before["counters"].get(name, 0)
    for name, h in after["histograms"].items():
        b = before["histograms"].get(name)
        out["histograms"][name] = dict(h) if b is None \
            else diff_hist_dumps(h, b)
    return out


class MetricsWindow:
    """Scenario-scoped metric window: snapshot a dump source at open, diff
    against it at close — so per-scenario SLO verdicts (repro_torch.scenario)
    reflect only that scenario's traffic even when the store (and its
    registry) is reused across runs in one process.

    ``source`` is any zero-arg callable returning a registry dump (a bound
    ``MetricsRegistry.dump``, or a closure merging multi-site dumps with
    :func:`merge_metric_dumps`)."""

    def __init__(self, source):
        self._source = source
        self._open = source()

    def diff(self) -> dict:
        return diff_metric_dumps(self._source(), self._open)


class MetricsRegistry:
    """Name -> instrument, create-on-first-use (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, LogHistogram] = {}

    def _get(self, table: dict, name: str, factory):
        inst = table.get(name)
        if inst is None:
            with self._lock:
                inst = table.setdefault(name, factory())
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> LogHistogram:
        return self._get(self._histograms, name, LogHistogram)

    def dump(self) -> dict:
        return {
            "counters": {n: c.value
                         for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(self._histograms.items())},
        }
