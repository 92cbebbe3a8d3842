"""Ring-buffer span recorders, the ``Telemetry`` facade, and the
thread-local trace context.

Events are flat tuples ``(t0_ns, dur_ns, name, trace, tid, args)`` —
``t0_ns`` on this process's monotonic axis (re-anchored at export time via
the dump's ``anchor``, see ``repro_torch.obs.clock``), ``trace`` a nonzero trace
id when the event belongs to a sampled submit's span chain (0 = untraced),
``args`` a small msgpack-able dict or None.

Each *thread* appends to its own fixed-size ring (one uncontended lock per
ring, taken only so snapshots from other threads see a consistent view);
``dump()`` merges every ring in timestamp order.  Rings overwrite their
oldest events when full and count the overwrites (``dropped``), so a storm
degrades the trace, never the workload.

The trace context is a module-level thread-local: the store's submit path
sets it for the duration of one submit (``trace_scope``), and anything
downstream on the same thread — the TCP transport framing a message, the
in-process worker emulation folding inline — reads ``current_trace()``
without any plumbing through intermediate signatures.  Across real
process/TCP boundaries the context rides the wire frame's ``trace_ctx``
header field (``docs/WIRE_PROTOCOL.md``) and the receiving server restores
it around dispatch.
"""

from __future__ import annotations

import threading

from repro_torch.obs import clock
from repro_torch.obs.metrics import MetricsRegistry

_TLS = threading.local()


def current_trace() -> int:
    """The active trace id on this thread (0 = untraced)."""
    return getattr(_TLS, "trace", 0)


class trace_scope:
    """``with trace_scope(tid):`` — set the thread's trace context,
    restoring the previous one on exit.  A plain class (not a generator
    contextmanager) so the submit hot path pays two attribute writes."""

    __slots__ = ("trace", "prev")

    def __init__(self, trace: int):
        self.trace = trace

    def __enter__(self):
        self.prev = current_trace()
        _TLS.trace = self.trace
        return self

    def __exit__(self, *exc):
        _TLS.trace = self.prev
        return False


class _Ring:
    """One thread's fixed-capacity event ring."""

    __slots__ = ("lock", "cap", "buf", "head", "n", "dropped", "tid")

    def __init__(self, cap: int, tid: int):
        self.lock = threading.Lock()
        self.cap = cap
        self.buf: list = [None] * cap
        self.head = 0          # next write slot
        self.n = 0             # live events (<= cap)
        self.dropped = 0
        self.tid = tid

    def append(self, ev) -> None:
        with self.lock:
            self.buf[self.head] = ev
            self.head = (self.head + 1) % self.cap
            if self.n < self.cap:
                self.n += 1
            else:
                self.dropped += 1

    def snapshot(self) -> list:
        with self.lock:
            if self.n < self.cap:
                return self.buf[:self.n]
            return self.buf[self.head:] + self.buf[:self.head]


class Telemetry:
    """One process's (or one shard server's) telemetry sink: a metrics
    registry plus per-thread event rings, stamped with a wall-clock anchor
    so dumps from different processes merge onto one timeline.

    Constructed only when telemetry is *enabled* — disabled stores hold
    ``None`` and their hot paths pay a single attribute check (the
    compiled-out fast path).  ``sample_n`` thins the *trace* dimension
    (every Nth submit gets a nonzero trace id and a cross-boundary span
    chain); metrics and events are always recorded.
    """

    def __init__(self, sample_n: int = 1, ring_cap: int = 4096,
                 site: str = "parent"):
        self.sample_n = max(int(sample_n), 1)
        self.ring_cap = int(ring_cap)
        self.site = site
        self.metrics = MetricsRegistry()
        self.anchor = clock.wall_anchor()
        self._rings: list[_Ring] = []
        self._rings_lock = threading.Lock()
        self._tls = threading.local()

    # ----------------------------------------------------------------- spans
    def sampled(self, n: int) -> bool:
        """Whether the ``n``-th submit (0-based) is trace-sampled."""
        return n % self.sample_n == 0

    def _ring(self) -> _Ring:
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            ring = _Ring(self.ring_cap, threading.get_ident())
            self._tls.ring = ring
            with self._rings_lock:
                self._rings.append(ring)
        return ring

    def event(self, name: str, t0_ns: int, dur_ns: int, trace: int = 0,
              args: dict | None = None) -> None:
        self._ring().append((int(t0_ns), int(dur_ns), name, int(trace),
                             threading.get_ident(), args))

    class _Span:
        __slots__ = ("tel", "name", "trace", "args", "t0")

        def __init__(self, tel, name, trace, args):
            self.tel, self.name, self.trace, self.args = \
                tel, name, trace, args

        def __enter__(self):
            self.t0 = clock.monotonic_ns()
            return self

        def __exit__(self, *exc):
            t0 = self.t0
            self.tel.event(self.name, t0, clock.monotonic_ns() - t0,
                           self.trace, self.args)
            return False

    def span(self, name: str, trace: int = 0, args: dict | None = None):
        """``with tel.span("drain.fold", trace=t):`` — time a block and
        record it as one event."""
        return Telemetry._Span(self, name, trace, args)

    # ------------------------------------------------------------------ dump
    def events(self) -> list:
        """Every ring merged, oldest first."""
        with self._rings_lock:
            rings = list(self._rings)
        merged: list = []
        for ring in rings:
            merged.extend(ring.snapshot())
        merged.sort(key=lambda ev: ev[0])
        return merged

    def dropped(self) -> int:
        with self._rings_lock:
            rings = list(self._rings)
        return sum(r.dropped for r in rings)

    def dump(self) -> dict:
        """One site's telemetry as a flat msgpack-able dict (the payload
        of the ``obsdump`` wire reply)."""
        return {
            "site": self.site,
            "anchor": [self.anchor[0], self.anchor[1]],
            "sample_n": self.sample_n,
            "dropped": self.dropped(),
            "events": [[t0, dur, name, trace, tid, args]
                       for t0, dur, name, trace, tid, args in self.events()],
            "metrics": self.metrics.dump(),
        }
