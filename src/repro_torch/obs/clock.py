"""The one clock site of the port, as ``repro.obs.clock`` is the reference's.

Everything in ``src/repro_torch/core``, ``src/repro_torch/obs`` and
``src/repro_torch/scenario`` reads clocks through this module, so there is
one place to audit for "does anything order work by clock time?" (nothing
does: monotonic values time durations and deadlines; the one wall-clock
read below only anchors them).

Monotonic timestamps are comparable across processes on the same host
(``CLOCK_MONOTONIC`` is system-wide on Linux), but not across hosts: a
remote shard server's event timestamps live on its own monotonic axis.
``wall_anchor()`` captures a ``(wall_ns, mono_ns)`` pair when a
``Telemetry`` is built; merging dumps re-anchors every event onto the wall
axis by ``wall_ns + (t - mono_ns)``, exact on one host and as accurate as
NTP across hosts.
"""

from __future__ import annotations

import time

#: duration and deadline clocks, aliased so call sites read
#: ``clock.monotonic()`` and this file is the only one naming the
#: underlying ``time`` functions
monotonic = time.monotonic
monotonic_ns = time.monotonic_ns


def wall_anchor() -> tuple[int, int]:
    """``(wall_ns, mono_ns)`` sampled back to back: the pair that maps this
    process's monotonic timestamps onto the wall clock.  The one wall-clock
    read of the port."""
    return (time.time_ns(), time.monotonic_ns())
