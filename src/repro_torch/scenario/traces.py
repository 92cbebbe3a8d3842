"""Deterministic trace generators: seeded, composable ``TraceEvent``
streams.

A *trace* is a time-ordered list of :class:`TraceEvent`, each tagging one
simulation tick with a population change (``join``/``leave``), an
environment change (``avail``/``boost``/``outage_start``/``outage_end``/
``drift``) or a role assignment (``straggle``).  Client references are
flat ``int64`` index arrays: the replay engine
(``repro_torch.scenario.engine``) keeps all client state as flat numpy
arrays, so a 10^5-client event costs one vectorized mask update, never a
Python loop.  This module is numpy only, the reference's
(``repro.scenario.traces``) line for line, so both packages replay the
same streams (``tests/test_torch_traces.py``).

Every generator takes a ``seed`` and derives all randomness from one
``np.random.default_rng(seed)``: the same call produces the same stream,
byte for byte.  Generators compose by :func:`compose`, a stable merge by
tick — monotone event time is an invariant of every stream this module
emits.

Population-change discipline (the conservation invariant): a ``join``
only ever names clients that are absent at that point of the stream, a
``leave`` only clients that are present.  Replaying join/leave events
over a presence bitmap therefore keeps the population inside
``[0, n_clients]`` with no double-joins or double-leaves.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

#: event kinds, in the order ties at one tick are applied by the engine
KINDS = ("join", "leave", "straggle", "outage_start", "outage_end",
         "avail", "boost", "drift")


@dataclass(frozen=True)
class TraceEvent:
    """One tick-stamped event.  ``clients`` is a sorted ``int64`` index
    array for population/role events, ``None`` for environment events;
    ``args`` carries kind-specific payload (availability fractions, boost
    factor, region id, drift phase...)."""

    t: int
    kind: str
    clients: np.ndarray | None = None
    args: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown trace-event kind {self.kind!r}")


def _ids(mask_or_idx) -> np.ndarray:
    out = np.asarray(mask_or_idx)
    if out.dtype == bool:
        out = np.flatnonzero(out)
    return np.sort(out.astype(np.int64))


# ------------------------------------------------------------- generators

def diurnal(n_ticks: int, *, ticks_per_day: int = 24, peak: float = 0.9,
            base: float = 0.05, n_regions: int = 1, seed: int = 0,
            jitter: float = 0.0) -> list[TraceEvent]:
    """Solar-diurnal availability: per tick, the fraction of present
    clients that are reachable follows a clipped half-sine over daylight
    hours (PV gateways report while the inverter is up), per region with
    a longitude-like phase offset of ``ticks_per_day / n_regions`` ticks.
    ``jitter`` adds seeded per-tick noise on top of the cycle."""
    rng = np.random.default_rng(seed)
    events = []
    phase = np.arange(n_regions, dtype=np.float64) \
        * (ticks_per_day / max(n_regions, 1))
    for t in range(n_ticks):
        h = (t - phase) % ticks_per_day / ticks_per_day   # [0, 1) per region
        sun = np.clip(np.sin(np.pi * (h - 0.25) / 0.5), 0.0, None)
        frac = base + (peak - base) * sun
        if jitter:
            frac = frac + rng.normal(0.0, jitter, n_regions)
        events.append(TraceEvent(t, "avail",
                                 args={"frac": np.clip(frac, 0.0, 1.0)}))
    return events


def churn(n_clients: int, n_ticks: int, *, leave_prob: float = 0.01,
          return_prob: float = 0.25, seed: int = 0,
          initial_frac: float = 1.0) -> list[TraceEvent]:
    """Join/leave churn: ``initial_frac`` of the population joins at t=0,
    then each present client departs with ``leave_prob`` per tick and each
    absent one returns with ``return_prob``.  Emitted joins/leaves obey
    the conservation discipline (see module docstring) by construction:
    they are drawn from the simulated presence bitmap itself."""
    rng = np.random.default_rng(seed)
    present = np.zeros(n_clients, dtype=bool)
    events = []
    first = rng.random(n_clients) < initial_frac
    if first.any():
        events.append(TraceEvent(0, "join", _ids(first)))
        present |= first
    for t in range(1, n_ticks):
        u = rng.random(n_clients)
        leaving = present & (u < leave_prob)
        returning = ~present & (u < return_prob)
        if leaving.any():
            events.append(TraceEvent(t, "leave", _ids(leaving)))
        if returning.any():
            events.append(TraceEvent(t, "join", _ids(returning)))
        present = (present & ~leaving) | returning
    return events


def flash_crowd(t0: int, *, factor: float = 8.0, width: int = 2,
                joiners: np.ndarray | None = None) -> list[TraceEvent]:
    """A submit-rate spike around ``t0`` (a tariff-change push, a firmware
    rollout): the participation multiplier ramps to ``factor`` and decays
    over ``width`` ticks.  ``joiners`` optionally names clients that join
    at the spike's front edge (brand-new installations arriving with the
    crowd — they must be absent before ``t0`` in the composed trace)."""
    events = []
    if joiners is not None and len(joiners):
        events.append(TraceEvent(t0, "join", _ids(joiners)))
    for i in range(width + 1):
        f = 1.0 + (factor - 1.0) * (1.0 - i / (width + 1))
        events.append(TraceEvent(t0 + i, "boost", args={"factor": f}))
    return events


def stragglers(n_clients: int, *, frac: float = 0.05,
               fetch_every: int = 8, seed: int = 0) -> list[TraceEvent]:
    """Role assignment at t=0: ``frac`` of clients are stragglers that
    refresh their held model only every ``fetch_every`` ticks — their
    submits carry proportionally stale rounds, stretching the staleness
    histogram's tail."""
    rng = np.random.default_rng(seed)
    ids = _ids(rng.random(n_clients) < frac)
    return [TraceEvent(0, "straggle", ids,
                       args={"fetch_every": int(fetch_every)})]


def region_outage(region: int, t_start: int, t_end: int) -> list[TraceEvent]:
    """All clients in ``region`` go dark over ``[t_start, t_end)``; on
    recovery their deferred submits arrive as a burst (the engine boosts
    the recovered region's first tick)."""
    if t_end <= t_start:
        raise ValueError("outage must end after it starts")
    return [TraceEvent(t_start, "outage_start", args={"region": int(region)}),
            TraceEvent(t_end, "outage_end", args={"region": int(region)})]


def seasonal_drift(n_ticks: int, *, period: int = 96,
                   magnitude: float = 1.0) -> list[TraceEvent]:
    """Seasonal concept drift: the per-tick phase in ``[-magnitude,
    +magnitude]`` shifts every cluster's true regression target, and the
    season index increments at each half-period boundary (a *task*
    boundary in the continual-learning sense — the engine re-anchors its
    EWC state there)."""
    events = []
    for t in range(n_ticks):
        phase = magnitude * float(np.sin(2.0 * np.pi * t / period))
        events.append(TraceEvent(t, "drift",
                                 args={"phase": phase,
                                       "season": (2 * t) // period}))
    return events


# ------------------------------------------------------------ composition

def compose(*streams: list[TraceEvent]) -> list[TraceEvent]:
    """Stable merge of event streams ordered by (tick, kind priority):
    population changes land before the environment events of the same tick
    (``KINDS`` order), and ties beyond that keep argument order — so the
    composed stream is deterministic in its inputs and monotone in ``t``."""
    merged = [ev for stream in streams for ev in stream]
    return sorted(merged, key=lambda ev: (ev.t, KINDS.index(ev.kind)))


def by_tick(events: list[TraceEvent]) -> dict[int, list[TraceEvent]]:
    """Group a composed stream by tick (insertion order preserved)."""
    out: dict[int, list[TraceEvent]] = {}
    for ev in events:
        out.setdefault(int(ev.t), []).append(ev)
    return out


def replay_population(n_clients: int, events: list[TraceEvent]):
    """Fold join/leave events over a presence bitmap, asserting the
    conservation discipline; returns the final bitmap.  Shared by the
    engine (which *enforces* it) and the property tests (which *check*
    generator output against it)."""
    present = np.zeros(n_clients, dtype=bool)
    for ev in events:
        if ev.kind == "join":
            if present[ev.clients].any():
                raise ValueError(f"t={ev.t}: join of already-present client")
            present[ev.clients] = True
        elif ev.kind == "leave":
            if not present[ev.clients].all():
                raise ValueError(f"t={ev.t}: leave of absent client")
            present[ev.clients] = False
    return present
