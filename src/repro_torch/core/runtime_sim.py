"""Deterministic asynchronous runtime: virtual-time event simulation.

Reproduces the paper's asynchrony (heterogeneous client speeds, staleness,
lock contention) deterministically: a client FETCHes a model snapshot at
virtual time t, "trains" for a duration drawn from its speed, and SUBMITs at
t + d — by which time other clients may have updated the same model, which
exercises the weighted-aggregation path rather than the sequential fast
path.  Seeded through numpy exactly as the reference, so the same seed gives
the same schedule in both packages.

Works against ``ModelStore`` and ``ShardedModelStore`` alike: the sim only
speaks the store protocol (``drain``/``effective_round``/``drain_secure``),
so a sharded store routes global drains through the two-level fold;
``stats()`` then also reports the shard fill balance.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.protocol import Client
from repro_torch.core.store import ModelStore
from repro_torch.obs import clock


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    kind: str = field(compare=False)          # "round_start" | "submit"
    client_idx: int = field(compare=False)
    payload: object = field(compare=False, default=None)


class AsyncSimRuntime:
    def __init__(self, clients: list[Client], store: ModelStore, *,
                 seed: int = 0, mean_round_time: float = 1.0,
                 jitter: float = 0.3, dropout_prob: float = 0.0):
        self.clients = clients
        self.store = store
        self.rng = np.random.default_rng(seed)
        self.mean_round_time = mean_round_time
        self.jitter = jitter
        self.dropout_prob = dropout_prob
        self._heap: list[_Event] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.completed_rounds = {c.spec.client_id: 0 for c in clients}
        self.staleness_log: list[int] = []     # rounds-behind at submit time

    # ------------------------------------------------------------------ sim
    def _duration(self, client: Client) -> float:
        base = self.mean_round_time / max(client.spec.speed, 1e-6)
        return float(base * self.rng.uniform(1 - self.jitter, 1 + self.jitter))

    def _push(self, ev_time, kind, client_idx, payload=None):
        heapq.heappush(self._heap,
                       _Event(ev_time, next(self._seq), kind, client_idx, payload))

    def run(self, rounds_per_client: int):
        """Each client performs `rounds_per_client` full Alg.1 rounds.

        With ``store.batch_aggregation`` submits enqueue instead of
        aggregating inline; queued updates are drained (coalesced into one
        N-way aggregation per model) right before anyone re-reads the model
        — at fetch time — and whenever a queue hits ``max_coalesce``.

        With a secure-aggregation masker on the store, the schedule switches
        to full-round drains instead (``_run_secure``): masks only cancel
        when a round's complete member set is folded at once.
        """
        if self.store.masker is not None:
            return self._run_secure(rounds_per_client)
        batched = self.store.batch_aggregation
        for i, c in enumerate(self.clients):
            self._push(self._duration(c) * self.rng.uniform(0, 1), "round_start", i)

        target = rounds_per_client
        while self._heap:
            ev = heapq.heappop(self._heap)
            self.now = ev.time
            client = self.clients[ev.client_idx]

            if ev.kind == "round_start":
                if self.completed_rounds[client.spec.client_id] >= target:
                    continue
                if self.dropout_prob and self.rng.random() < self.dropout_prob:
                    # client temporarily unavailable: retry later (resilience)
                    self._push(self.now + self._duration(client), "round_start",
                               ev.client_idx)
                    continue
                # local training happens on-device, immediately
                client.train_local()
                # fetch snapshots NOW; training completes after a delay
                jobs = []
                for key in client.cluster_keys:
                    if batched:
                        self.store.drain("cluster", key)
                    p, m = client.fetch(self.store, "cluster", key)
                    jobs.append(("cluster", key, p, m))
                if batched:
                    self.store.drain("global")
                p, m = client.fetch(self.store, "global", None)
                jobs.append(("global", None, p, m))
                self._push(self.now + self._duration(client), "submit",
                           ev.client_idx, jobs)

            elif ev.kind == "submit":
                for level, key, p, m in ev.payload:
                    new_p, new_meta, delta = client.train_update(
                        p, m, self.store.model_key(level, key))
                    # staleness vs the round at enqueue time: queued-but-
                    # undrained updates count (in batched mode the
                    # materialized meta lags the logical server round)
                    cur_round = self.store.effective_round(level, key)
                    self.staleness_log.append(cur_round - m.round)
                    client.submit(self.store, level, key, new_p, new_meta, delta)
                    if batched and (self.store.pending_depth(level, key)
                                    >= self.store.max_coalesce):
                        self.store.drain(level, key)
                tel = getattr(self.store, "telemetry", None)
                if tel is not None:
                    # an instant marker (sim time is virtual): one event a
                    # completed client round on the host clock's timeline
                    tel.event("client.round", clock.monotonic_ns(), 0,
                              args={"client": client.spec.client_id})
                self.completed_rounds[client.spec.client_id] += 1
                if self.completed_rounds[client.spec.client_id] < target:
                    self._push(self.now + 1e-3, "round_start", ev.client_idx)
        if batched:
            self.store.drain_all()

    # ---------------------------------------------------- secure aggregation
    def _model_members(self):
        """(level, cluster_key, member clients) for every server model."""
        out = [("global", None, list(self.clients))]
        for key in self.store.keys():
            members = [c for c in self.clients if key in c.cluster_keys]
            if members:
                out.append(("cluster", key, members))
        return out

    def _run_secure(self, rounds: int):
        """Full-round lockstep schedule for secure aggregation: every
        available member of a model submits its masked update, then one
        ``drain_secure`` folds the round (masks cancel inside the fused sum).
        Clients hit by ``dropout_prob`` sit the whole round out — their
        stray masks are recovered via seed reconstruction, the paper's
        dynamic-availability setting."""
        base = self.store.secure_round_offset
        for r in range(base, base + rounds):
            avail = [c for c in self.clients
                     if not (self.dropout_prob
                             and self.rng.random() < self.dropout_prob)]
            if not avail:      # degenerate draw: keep the round non-empty
                avail = [self.clients[int(self.rng.integers(len(self.clients)))]]
            for c in avail:
                c.train_local()
            for level, key, members in self._model_members():
                participants = [c for c in avail if c in members]
                if not participants:
                    continue
                expected = [c.spec.client_id for c in members]
                for c in participants:
                    c.secure_round_update(self.store, level, key, expected, r)
                    self.staleness_log.append(0)   # lockstep: never stale
                self.store.drain_secure(level, key, r, expected)
            self.now += max(self._duration(c) for c in avail)
            for c in avail:
                self.completed_rounds[c.spec.client_id] += 1
        self.store.secure_round_offset = base + rounds

    # ------------------------------------------------------------- reporting
    def stats(self) -> dict:
        sl = np.array(self.staleness_log) if self.staleness_log else np.zeros(1)
        out = {
            "virtual_time": self.now,
            "updates": self.store.n_updates,
            "fast_path_frac": (self.store.n_fast_path / max(self.store.n_updates, 1)),
            "mean_staleness": float(sl.mean()),
            "max_staleness": int(sl.max()),
        }
        if self.store.batch_aggregation:
            out["coalesce_factor"] = self.store.coalesce_factor()
            out["max_queue_depth"] = self.store.max_queue_depth
        if hasattr(self.store, "n_shards"):
            # sharded store: surface the shard fill balance so schedule skew
            # (all clients in one cluster -> one hot shard) is visible
            sharded = self.store.agg_stats()
            out["shards"] = sharded["shards"]
            out["global_drains"] = sharded["global_drains"]
            out["shard_enqueued"] = sharded["shard_enqueued"]
            if "respawns" in sharded:
                # process-sharded store (the in-process emulation here)
                out["processes"] = sharded["processes"]
                out["respawns"] = sharded["respawns"]
                out["drain_timeouts"] = sharded["drain_timeouts"]
        if self.store.masker is not None:
            out["secure_rounds"] = self.store.n_secure_rounds
            out["secure_recoveries"] = self.store.n_secure_recoveries
            out["coalesce_factor"] = self.store.coalesce_factor()
        return out
