"""Real-thread asynchronous runtime: clients as threads against the locked
``ModelStore`` — the closest in-process analogue of the paper's deployment
(independent edge clients + central server with per-model locks).  The
deterministic sim runtime stays the default for experiments.

With ``store.batch_aggregation`` the per-model locks stop serializing
clients: submits enqueue without blocking and one server drain thread
(``server-drain``) folds each model's queue into one coalesced N-way
aggregation per sweep (Algorithm-2-equivalent; see
``coalesced_aggregate``), backing off from ``drain_poll`` up to
``drain_poll_max`` while its sweeps find nothing.

With a ``ShardedModelStore`` the single drain thread becomes one worker per
shard (``drain-shard-{k}``, each sweeping only its shard's cluster models)
plus one global worker (``drain-global``) running the two-level global
fold, so drains of different clusters share no lock.  Shutdown is bounded:
every worker is joined within the store's ``drain_timeout_s`` (overridable
via ``join_timeout``), and a stuck worker counts a drain timeout on the
store (``agg_stats()["drain_timeouts"]``) and raises instead of hanging the
run.

With a secure-aggregation masker on the store the runtime switches to
full-round drains: client threads synchronize on a per-round barrier whose
action performs one ``drain_secure`` per model — pairwise masks only cancel
when the round's complete member set is folded in a single sum, so no
continuous drain thread is allowed to run mid-round.

Streams: every thread launches the port's kernels on its own current
stream, which is the device's default stream unless a caller sets another.
So the client threads and the drain threads share one stream, and a
tensor that a client thread makes and a drain thread folds needs no event;
the kernels' launch counters and kept scratch are guarded by
``kernels.build``'s locks.  Per-thread streams (with events and
``record_stream``) are a later item of ROADMAP.md.

With a ``ProcessShardedModelStore`` (spawned workers or TCP shard servers)
the drain threads become one ``process-pump`` whose ``drain_all`` beat
scatter-gathers a fold across every worker (the parallelism lives in the
workers; more parent threads would only contend for the interpreter
lock).  Crash detection and respawn live in the store's RPC layer.
"""

from __future__ import annotations

import threading
import time

from repro_torch.core.protocol import Client
from repro_torch.core.store import ModelStore


class AsyncThreadedRuntime:
    def __init__(self, clients: list[Client], store: ModelStore,
                 rounds_per_client: int = 2, stagger: float = 0.0,
                 drain_poll: float = 0.001,
                 drain_poll_max: float | None = None,
                 join_timeout: float | None = None):
        self.clients = clients
        self.store = store
        self.rounds = rounds_per_client
        self.stagger = stagger
        self.drain_poll = drain_poll
        # adaptive backoff ceiling: consecutive empty sweeps double the
        # sleep from drain_poll up to this bound (reset by any non-empty
        # sweep); the default keeps the worst submit-to-fold latency ~8 ms
        self.drain_poll_max = (max(drain_poll, 0.008)
                               if drain_poll_max is None
                               else max(drain_poll_max, drain_poll))
        # bounded shutdown deadline: the store's drain_timeout_s
        # (FedCCLConfig.drain_timeout_s) unless explicitly overridden
        self.join_timeout = (store.drain_timeout_s if join_timeout is None
                             else join_timeout)
        self.errors: list[BaseException] = []
        self.drain_workers: list[threading.Thread] = []

    def _one_round(self, client: Client):
        client.train_local()
        for key in client.cluster_keys:
            p, m = client.fetch(self.store, "cluster", key)
            args = client.train_update(
                p, m, self.store.model_key("cluster", key))
            client.submit(self.store, "cluster", key, *args)
        p, m = client.fetch(self.store, "global", None)
        args = client.train_update(p, m, self.store.model_key("global"))
        client.submit(self.store, "global", None, *args)

    def _client_loop(self, client: Client, idx: int):
        try:
            if self.stagger:
                time.sleep(self.stagger * idx)
            tel = getattr(self.store, "telemetry", None)
            for _ in range(self.rounds):
                if tel is None:
                    self._one_round(client)
                else:
                    with tel.span("client.round",
                                  args={"client": client.spec.client_id}):
                        self._one_round(client)
        except BaseException as e:  # surfaced by run()
            self.errors.append(e)

    def _drain_loop(self, drain_fn, stop: threading.Event):
        """One drain worker (the store's, a shard's or the global tier's):
        sweep its slice of the store until stopped, then one final sweep so
        nothing a client enqueued before exiting is left behind."""
        try:
            delay = self.drain_poll
            while not stop.is_set():
                if drain_fn() == 0:
                    time.sleep(delay)
                    delay = min(delay * 2, self.drain_poll_max)
                else:
                    delay = self.drain_poll
            drain_fn()
        except BaseException as e:
            self.errors.append(e)

    def _start_drain_workers(self, stop: threading.Event):
        """Sharded store: one pump per shard and one for the two-level
        global fold.  Process-sharded store: one pump whose ``drain_all``
        beat folds on every worker at once.  Single-queue store: one
        ``drain_all`` sweep."""
        if getattr(self.store, "scatter_drains", False):
            fns = [("process-pump", self.store.drain_all)]
        elif hasattr(self.store, "drain_shard"):
            fns = [(f"drain-shard-{k}",
                    (lambda k=k: self.store.drain_shard(k)))
                   for k in range(self.store.n_shards)]
            fns.append(("drain-global", self.store.drain_global))
        else:
            fns = [("server-drain", self.store.drain_all)]
        self.drain_workers = [
            threading.Thread(target=self._drain_loop, args=(fn, stop),
                             name=name) for name, fn in fns]
        for t in self.drain_workers:
            t.start()

    def _join_drain_workers(self, stop: threading.Event):
        stop.set()
        stuck = []
        for t in self.drain_workers:
            t.join(self.join_timeout)
            if t.is_alive():
                stuck.append(t.name)
        if stuck:
            # never silently return a partial drain: the expiry is counted
            # on the store (agg_stats()["drain_timeouts"]) and surfaced
            self.store._count_drain_timeout()
            raise RuntimeError(
                f"drain workers failed to stop within {self.join_timeout}s: "
                f"{stuck}")

    # ---------------------------------------------------- secure aggregation
    def _run_secure(self):
        """Lockstep rounds: every client thread submits its masked updates,
        then the barrier action (runs in exactly one thread) folds each
        model's round with ``drain_secure`` before the next round starts.
        Full participation — threaded dropout recovery is exercised through
        the sim runtime's dropout knob."""
        members = [("global", None, [c.spec.client_id for c in self.clients])]
        for key in self.store.keys():
            ids = [c.spec.client_id for c in self.clients
                   if key in c.cluster_keys]
            if ids:
                members.append(("cluster", key, ids))
        base = self.store.secure_round_offset
        state = {"round": base}

        def drain_round():
            r = state["round"]
            for level, key, ids in members:
                self.store.drain_secure(level, key, r, ids)
            state["round"] = r + 1

        barrier = threading.Barrier(len(self.clients), action=drain_round)

        def loop(client: Client, idx: int):
            try:
                if self.stagger:
                    time.sleep(self.stagger * idx)
                for r in range(base, base + self.rounds):
                    client.train_local()
                    for level, key, ids in members:
                        if client.spec.client_id in ids:
                            client.secure_round_update(self.store, level, key,
                                                       ids, r)
                    barrier.wait()
            except BaseException as e:      # surfaced by run()
                self.errors.append(e)
                barrier.abort()

        threads = [threading.Thread(target=loop, args=(c, i),
                                    name=f"client-{c.spec.client_id}")
                   for i, c in enumerate(self.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.store.secure_round_offset = base + self.rounds
        if self.errors:
            raise self.errors[0]

    def run(self):
        if self.store.masker is not None:
            return self._run_secure()
        threads = [threading.Thread(target=self._client_loop, args=(c, i),
                                    name=f"client-{c.spec.client_id}")
                   for i, c in enumerate(self.clients)]
        stop = threading.Event()
        if self.store.batch_aggregation:
            self._start_drain_workers(stop)
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.drain_workers:
            self._join_drain_workers(stop)
        if self.errors:
            raise self.errors[0]
