"""Three-tier server model store (paper Fig. 1 + Algorithm 1 server side):
the single-lock ``ModelStore``.

Levels: "global" (one model), "cluster" (one per cluster key, keys are
namespaced e.g. "loc:2" / "ori:1"), and client-side "local" models which
never touch the server.  ``handle_model_update`` implements the server
update handler with per-model locking (lines 19-25 of Algorithm 1).

Batched mode (``batch_aggregation=True``): clients enqueue updates without
blocking on the model lock; a drain step folds every queued update for a
model into one ``coalesced_aggregate`` call — one fold kernel launch per
drained batch instead of one full parameter pass per update.  Semantics are
identical to the sequential fold (see ``coalesced_aggregate``).

Secure mode (``masker`` attached): clients submit masked weighted deltas via
``submit_secure`` and ``drain_secure`` folds one full round at a time — the
pairwise masks cancel inside the fused N-way sum, with seed-reconstruction
recovery for members that dropped mid-round (see
``repro_torch.privacy.secure_agg``).

Stored parameters are never updated in place: a fold builds a new tree and
swaps it in, so a snapshot handed to a client stays as it was.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

from repro_torch.core.aggregation import (
    AggregationConfig,
    ModelMeta,
    UpdateDelta,
    aggregate_models,
    coalesced_aggregate,
    secure_coalesced_aggregate,
)

GLOBAL_KEY = "__global__"


@dataclass(frozen=True)
class PendingUpdate:
    """One client update queued for a later coalesced drain."""

    params: object
    meta: ModelMeta
    delta: UpdateDelta


@dataclass(frozen=True)
class PendingSecureUpdate:
    """One masked client update awaiting its round's secure drain."""

    client_id: str
    round_id: int
    masked_delta: object     # s_i * privatized_delta_i + pairwise masks
    delta: UpdateDelta


class ModelRecord:
    """One stored model.  (params, meta) live in a single tuple swapped by
    one reference assignment, so lock-free snapshot reads can never observe
    new params with old meta (or vice versa) mid-aggregation."""

    def __init__(self, params, meta: ModelMeta = None):
        self._state = (params, meta if meta is not None else ModelMeta())
        self.lock = threading.Lock()
        # pending updates awaiting a coalesced drain; guarded by pending_lock
        # so enqueues never block behind an in-flight aggregation holding
        # `lock`
        self.pending: deque = deque()
        self.pending_lock = threading.Lock()
        # rounds popped by an in-flight drain but not yet reflected in meta;
        # guarded by pending_lock so `effective_round` readers always see
        # pop-and-register / swap-and-retire as single atomic steps
        self.inflight_rounds: int = 0
        # secure-aggregation rounds: round_id -> [PendingSecureUpdate];
        # guarded by pending_lock as well
        self.secure_pending: dict[int, list] = {}

    @property
    def params(self):
        return self._state[0]

    @property
    def meta(self) -> ModelMeta:
        return self._state[1]

    def swap(self, params, meta: ModelMeta):
        self._state = (params, meta)

    def snapshot(self):
        return self._state


def _drain_record_once(rec: ModelRecord, max_coalesce: int,
                       agg_cfg: AggregationConfig):
    """Pop and fold one coalesced batch; returns the CoalesceResult or None.
    Caller holds ``rec.lock``.

    The two pending_lock critical sections keep ``effective_round`` readers
    consistent mid-drain: the pop registers the batch's rounds as in-flight
    in the same section that removes them from the queue, and the publish
    swaps meta and retires them in one section — a reader holding
    pending_lock can never see the batch in neither place.
    """
    with rec.pending_lock:
        take = min(len(rec.pending), max_coalesce)
        batch = [rec.pending.popleft() for _ in range(take)]
        rounds = sum(u.delta.rounds for u in batch)
        rec.inflight_rounds += rounds
    if not batch:
        return None
    try:
        res = coalesced_aggregate(rec.params, rec.meta,
                                  [(u.params, u.meta, u.delta)
                                   for u in batch],
                                  agg_cfg)
    except BaseException:
        # a malformed update must not strand the batch: put it back at the
        # queue head (FIFO preserved) and retire the in-flight rounds so
        # effective_round stays truthful, then surface the error
        with rec.pending_lock:
            rec.pending.extendleft(reversed(batch))
            rec.inflight_rounds -= rounds
        raise
    with rec.pending_lock:
        rec.swap(res.params, res.meta)
        rec.inflight_rounds -= rounds
    return res


def _drain_secure_record(rec: ModelRecord, key: str, round_id: int,
                         expected_ids, masker,
                         agg_cfg: AggregationConfig) -> tuple[int, int]:
    """Fold one secure round on one record; returns (folded, recovered).
    Caller holds ``rec.lock``."""
    with rec.pending_lock:
        batch = rec.secure_pending.pop(round_id, [])
    if not batch:
        return 0, 0
    try:
        submitted = {u.client_id for u in batch}
        missing = sorted(set(expected_ids) - submitted)
        correction = None
        if missing:
            if masker is None:
                raise RuntimeError(
                    "secure round has dropouts but no masker is attached "
                    "for seed reconstruction")
            correction = masker.reconstruct(
                rec.params, missing, sorted(submitted), round_id, key)
        res = secure_coalesced_aggregate(
            rec.params, rec.meta,
            [(u.masked_delta, u.delta) for u in batch],
            agg_cfg, correction)
    except BaseException:
        # don't strand the round: restore it so a later retry can fold it
        with rec.pending_lock:
            rec.secure_pending[round_id] = \
                batch + rec.secure_pending.get(round_id, [])
        raise
    with rec.pending_lock:
        rec.swap(res.params, res.meta)
    return len(batch), len(missing)


class _RegistryBase:
    """Model-registry plumbing.

    The registry is **copy-on-write**: ``_records`` is only ever replaced
    wholesale (never mutated in place) under ``_registry_lock``, so readers
    — the submit hot path, snapshot fetches, drains — take no lock at all;
    they read whatever consistent dict reference is current.
    ``ensure_cluster`` (Predict & Evolve joins mid-run) is the only writer.
    """

    def __init__(self, init_params, cluster_keys=()):
        self._registry_lock = threading.Lock()     # writers only (COW swap)
        records = {GLOBAL_KEY: ModelRecord(init_params)}
        for key in cluster_keys:
            records[str(key)] = ModelRecord(init_params)
        self._records: dict[str, ModelRecord] = records

    # ------------------------------------------------------------------ keys
    @staticmethod
    def _key(level: str, cluster_key: str | None) -> str:
        if level == "global":
            return GLOBAL_KEY
        if cluster_key is None:
            raise ValueError("cluster level requires a key")
        return str(cluster_key)

    def model_key(self, level: str, cluster_key: str | None = None) -> str:
        """Public (level, cluster_key) -> storage-key mapping — the string
        clients and the masker must agree on when deriving round masks."""
        return self._key(level, cluster_key)

    def _record(self, key: str) -> ModelRecord:
        """Lock-free registry read off the current copy-on-write snapshot."""
        # fedlint: unlocked-ok(copy-on-write registry snapshot read)
        rec = self._records.get(key)
        if rec is None:
            # fedlint: unlocked-ok(copy-on-write registry snapshot read)
            known = sorted(k for k in self._records if k != GLOBAL_KEY)
            raise KeyError(
                f"no model registered for cluster key {key!r} "
                f"(known cluster keys: {known})")
        return rec

    def ensure_cluster(self, cluster_key: str, init_params=None):
        """Predict & Evolve: a newly formed cluster gets a model seeded from
        the current global model (immediate specialization base)."""
        key = str(cluster_key)
        with self._registry_lock:
            if key not in self._records:
                seed = init_params if init_params is not None else \
                    self._records[GLOBAL_KEY].params
                updated = dict(self._records)
                updated[key] = ModelRecord(seed)
                self._records = updated            # atomic reference swap

    def keys(self):
        # fedlint: unlocked-ok(copy-on-write registry snapshot read)
        return [k for k in self._records if k != GLOBAL_KEY]

    # -------------------------------------------------------------- protocol
    def request_model(self, level: str, cluster_key: str | None = None):
        """RequestModel — snapshot read (no model lock needed for consistency;
        the paper's clients read whatever the latest aggregated state is)."""
        return self._record(self._key(level, cluster_key)).snapshot()

    # ------------------------------------------------------------- inspection
    def meta(self, level: str, cluster_key: str | None = None) -> ModelMeta:
        return self._record(self._key(level, cluster_key)).meta

    def params(self, level: str, cluster_key: str | None = None):
        return self._record(self._key(level, cluster_key)).params


class _SubmitStats:
    """Submit-side (hot-path) counters behind their own lock."""

    __slots__ = ("lock", "n_updates", "n_fast_path", "n_lock_waits",
                 "n_enqueued", "max_queue_depth")

    def __init__(self):
        self.lock = threading.Lock()
        self.n_updates = 0        # direct-path (non-batched) aggregations
        self.n_fast_path = 0
        self.n_lock_waits = 0
        self.n_enqueued = 0
        self.max_queue_depth = 0

    def count_lock_wait(self):
        with self.lock:
            self.n_lock_waits += 1

    def count_direct(self, fast: bool):
        with self.lock:
            self.n_updates += 1
            if fast:
                self.n_fast_path += 1

    def count_enqueue(self):
        # callers count BEFORE publishing to the queue: a concurrent drain
        # may fold the update the instant it becomes visible, and
        # `updates <= enqueued` must hold for every agg_stats() snapshot
        with self.lock:
            self.n_enqueued += 1

    def observe_depth(self, depth: int):
        with self.lock:
            if depth > self.max_queue_depth:
                self.max_queue_depth = depth

    def snapshot(self) -> tuple:
        """One consistent read: (updates, fast_path, lock_waits, enqueued,
        max_depth)."""
        with self.lock:
            return (self.n_updates, self.n_fast_path, self.n_lock_waits,
                    self.n_enqueued, self.max_queue_depth)


class _StoreBase(_RegistryBase):
    """Submit paths and per-record drains.  The sharded, process and TCP
    flavors of the reference arrive with the scale-out slice; they share
    this base there, which is why the stats sink is a hook."""

    def __init__(self, init_params, cluster_keys=(),
                 agg_cfg: AggregationConfig = AggregationConfig(),
                 batch_aggregation: bool = False, max_coalesce: int = 16,
                 masker=None, drain_timeout_s: float = 30.0):
        super().__init__(init_params, cluster_keys)
        self.agg_cfg = agg_cfg
        self.batch_aggregation = batch_aggregation
        self.max_coalesce = max(int(max_coalesce), 1)
        # bounded-drain deadline (FedCCLConfig.drain_timeout_s): drain-worker
        # joins in the threaded runtime; expiries are counted
        # (``drain_timeouts`` in agg_stats()) instead of silently returning
        # partial drains
        self.drain_timeout_s = float(drain_timeout_s)
        # secure aggregation: a repro_torch.privacy.secure_agg.PairwiseMasker
        # (its presence switches both runtimes to full-round secure drains)
        self.masker = masker
        # monotone round-id base carried across runtime runs — pair masks are
        # derived from (pair, round_id, model_key), so round ids must never
        # repeat for one masker or masks would be reused (and cancellable
        # across runs by an observer)
        self.secure_round_offset = 0
        # drain-side counters (cold path: one touch per batch, not per
        # submit) behind a store-level lock
        self._drain_lock = threading.Lock()
        self._n_drain_updates = 0
        self._n_drain_fast_path = 0
        self.n_drain_batches = 0
        self.n_drained = 0                     # updates consumed by drains
        self.n_secure_rounds = 0               # secure drains performed
        self.n_secure_recoveries = 0           # dropped clients recovered
        self.n_drain_timeouts = 0              # bounded-drain deadline misses

    # ----------------------------------------------------------- flavor hooks
    def _submit_stats(self, key: str) -> _SubmitStats:
        """The submit-side stats sink the given model key bills to."""
        raise NotImplementedError

    def _all_submit_stats(self) -> list:
        """Every submit-side sink, for the aggregate counter properties."""
        raise NotImplementedError

    def _count_drain(self, folded: int, fast: int, secure: bool = False,
                     recovered: int = 0):
        with self._drain_lock:
            self._n_drain_updates += folded
            self._n_drain_fast_path += fast
            self.n_drain_batches += 1
            self.n_drained += folded
            if secure:
                self.n_secure_rounds += 1
                self.n_secure_recoveries += recovered

    def _count_drain_timeout(self):
        """Record a bounded-drain deadline miss."""
        with self._drain_lock:
            self.n_drain_timeouts += 1

    # ---------------------------------- aggregate counters (drain + submit)
    # Each property takes `_drain_lock` for the drain half and reads every
    # submit sink through its locked `snapshot()` tuple
    # (updates, fast_path, lock_waits, enqueued, max_depth).
    @property
    def n_updates(self) -> int:
        with self._drain_lock:
            drain = self._n_drain_updates
        return drain + sum(s.snapshot()[0] for s in self._all_submit_stats())

    @property
    def n_fast_path(self) -> int:
        with self._drain_lock:
            drain = self._n_drain_fast_path
        return drain + sum(s.snapshot()[1] for s in self._all_submit_stats())

    @property
    def n_lock_waits(self) -> int:
        return sum(s.snapshot()[2] for s in self._all_submit_stats())

    @property
    def n_enqueued(self) -> int:
        return sum(s.snapshot()[3] for s in self._all_submit_stats())

    @property
    def max_queue_depth(self) -> int:
        return max((s.snapshot()[4] for s in self._all_submit_stats()),
                   default=0)

    # -------------------------------------------------------------- protocol
    def handle_model_update(self, level: str, cluster_key: str | None,
                            updated_params, updated_meta: ModelMeta,
                            delta: UpdateDelta, *, blocking: bool = True) -> bool:
        """HandleModelUpdate (Algorithm 1 lines 19-25): lock the one model
        being updated, aggregate, store, release.  Returns False if
        ``blocking=False`` and the lock was busy (client retries later).

        In batched mode the update is enqueued instead (never blocks, always
        accepted); a later drain folds the whole queue at once.
        """
        if self.batch_aggregation:
            self.enqueue_update(level, cluster_key, updated_params,
                                updated_meta, delta)
            return True
        key = self._key(level, cluster_key)
        rec = self._record(key)
        st = self._submit_stats(key)
        if not rec.lock.acquire(blocking=blocking):
            st.count_lock_wait()
            return False
        try:
            fast = (self.agg_cfg.sequential_fast_path
                    and updated_meta.round == rec.meta.round + 1)
            rec.swap(*aggregate_models(
                rec.params, rec.meta, updated_params, updated_meta, delta,
                self.agg_cfg))
            st.count_direct(fast)
        finally:
            rec.lock.release()
        return True

    # ------------------------------------------------------- batched updates
    def enqueue_update(self, level: str, cluster_key: str | None,
                       updated_params, updated_meta: ModelMeta,
                       delta: UpdateDelta) -> int:
        """Queue an update for a later coalesced drain; returns queue depth."""
        key = self._key(level, cluster_key)
        rec = self._record(key)
        st = self._submit_stats(key)
        st.count_enqueue()          # before publish — see _SubmitStats
        with rec.pending_lock:
            rec.pending.append(PendingUpdate(updated_params, updated_meta,
                                             delta))
            depth = len(rec.pending)
        st.observe_depth(depth)
        return depth

    def pending_depth(self, level: str, cluster_key: str | None = None) -> int:
        rec = self._record(self._key(level, cluster_key))
        with rec.pending_lock:
            return len(rec.pending)

    def effective_round(self, level: str, cluster_key: str | None = None) -> int:
        """Server round *including* queued-but-undrained updates (each
        pending update advances the round by ``delta.rounds`` once drained).
        This is the staleness reference for batched mode; ``inflight_rounds``
        covers the window between popping a batch and swapping its meta in."""
        rec = self._record(self._key(level, cluster_key))
        with rec.pending_lock:
            queued = sum(u.delta.rounds for u in rec.pending)
            return rec.meta.round + queued + rec.inflight_rounds

    def _drain_record(self, key: str) -> int:
        """Fold all queued updates for one record, ``max_coalesce`` at a
        time, into single N-way aggregations; returns updates folded."""
        rec = self._record(key)
        drained = 0
        while True:
            # model lock first so concurrent drains stay FIFO; enqueues only
            # touch pending_lock and keep flowing while we aggregate
            with rec.lock:
                res = _drain_record_once(rec, self.max_coalesce, self.agg_cfg)
            if res is None:
                return drained
            # `res` is a drain-local CoalesceResult whose field name
            # collides with the lock-guarded _SubmitStats.n_fast_path.
            # fedlint: unlocked-ok(local CoalesceResult, not shared state)
            self._count_drain(res.n_folded, res.n_fast_path)
            drained += res.n_folded

    # ---------------------------------------------------- secure aggregation
    def submit_secure(self, level: str, cluster_key: str | None,
                      client_id: str, round_id: int, masked_delta,
                      delta: UpdateDelta) -> int:
        """Queue one masked update for its round's secure drain.  The server
        never aggregates these individually — only ``drain_secure`` folds a
        full round, inside which the pairwise masks cancel."""
        key = self._key(level, cluster_key)
        rec = self._record(key)
        st = self._submit_stats(key)
        st.count_enqueue()          # before publish — see _SubmitStats
        with rec.pending_lock:
            bucket = rec.secure_pending.setdefault(round_id, [])
            bucket.append(PendingSecureUpdate(client_id, round_id,
                                              masked_delta, delta))
            depth = len(bucket)
        st.observe_depth(depth)
        return depth

    def drain_secure(self, level: str, cluster_key: str | None,
                     round_id: int, expected_ids) -> int:
        """Fold one secure round into a single fused N-way sum.

        ``expected_ids`` is the round's full member set; members that never
        submitted (dropouts) are recovered by reconstructing their stray
        pairwise masks from the pair seeds and subtracting them inside the
        same sum.  Returns the number of updates folded.
        """
        key = self._key(level, cluster_key)
        rec = self._record(key)
        with rec.lock:
            folded, recovered = _drain_secure_record(
                rec, key, round_id, expected_ids, self.masker, self.agg_cfg)
        if not folded:
            return 0
        self._count_drain(folded, 0, secure=True, recovered=recovered)
        return folded

    # ------------------------------------------------------------- inspection
    def coalesce_factor(self) -> float:
        """Mean queued-updates-per-drain — 1.0 means no batching benefit."""
        with self._drain_lock:
            if not self.n_drain_batches:
                return 0.0
            return self.n_drained / self.n_drain_batches


class ModelStore(_StoreBase):
    """Thread-safe store for global + cluster models: one submit-side stats
    sink, flat drains (the global tier is just another record)."""

    def __init__(self, init_params, cluster_keys=(),
                 agg_cfg: AggregationConfig = AggregationConfig(),
                 batch_aggregation: bool = False, max_coalesce: int = 16,
                 masker=None, drain_timeout_s: float = 30.0):
        super().__init__(init_params, cluster_keys, agg_cfg,
                         batch_aggregation, max_coalesce, masker,
                         drain_timeout_s)
        self._submit = _SubmitStats()

    def _submit_stats(self, key: str) -> _SubmitStats:
        return self._submit

    def _all_submit_stats(self) -> list:
        return [self._submit]

    def drain(self, level: str, cluster_key: str | None = None) -> int:
        """Fold all queued updates for one model, `max_coalesce` at a time,
        into single N-way aggregations.  Returns number of updates folded."""
        return self._drain_record(self._key(level, cluster_key))

    def drain_all(self) -> int:
        total = self.drain("global")
        for key in self.keys():
            total += self.drain("cluster", key)
        return total

    def agg_stats(self) -> dict:
        """The reference's single-store ``agg_stats`` keys, read as one
        consistent snapshot: drain counters first, then the submit sink."""
        with self._drain_lock:
            drain_updates = self._n_drain_updates
            drain_fast = self._n_drain_fast_path
            drain_batches = self.n_drain_batches
            coalesce = (self.n_drained / drain_batches) if drain_batches \
                else 0.0
            secure_rounds = self.n_secure_rounds
            secure_recoveries = self.n_secure_recoveries
            drain_timeouts = self.n_drain_timeouts
        direct, fast, lock_waits, enqueued, max_depth = self._submit.snapshot()
        updates = drain_updates + direct
        out = {
            "updates": updates,
            "fast_path_frac": (drain_fast + fast) / max(updates, 1),
            "lock_waits": lock_waits,
            "enqueued": enqueued,
            "drain_batches": drain_batches,
            "max_queue_depth": max_depth,
            "coalesce_factor": coalesce,
            "drain_timeouts": drain_timeouts,
        }
        if self.masker is not None:
            out["secure_rounds"] = secure_rounds
            out["secure_recoveries"] = secure_recoveries
        return out
