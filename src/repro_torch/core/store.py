"""Three-tier server model store (paper Fig. 1 + Algorithm 1 server side):
the single-lock ``ModelStore`` and the thread-sharded ``ShardedModelStore``.

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

Sharded mode (``ShardedModelStore``): the store partitions its cluster
models into K shards by a consistent-hash ring (``HashRing``, crc32 points,
never Python's randomized ``hash``), each shard with its own stats and, in
the threaded runtime, its own drain worker.  The global model is sharded at
the queue: submits land round-robin on per-shard slices and a drain folds
them two-level (``two_level_coalesced_aggregate``): one plan over the
seq-sorted concatenation, per-shard partials, one sample-weighted merge.
Secure rounds stay on the owning shard's record.

Stored parameters are never updated in place: a fold builds a new tree and
swaps it in, so a snapshot handed to a client stays as it was.
"""

from __future__ import annotations

import bisect
import itertools
import threading
import zlib
from collections import deque
from dataclasses import dataclass

from repro_torch.core.aggregation import (
    AggregationConfig,
    ModelMeta,
    UpdateDelta,
    aggregate_models,
    coalesced_aggregate,
    secure_coalesced_aggregate,
    two_level_coalesced_aggregate,
)

GLOBAL_KEY = "__global__"


def stable_shard(key: str, n_shards: int) -> int:
    """The modulo cluster-key -> shard map (crc32).  Kept as the
    reference keeps it, for the property tests that contrast it with the
    ring: live routing goes through ``HashRing.shard_of``, which carries
    the migration overrides."""
    if key == GLOBAL_KEY:
        return 0
    return zlib.crc32(str(key).encode()) % n_shards


class HashRing:
    """Consistent-hash ring with explicit ownership epochs: the routing
    authority of the sharded store.

    Each shard owns ``vnodes`` points on a 32-bit ring at the crc32
    positions of ``"s{shard}:{vnode}"``, so the base assignment is a pure
    function of (key, K, vnodes), the same in every process and under any
    ``PYTHONHASHSEED``, and equal to the reference's.  Live migration
    overlays the ring with an override table: ``assign(key, dst)`` bumps
    the monotone ``epoch`` and records ``key -> (dst, epoch)``.  The table
    is copy-on-write (replaced wholesale under ``_lock``), so routing reads
    take no lock.  The global model always routes to shard 0 and never
    migrates.
    """

    def __init__(self, n_shards: int, vnodes: int = 64):
        self.n_shards = max(int(n_shards), 1)
        self.vnodes = max(int(vnodes), 1)
        points = sorted(
            (zlib.crc32(f"s{shard}:{v}".encode()), shard)
            for shard in range(self.n_shards) for v in range(self.vnodes))
        self._hashes = [h for h, _ in points]
        self._points = [s for _, s in points]
        self._lock = threading.Lock()
        self._overrides: dict[str, tuple[int, int]] = {}  # key -> (dst, ep)
        self.epoch = 0

    def owner(self, key: str) -> int:
        """Pure ring position of a key; ignores migration overrides."""
        if key == GLOBAL_KEY:
            return 0
        i = bisect.bisect_right(self._hashes, zlib.crc32(str(key).encode()))
        return self._points[i % len(self._points)]

    def shard_of(self, key: str) -> int:
        """Current owner: the override table first, the ring otherwise."""
        if key == GLOBAL_KEY:
            return 0
        # fedlint: unlocked-ok(copy-on-write dict swapped wholesale under _lock)
        ov = self._overrides.get(str(key))
        return ov[0] if ov is not None else self.owner(key)

    def assign(self, key: str, dst: int) -> int:
        """Move a key's ownership to ``dst``; returns the bumped epoch.
        Every ``shard_of`` after the new table is published routes to the
        new owner."""
        key = str(key)
        dst = int(dst)
        if key == GLOBAL_KEY:
            raise ValueError("the global model is parent-owned and never "
                             "migrates")
        if not 0 <= dst < self.n_shards:
            raise ValueError(f"destination shard {dst} out of range "
                             f"[0, {self.n_shards})")
        with self._lock:
            self.epoch += 1
            updated = dict(self._overrides)
            updated[key] = (dst, self.epoch)
            self._overrides = updated          # atomic reference swap
            return self.epoch

    def overrides(self) -> dict:
        """Snapshot of the override table (``{key: (dst, epoch)}``)."""
        # fedlint: unlocked-ok(copy-on-write overrides snapshot read)
        return self._overrides


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

    def count_enqueue_many(self, n: int):
        # batched flavor of count_enqueue: same count-before-publish rule,
        # one lock round trip for the whole batch (submit_many)
        with self.lock:
            self.n_enqueued += n

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
    """Submit paths and per-record drains shared by both store flavors.

    The flavors disagree on exactly two things: which submit-side stats
    sink a model key bills to (``_submit_stats``) and how the global tier
    queues and drains.  Everything else lives here once, so the
    lock-ordering and count-before-publish rules cannot drift apart."""

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

    def _count_drain_timeout(self, shard: int | None = None):
        """Record a bounded-drain deadline miss.  ``shard`` names the
        worker where a topology attributes expiries to one; the in-thread
        stores keep one count."""
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
    def _enqueue_record(self, key: str, upd: PendingUpdate) -> int:
        rec = self._record(key)
        st = self._submit_stats(key)
        st.count_enqueue()          # before publish — see _SubmitStats
        with rec.pending_lock:
            rec.pending.append(upd)
            depth = len(rec.pending)
        st.observe_depth(depth)
        return depth

    def enqueue_update(self, level: str, cluster_key: str | None,
                       updated_params, updated_meta: ModelMeta,
                       delta: UpdateDelta) -> int:
        """Queue an update for a later coalesced drain; returns queue depth."""
        return self._enqueue_record(
            self._key(level, cluster_key),
            PendingUpdate(updated_params, updated_meta, delta))

    def submit_many(self, level: str, cluster_key: str | None,
                    updates) -> int:
        """Batched submit: ``updates`` is an iterable of ``(params, meta,
        delta)`` triples that all target one model.  In batched mode the
        whole list is appended under one queue-lock and stats round trip
        per destination queue (the fold is identical to N
        ``enqueue_update`` calls in the same order); in direct mode it is
        N sequential updates.  Returns the deepest queue touched (0 for
        the direct path)."""
        ups = updates if isinstance(updates, list) else list(updates)
        if not ups:
            return 0
        if self.batch_aggregation:
            return self._enqueue_many(level, cluster_key, ups)
        for p, m, d in ups:
            self.handle_model_update(level, cluster_key, p, m, d)
        return 0

    def _enqueue_many(self, level: str, cluster_key: str | None,
                      ups) -> int:
        """Flavor hook behind ``submit_many``: publish ``(params, meta,
        delta)`` triples to the destination queue(s).  The base path
        covers every record-queued key (the flat store, and the sharded
        store's cluster tier, whose ``_submit_stats`` routes the count to
        the owning shard)."""
        return self._enqueue_record_many(
            self._key(level, cluster_key),
            [PendingUpdate(p, m, d) for p, m, d in ups])

    def _enqueue_record_many(self, key: str, pend: list) -> int:
        rec = self._record(key)
        st = self._submit_stats(key)
        st.count_enqueue_many(len(pend))   # before publish — see _SubmitStats
        with rec.pending_lock:
            rec.pending.extend(pend)
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

    def sync_mirrors(self) -> int:
        """Mirror-staleness barrier.  In-thread stores hold the models
        directly, so there is nothing to sync (always 0); checkpoints call
        it first, as they do for the reference's process stores."""
        return 0


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

    def migrate_cluster(self, cluster_key: str, dst_shard: int) -> int:
        raise RuntimeError(
            "the flat ModelStore has no shards to migrate between — use a "
            "sharded topology (server_shards / server_processes / "
            "server_hosts)")

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


# =========================================================================
# Sharded store: per-cluster shards, two-level global fold
# =========================================================================


class _Shard:
    """One server slice: its slice of the global pending queue plus its own
    stats.  Cluster records owned by the shard keep their per-record
    queues; the shard only decides which drain worker sweeps them and which
    stats bucket counts them."""

    __slots__ = ("idx", "lock", "global_pending", "stats")

    def __init__(self, idx: int):
        self.idx = idx
        self.lock = threading.Lock()
        # FIFO slice of the global queue: (seq, PendingUpdate)
        self.global_pending: deque = deque()
        self.stats = _SubmitStats()


class ShardedModelStore(_StoreBase):
    """``ModelStore`` semantics partitioned into K shards.

    Cluster models are placed by a consistent-hash ring (``HashRing``);
    live migration (``migrate_cluster``) overlays epoch-stamped ownership
    overrides.  Submits to different clusters touch only their record's
    queue lock and their shard's stats lock (the registry and the ring's
    override table are copy-on-write, read without a lock); global submits
    are struck round-robin across per-shard queue slices with a monotone
    arrival ``seq``.

    ``drain_global`` folds every queued global slice two-level: one
    ``plan_coalesce`` walk over the seq-sorted concatenation fixes every
    update's convex coefficient (the flat fold's), each shard's members are
    reduced to convex partials and a sample-weighted merge reassembles the
    flat sum (``two_level_coalesced_aggregate``).  Every N-way sum is one
    fold kernel launch on CUDA.

    Secure aggregation stays model-local (masks cancel only inside one
    fused full-round sum), so ``drain_secure`` runs unchanged on the owning
    shard's record, and a dropout in one shard's round never touches
    another shard's state.
    """

    def __init__(self, init_params, cluster_keys=(),
                 agg_cfg: AggregationConfig = AggregationConfig(),
                 n_shards: int = 4, batch_aggregation: bool = False,
                 max_coalesce: int = 16, masker=None,
                 drain_timeout_s: float = 30.0, ring_vnodes: int = 64):
        self.n_shards = max(int(n_shards), 1)
        super().__init__(init_params, cluster_keys, agg_cfg,
                         batch_aggregation, max_coalesce, masker,
                         drain_timeout_s)
        self.ring = HashRing(self.n_shards, ring_vnodes)
        self.n_cluster_migrations = 0       # under the shared _drain_lock
        self._shards = [_Shard(i) for i in range(self.n_shards)]
        self._gseq = itertools.count()      # global-queue arrival order
        # two-level fold counters (under the shared _drain_lock)
        self.n_global_drains = 0
        self.n_global_partials = 0          # shard partials fed to merges

    # ------------------------------------------------------------------ keys
    def _submit_stats(self, key: str) -> _SubmitStats:
        return self._shards[self.shard_of(key)].stats

    def _all_submit_stats(self) -> list:
        return [s.stats for s in self._shards]

    def shard_of(self, key: str) -> int:
        """Current cluster-key -> shard owner: the ring plus any
        live-migration overrides (``HashRing.shard_of``)."""
        return self.ring.shard_of(key)

    def ownership_epoch(self) -> int:
        """Monotone epoch bumped by every ``migrate_cluster``."""
        # fedlint: unlocked-ok(monotone int; torn read returns a valid epoch)
        return self.ring.epoch

    def migrate_cluster(self, cluster_key: str, dst_shard: int) -> int:
        """Move one cluster model to another shard; returns the new
        ownership epoch.  Thread shards share the records, so the move is
        routing alone: holding ``rec.lock`` fences an in-flight drain of
        the record, and the next ``shard_cluster_keys`` sweep finds the key
        on its new shard."""
        key = self._key("cluster", cluster_key)
        rec = self._record(key)              # unknown cluster -> KeyError
        with rec.lock:
            epoch = self.ring.assign(key, int(dst_shard))
        with self._drain_lock:
            self.n_cluster_migrations += 1
        return epoch

    def shard_cluster_keys(self, shard: int):
        """Cluster keys owned by one shard (that shard's drain beat)."""
        # fedlint: unlocked-ok(copy-on-write registry snapshot read)
        return [k for k in self._records
                if k != GLOBAL_KEY and self.shard_of(k) == shard]

    # ------------------------------------------------------- batched updates
    def enqueue_update(self, level: str, cluster_key: str | None,
                       updated_params, updated_meta: ModelMeta,
                       delta: UpdateDelta) -> int:
        upd = PendingUpdate(updated_params, updated_meta, delta)
        key = self._key(level, cluster_key)
        if key != GLOBAL_KEY:
            return self._enqueue_record(key, upd)
        # global tier: strike a round-robin shard slice instead of the
        # record's own queue
        seq = next(self._gseq)
        sh = self._shards[seq % self.n_shards]
        sh.stats.count_enqueue()    # before publish — see _SubmitStats
        with sh.lock:
            sh.global_pending.append((seq, upd))
            depth = len(sh.global_pending)
        sh.stats.observe_depth(depth)
        return depth

    def _enqueue_many(self, level: str, cluster_key: str | None,
                      ups) -> int:
        key = self._key(level, cluster_key)
        if key != GLOBAL_KEY:
            return super()._enqueue_many(level, cluster_key, ups)
        # global tier: scatter the batch round-robin across shard slices in
        # one pass, in arrival seq order (the two-level fold sorts by seq,
        # so the fold is that of N single enqueues)
        per: list[list] = [[] for _ in range(self.n_shards)]
        for p, m, d in ups:
            seq = next(self._gseq)
            per[seq % self.n_shards].append((seq, PendingUpdate(p, m, d)))
        depth = 0
        for sh, items in zip(self._shards, per, strict=True):
            if not items:
                continue
            sh.stats.count_enqueue_many(len(items))  # before publish
            with sh.lock:
                sh.global_pending.extend(items)
                d2 = len(sh.global_pending)
            sh.stats.observe_depth(d2)
            depth = max(depth, d2)
        return depth

    def pending_depth(self, level: str, cluster_key: str | None = None) -> int:
        if self._key(level, cluster_key) == GLOBAL_KEY:
            total = 0
            for sh in self._shards:
                with sh.lock:
                    total += len(sh.global_pending)
            return total
        return super().pending_depth(level, cluster_key)

    def effective_round(self, level: str, cluster_key: str | None = None) -> int:
        """Round including queued and in-flight updates, as
        ``ModelStore.effective_round``.  For the global tier the shard
        slices are summed under the record's pending_lock, which every
        global drain also holds while popping, so a reader never catches a
        drain between pop and publish."""
        key = self._key(level, cluster_key)
        if key != GLOBAL_KEY:
            return super().effective_round(level, cluster_key)
        rec = self._record(key)
        with rec.pending_lock:
            queued = 0
            for sh in self._shards:
                with sh.lock:
                    queued += sum(u.delta.rounds
                                  for _, u in sh.global_pending)
            return rec.meta.round + queued + rec.inflight_rounds

    # ------------------------------------------------------------ drains
    def drain(self, level: str, cluster_key: str | None = None) -> int:
        key = self._key(level, cluster_key)
        if key == GLOBAL_KEY:
            return self.drain_global()
        return self._drain_record(key)

    def drain_global(self) -> int:
        """Two-level global fold: pop every shard slice (seq-tagged), plan
        once over the seq-sorted concatenation, reduce per-shard partials,
        merge sample-weighted.  One call drains the whole global queue; the
        sums are arity-bounded by ``max_coalesce``.  A fold that raises
        puts the slices back (seq tags intact, FIFO per shard), retires the
        in-flight rounds and re-raises."""
        rec = self._record(GLOBAL_KEY)
        with rec.lock:
            with rec.pending_lock:
                batches, seqs, total_rounds = [], [], 0
                for sh in self._shards:
                    with sh.lock:
                        items = list(sh.global_pending)
                        sh.global_pending.clear()
                    seqs.append([s for s, _ in items])
                    batches.append([(u.params, u.meta, u.delta)
                                    for _, u in items])
                    total_rounds += sum(u.delta.rounds for _, u in items)
                rec.inflight_rounds += total_rounds
            n = sum(len(b) for b in batches)
            if n == 0:
                with rec.pending_lock:
                    rec.inflight_rounds -= total_rounds
                return 0
            try:
                res = two_level_coalesced_aggregate(
                    rec.params, rec.meta, batches, self.agg_cfg,
                    seqs=seqs, max_width=self.max_coalesce)
            except BaseException:
                with rec.pending_lock:
                    for sh, batch, sq in zip(self._shards, batches, seqs,
                                             strict=True):
                        items = [(s, PendingUpdate(*u))
                                 for s, u in zip(sq, batch, strict=True)]
                        with sh.lock:
                            sh.global_pending.extendleft(reversed(items))
                    rec.inflight_rounds -= total_rounds
                raise
            with rec.pending_lock:
                rec.swap(res.params, res.meta)
                rec.inflight_rounds -= total_rounds
        with self._drain_lock:
            self._n_drain_updates += n
            self._n_drain_fast_path += res.n_fast_path
            self.n_drain_batches += 1
            self.n_drained += n
            self.n_global_drains += 1
            self.n_global_partials += res.n_partials
        return n

    def drain_shard(self, shard: int) -> int:
        """One drain worker's beat: every cluster model the shard owns.
        The global queue is drained by ``drain_global``, since its
        two-level fold spans every shard's slice."""
        total = 0
        for key in self.shard_cluster_keys(shard):
            total += self._drain_record(key)
        return total

    def drain_all(self) -> int:
        total = self.drain_global()
        for shard in range(self.n_shards):
            total += self.drain_shard(shard)
        return total

    def agg_stats(self) -> dict:
        with self._drain_lock:
            migrations = self.n_cluster_migrations
        return _sharded_agg_stats(self, self._shards,
                                  # fedlint: unlocked-ok(monotone epoch stat)
                                  extra={"ownership_epoch": self.ring.epoch,
                                         "cluster_migrations": migrations})


def _sharded_agg_stats(store, shards, extra: dict | None = None) -> dict:
    """The sharded store's ``agg_stats``: the flat store's keys plus
    ``shards``, ``global_drains``, ``global_partials`` and
    ``shard_enqueued``, in the reference's layout.

    Snapshot order matters: drain counters first, then each shard's
    counters as one locked read.  Enqueues are counted before publish and
    folds happen after it, so every snapshot keeps updates <= enqueued and
    fast_path_frac <= 1."""
    with store._drain_lock:
        drain_updates = store._n_drain_updates
        drain_fast = store._n_drain_fast_path
        drain_batches = store.n_drain_batches
        drain = {
            "drain_batches": drain_batches,
            "coalesce_factor": (store.n_drained / drain_batches)
            if drain_batches else 0.0,
            "global_drains": store.n_global_drains,
            "global_partials": store.n_global_partials,
            "secure_rounds": store.n_secure_rounds,
            "secure_recoveries": store.n_secure_recoveries,
            "drain_timeouts": store.n_drain_timeouts,
        }
    updates, fast, lock_waits, enqueued, max_depth = 0, 0, 0, 0, 0
    shard_enqueued = []
    for s in shards:
        u, f, lw, enq, depth = s.stats.snapshot()
        updates += u
        fast += f
        lock_waits += lw
        enqueued += enq
        max_depth = max(max_depth, depth)
        shard_enqueued.append(enq)
    updates += drain_updates
    fast += drain_fast
    out = {
        "updates": updates,
        "fast_path_frac": fast / max(updates, 1),
        "lock_waits": lock_waits,
        "enqueued": enqueued,
        "drain_batches": drain["drain_batches"],
        "max_queue_depth": max_depth,
        "coalesce_factor": drain["coalesce_factor"],
        "drain_timeouts": drain["drain_timeouts"],
        "shards": store.n_shards,
        "global_drains": drain["global_drains"],
        "global_partials": drain["global_partials"],
        "shard_enqueued": shard_enqueued,
    }
    if extra:
        out.update(extra)
    if store.masker is not None:
        out["secure_rounds"] = drain["secure_rounds"]
        out["secure_recoveries"] = drain["secure_recoveries"]
    return out
