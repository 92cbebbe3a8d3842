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

Process-sharded mode (``ProcessShardedModelStore``): the same K-shard
topology with every shard promoted to a worker (``repro_torch.core.
server_proc``): a spawned process, a standalone TCP shard server
(``server_hosts``) or, under the sim runtime, the deterministic in-process
emulation.  Submits cross per-shard msgpack queues, cluster folds run in
the workers (on the ``fedavg_agg`` kernel when the worker's device is
CUDA), and the global model merges by a cross-server plan, partial and
merge split of the same two-level algebra.  The parent journals every
update until its fold is acked, so a crashed or stuck worker is respawned
and replayed without losing updates or counting rounds twice.

Every store flavour serves conditional fetches (``fetch_wire``) through a
version-keyed wire cache (``repro_torch.core.fetch``).

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

from repro_torch.checkpoint.msgpack_ckpt import unpackb
from repro_torch.core import server_proc, transport
from repro_torch.core.aggregation import (
    AggregationConfig,
    ModelMeta,
    UpdateDelta,
    aggregate_models,
    chunked_convex_reduce,
    coalesced_aggregate,
    multi_aggregate,
    plan_coalesce,
    secure_coalesced_aggregate,
    two_level_coalesced_aggregate,
)
from repro_torch.core.fetch import WireCache, serve_fetch
from repro_torch.core.server_proc import (
    delta_from_wire,
    delta_to_wire,
    meta_from_wire,
    meta_to_wire,
)
from repro_torch.utils.device import resolve_device

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
        # shared by fetch_wire() across every store flavour
        self._wire_cache = WireCache()

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

    def fetch_wire(self, level: str, cluster_key: str | None = None,
                   held=None):
        """Parent-served conditional fetch: ``(result, payload, meta_wire)``
        with a shard server's ``fetch`` semantics (``serve_fetch``): a
        not-modified ack when the client's held ``[samples, epochs,
        round]`` is current, a delta when the held version is cached, else
        the full packed snapshot, serialized once per version."""
        params, meta = self.request_model(level, cluster_key)
        meta_w = meta_to_wire(meta)
        kind, payload = serve_fetch(self._wire_cache,
                                    self._key(level, cluster_key),
                                    params, meta_w, held)
        return kind, payload, meta_w

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
                     recovered: int = 0, batches: int = 1):
        """Count a drain; one worker reply's folds may span ``batches``."""
        with self._drain_lock:
            self._n_drain_updates += folded
            self._n_drain_fast_path += fast
            self.n_drain_batches += batches
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


# =========================================================================
# Process-sharded store: shard servers as workers
# =========================================================================


class _JournalEntry:
    """One unacked update the parent still owns.  ``raw`` is the exact wire
    message sent to the worker, so a respawn replays it byte for byte.
    ``custody`` marks global updates whose payload a ``greduce`` reply has
    handed back: a replay skips them, or the in-flight merge would count
    them twice."""

    __slots__ = ("kind", "key", "rounds", "raw", "custody")

    def __init__(self, kind: str, key: str, rounds: int, raw: bytes):
        self.kind = kind          # "sub" | "gsub" | "secure"
        self.key = key
        self.rounds = rounds
        self.raw = raw
        self.custody = False


class _ProcShard:
    """Parent-side bookkeeping for one worker: its transport, submit stats
    and the journal of unacked updates (the replay source).  ``rpc_lock``
    serializes replying commands and respawns; ``journal_lock`` is the leaf
    lock over the journal, the per-key counters, the outbox and the lazy
    sync state."""

    __slots__ = ("idx", "stats", "handle", "rpc_lock", "journal",
                 "journal_lock", "pending_counts", "pending_rounds",
                 "secure_counts", "outbox", "dirty", "deferred",
                 "replicas", "replica_pushes", "replica_drops")

    def __init__(self, idx: int):
        self.idx = idx
        self.stats = _SubmitStats()
        self.handle = None
        self.replicas: list = []          # read-replica transports (TCP)
        self.replica_pushes = 0           # mirror pushes delivered
        self.replica_drops = 0            # pushes skipped (replica down)
        self.rpc_lock = threading.RLock()
        self.journal: dict[int, _JournalEntry] = {}     # seq -> entry
        self.journal_lock = threading.Lock()
        self.pending_counts: dict[str, int] = {}        # key -> unacked subs
        self.pending_rounds: dict[str, int] = {}        # key -> their rounds
        self.secure_counts: dict[tuple, int] = {}       # (key, round) -> n
        self.outbox: list = []                          # unflushed raw msgs
        # lazy mirror sync: keys whose worker params are ahead of the
        # mirror (meta-only acks received), and the drain stats deferred
        # until their params land
        self.dirty: set[str] = set()
        self.deferred: dict[str, list] = {}   # key -> [folded, fast, batches]


class ProcessShardedModelStore(_StoreBase):
    """``ShardedModelStore`` semantics with every shard promoted to a
    worker: a spawned process (``inprocess=False``), the deterministic
    in-process emulation (``inprocess=True``, the sim runtime's) or a
    standalone TCP shard server per entry of ``server_hosts``.

    The parent keeps the authoritative registry (reads are parent-local
    snapshots on ``device``) and a per-shard journal of unacked updates.
    Each worker owns working copies of its shard's cluster models, their
    queues and secure-round buckets, and its slice of the global queue,
    and folds them on its own device.  A submit is serialized once and
    queued on its shard without blocking; a drain RPC makes the worker fold
    and ship ``(params, meta)`` back, which the parent swaps into its
    mirror and acks against the journal in one step.

    The global model folds by a cross-server two-level merge: the parent
    gathers every worker's slice metadata (``gmeta``), plans once over the
    seq-sorted concatenation, each worker reduces its own members to one
    convex partial (``greduce``), and a mass-weighted merge of the K
    partials in the parent gives the flat fold's sum.

    A worker that dies or misses ``drain_timeout_s`` is respawned from the
    parent's mirrors and its journal replayed (``drain_timeouts`` and
    ``respawns`` in ``agg_stats()``).  Secure rounds of a cluster model fold
    inside its worker; the global model's secure rounds fold in the parent.
    ``mirror_sync_every=N`` ships params with every Nth drain reply only;
    reads, checkpoints and ``close`` sync dirty mirrors first
    (``sync_mirrors``).

    ``device`` (``None``: CUDA) is where the parent decodes replies and,
    for the spawned and in-process flavours, where the workers fold; a TCP
    server folds on the device it was started with.  Before spawning CUDA
    workers the parent builds the kernel library, so the children only
    load it.

    ``server_hosts`` entries may name read replicas, ``"owner|replica"``:
    the owner folds, the parent pushes each folded mirror to the replicas,
    and fetch clients round-robin over all of them.
    """

    # drains are scatter-gather beats: the threaded runtime runs one pump
    # calling drain_all() (the parallelism lives in the workers)
    scatter_drains = True

    # extra reply allowance for the command retried after a respawn
    SPAWN_ALLOWANCE_S = 60.0

    # submits coalesce into one queue message per shard; every RPC flushes
    # first, which keeps the command queue's FIFO order
    FLUSH_N = 8

    def __init__(self, init_params, cluster_keys=(),
                 agg_cfg: AggregationConfig = AggregationConfig(),
                 n_shards: int = 4, batch_aggregation: bool = True,
                 max_coalesce: int = 16, masker=None,
                 drain_timeout_s: float = 30.0, inprocess: bool = False,
                 server_hosts=None, mirror_sync_every: int = 1,
                 ring_vnodes: int = 64, device=None):
        if server_hosts:
            owners, replicas = [], []
            for h in server_hosts:
                parts = [p for p in
                         (s.strip() for s in str(h).split("|")) if p]
                owners.append(transport.parse_host(parts[0]))
                replicas.append([transport.parse_host(p)
                                 for p in parts[1:]])
            self.server_hosts = owners
            self.replica_hosts = replicas if any(replicas) else None
            n_shards = len(self.server_hosts)
        else:
            self.server_hosts = None
            self.replica_hosts = None
        self.n_shards = max(int(n_shards), 1)
        super().__init__(init_params, cluster_keys, agg_cfg,
                         batch_aggregation, max_coalesce, masker,
                         drain_timeout_s)
        self.device = resolve_device(device)
        self.inprocess = bool(inprocess) and self.server_hosts is None
        self.mirror_sync_every = max(int(mirror_sync_every), 1)
        self.ring = HashRing(self.n_shards, ring_vnodes)
        self.n_cluster_migrations = 0     # under the shared _drain_lock
        self._gseq = itertools.count()
        self.n_global_drains = 0
        self.n_global_partials = 0
        self.n_respawns = 0
        self.n_mirror_syncs = 0           # explicit sync RPCs issued
        self.n_shard_drain_timeouts = [0] * self.n_shards
        self._closed = False
        if (self.server_hosts is None and not self.inprocess
                and self.device.type == "cuda"):
            from repro_torch.kernels import build

            build.build()          # children load it; none runs nvcc
        self._proc_shards = [_ProcShard(i) for i in range(self.n_shards)]
        try:
            for sh in self._proc_shards:
                sh.handle = self._make_handle(sh.idx)
            for sh in self._proc_shards:
                wait = getattr(sh.handle, "wait_ready", None)
                if wait is not None:
                    wait()         # cold starts overlap across workers
                if self.replica_hosts:
                    # replicas start from the owner's seed, then receive
                    # only `mirror` pushes
                    for addr in self.replica_hosts[sh.idx]:
                        sh.replicas.append(transport.TcpWorkerHandle(
                            sh.idx, self._seed_blob(sh.idx), addr,
                            connect_timeout=max(self.drain_timeout_s, 10.0)))
        except BaseException:
            for sh in self._proc_shards:
                for h in [sh.handle, *sh.replicas]:
                    if h is not None:
                        h.discard()
            raise

    def _decode(self, raw: bytes):
        """A worker's reply with its arrays as tensors on ``device``."""
        return unpackb(raw, self.device)

    # --------------------------------------------------------------- lifecycle
    def _make_handle(self, shard_idx: int) -> transport.Transport:
        blob = self._seed_blob(shard_idx)
        if self.server_hosts is not None:
            return transport.TcpWorkerHandle(
                shard_idx, blob, self.server_hosts[shard_idx],
                connect_timeout=max(self.drain_timeout_s, 10.0))
        cls = (server_proc.InprocessWorkerHandle if self.inprocess
               else server_proc.ProcessWorkerHandle)
        return cls(shard_idx, blob, self.device)

    def _seed_blob(self, shard_idx: int) -> bytes:
        recs = []
        for key in self.shard_cluster_keys(shard_idx):
            # fedlint: unlocked-ok(copy-on-write registry snapshot read)
            params, meta = self._records[key].snapshot()
            recs.append((key, params, meta))
        # every worker learns where migrated-away keys live, so a respawned
        # ex-owner keeps answering redirects
        migrated = {key: [dst, ep]
                    for key, (dst, ep) in self.ring.overrides().items()
                    if dst != shard_idx}
        return server_proc.make_seed_blob(recs, self.max_coalesce,
                                          self.agg_cfg, self.masker,
                                          self.mirror_sync_every, None,
                                          # fedlint: unlocked-ok(monotone epoch; seed built under rpc_lock)
                                          epoch=self.ring.epoch,
                                          migrated=migrated)

    def close(self, timeout: float | None = None):
        """Stop every worker with a bounded join (TCP sessions end and the
        servers go back to accepting), after syncing dirty mirrors.
        Idempotent; undrained updates stay journaled in the parent."""
        if self._closed:
            return
        try:
            self.sync_mirrors()
        except (RuntimeError, OSError):
            pass                  # a dead worker's folds are replay-covered
        self._closed = True
        t = self.drain_timeout_s if timeout is None else float(timeout)
        for sh in self._proc_shards:
            with sh.rpc_lock:
                for h in [sh.handle, *sh.replicas]:
                    try:
                        h.stop(min(t, 10.0))
                    except (RuntimeError, OSError):
                        h.discard()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def worker_spawns(self) -> list:
        """Per-shard spawn counts (1 = never respawned)."""
        return [sh.handle.spawns for sh in self._proc_shards]

    def _debug_kill_worker(self, shard: int):
        """Crash injection (tests): kill a worker; the next drain touching
        the shard detects it and respawns."""
        self._proc_shards[shard].handle.kill()

    # ------------------------------------------------------------------ keys
    def _submit_stats(self, key: str) -> _SubmitStats:
        return self._proc_shards[self.shard_of(key)].stats

    def _all_submit_stats(self) -> list:
        return [s.stats for s in self._proc_shards]

    def shard_of(self, key: str) -> int:
        """The ring assignment ``ShardedModelStore.shard_of`` uses."""
        return self.ring.shard_of(key)

    def ownership_epoch(self) -> int:
        """Monotone epoch bumped by every ``migrate_cluster``."""
        # fedlint: unlocked-ok(monotone int; torn read returns a valid epoch)
        return self.ring.epoch

    def shard_cluster_keys(self, shard: int):
        # fedlint: unlocked-ok(copy-on-write registry snapshot read)
        return [k for k in self._records
                if k != GLOBAL_KEY and self.shard_of(k) == shard]

    def ensure_cluster(self, cluster_key: str, init_params=None):
        key = str(cluster_key)
        with self._registry_lock:
            if key in self._records:
                return
            seed = (init_params if init_params is not None
                    else self._records[GLOBAL_KEY].params)
            updated = dict(self._records)
            updated[key] = ModelRecord(seed)
            self._records = updated
        # the queue's FIFO order makes the worker register the model before
        # any later update for it
        while True:
            idx = self.shard_of(key)
            sh = self._proc_shards[idx]
            with sh.journal_lock:
                if self.shard_of(key) != idx:
                    continue    # migration fenced this key mid-publish
                raw = server_proc.packb(["ensure", key, seed,
                                         self.ring.epoch])
                self._outbox_put(sh, raw)
            break
        for h in sh.replicas:       # replicas must serve the key too
            if h.alive():
                h.put(raw)

    # ------------------------------------------------------- submit paths
    def handle_model_update(self, level: str, cluster_key: str | None,
                            updated_params, updated_meta: ModelMeta,
                            delta: UpdateDelta, *, blocking: bool = True) -> bool:
        """Every update crosses to a worker, so the store queues even
        unbatched: a non-batched config drains right after the enqueue (a
        coalesced fold of one update, Algorithm 2's result)."""
        self.enqueue_update(level, cluster_key, updated_params, updated_meta,
                            delta)
        if not self.batch_aggregation:
            self.drain(level, cluster_key)
        return True

    def enqueue_update(self, level: str, cluster_key: str | None,
                       updated_params, updated_meta: ModelMeta,
                       delta: UpdateDelta) -> int:
        key = self._key(level, cluster_key)
        seq = next(self._gseq)
        if key == GLOBAL_KEY:
            # global tier: a round-robin worker slice (the two-level fold
            # sorts by seq, so the slice is free)
            sh = self._proc_shards[seq % self.n_shards]
            raw = server_proc.packb(
                ["gsub", seq, updated_params, meta_to_wire(updated_meta),
                 delta_to_wire(delta)])
            sh.stats.count_enqueue()    # before publish — see _SubmitStats
            with sh.journal_lock:
                sh.journal[seq] = _JournalEntry("gsub", key, delta.rounds,
                                                raw)
                sh.pending_counts[key] = sh.pending_counts.get(key, 0) + 1
                sh.pending_rounds[key] = \
                    sh.pending_rounds.get(key, 0) + delta.rounds
                depth = sh.pending_counts[key]
                self._outbox_put(sh, raw)
        else:
            self._record(key)          # unknown cluster -> KeyError, as flat
            meta_w = meta_to_wire(updated_meta)
            delta_w = delta_to_wire(delta)
            while True:
                idx = self.shard_of(key)
                sh = self._proc_shards[idx]
                with sh.journal_lock:
                    if self.shard_of(key) != idx:
                        # a migration fenced this key between the route
                        # read and the journal lock: reroute
                        continue
                    # counted once, on the shard that takes it, and before
                    # publish (see _SubmitStats); the reference counts
                    # before the fence check, once per reroute
                    sh.stats.count_enqueue()
                    raw = server_proc.packb(
                        ["sub", seq, key, updated_params, meta_w, delta_w,
                         self.ring.epoch])
                    sh.journal[seq] = _JournalEntry("sub", key, delta.rounds,
                                                    raw)
                    sh.pending_counts[key] = sh.pending_counts.get(key, 0) + 1
                    sh.pending_rounds[key] = \
                        sh.pending_rounds.get(key, 0) + delta.rounds
                    depth = sh.pending_counts[key]
                    self._outbox_put(sh, raw)
                break
        sh.stats.observe_depth(depth)
        return depth

    def _enqueue_many(self, level: str, cluster_key: str | None,
                      ups) -> int:
        # every update is journaled on its own (replay is per entry); the
        # outbox already batches them onto the wire
        depth = 0
        for p, m, d in ups:
            depth = self.enqueue_update(level, cluster_key, p, m, d)
        return depth

    def pending_depth(self, level: str, cluster_key: str | None = None) -> int:
        key = self._key(level, cluster_key)
        if key == GLOBAL_KEY:
            total = 0
            for sh in self._proc_shards:
                with sh.journal_lock:
                    total += sh.pending_counts.get(GLOBAL_KEY, 0)
            return total
        sh = self._proc_shards[self.shard_of(key)]
        with sh.journal_lock:
            return sh.pending_counts.get(key, 0)

    def effective_round(self, level: str, cluster_key: str | None = None) -> int:
        """The journal holds every queued and in-flight update, and acks
        land in the section that swaps the folded meta in, so the round
        never appears to go back mid-drain."""
        key = self._key(level, cluster_key)
        rec = self._record(key)
        if key == GLOBAL_KEY:
            with rec.pending_lock:
                queued = 0
                for sh in self._proc_shards:
                    with sh.journal_lock:
                        queued += sh.pending_rounds.get(GLOBAL_KEY, 0)
                return rec.meta.round + queued
        sh = self._proc_shards[self.shard_of(key)]
        with sh.journal_lock:
            return rec.meta.round + sh.pending_rounds.get(key, 0)

    # ---------------------------------------------------------------- drains
    @staticmethod
    def _ack(sh: _ProcShard, seqs):
        """Retire acked journal entries.  Caller holds ``sh.journal_lock``
        and has applied the fold they belong to."""
        for seq in seqs:
            e = sh.journal.pop(seq, None)
            if e is None:
                continue
            if e.kind in ("sub", "gsub"):
                sh.pending_counts[e.key] = sh.pending_counts.get(e.key, 1) - 1
                sh.pending_rounds[e.key] = \
                    sh.pending_rounds.get(e.key, e.rounds) - e.rounds

    def _respawn(self, sh: _ProcShard):
        """Replace a dead or stuck worker: ``restart`` resets it from the
        parent's mirrors, then the journal is replayed in seq order
        (entries in the parent's custody skipped).  Folded-but-unsynced
        entries are still journaled, so the replay refolds them and their
        deferred stats are dropped here.  Caller holds ``sh.rpc_lock``."""
        with sh.journal_lock:
            sh.outbox = []     # journaled (subs) or registry-derived (ensure)
            sh.dirty.clear()   # a reseeded worker equals the mirror
            sh.deferred.clear()
            sh.handle.restart(self._seed_blob(sh.idx))
            for seq in sorted(sh.journal):
                e = sh.journal[seq]
                if not e.custody:
                    self._outbox_put(sh, e.raw)
            self._flush_outbox(sh)
        with self._drain_lock:
            self.n_respawns += 1

    def _flush_outbox(self, sh: _ProcShard):
        """Ship the shard's buffered fire-and-forget messages as one batch.
        Caller holds ``sh.journal_lock``."""
        if not sh.outbox:
            return
        if len(sh.outbox) == 1:
            sh.handle.put(sh.outbox[0])
        else:
            sh.handle.put(server_proc.packb(["batch", sh.outbox]))
        sh.outbox = []

    def _outbox_put(self, sh: _ProcShard, raw: bytes):
        """Buffer one fire-and-forget message, flushing at ``FLUSH_N``.
        Caller holds ``sh.journal_lock``."""
        sh.outbox.append(raw)
        if len(sh.outbox) >= self.FLUSH_N:
            self._flush_outbox(sh)

    def _exchange(self, sh: _ProcShard, raw: bytes,
                  timeout: float | None = None):
        """Send one replying command and decode its reply; on
        ``WorkerUnavailable`` respawn (journal replay) and retry once.
        Caller holds ``sh.rpc_lock``."""
        timeout = self.drain_timeout_s if timeout is None else timeout
        for attempt in (0, 1):
            try:
                return self._decode(sh.handle.rpc(raw, timeout))
            except transport.WorkerUnavailable as e:
                if isinstance(e, transport.WorkerTimeout):
                    self._count_drain_timeout(sh.idx)
                self._respawn(sh)
                timeout = self.drain_timeout_s + self.SPAWN_ALLOWANCE_S
                if attempt:
                    raise RuntimeError(
                        f"shard {sh.idx} worker unavailable even after "
                        f"respawn: {e}") from e

    @staticmethod
    def _check_error(sh: _ProcShard, reply):
        if reply[0] == "error":
            raise RuntimeError(
                f"shard {sh.idx} worker error on {reply[1]!r}: {reply[2]}")

    def _rpc(self, sh: _ProcShard, raw: bytes, on_reply):
        """One replying worker command; ``on_reply`` runs inside the
        critical section, so its acks and custody marks are visible before
        a later respawn could replay what it consumed."""
        with sh.rpc_lock:
            with sh.journal_lock:
                self._flush_outbox(sh)
            reply = self._exchange(sh, raw)
            self._check_error(sh, reply)
            return on_reply(reply)

    def _scatter_gather(self, raws, on_reply) -> list:
        """Send one replying command to every worker, then gather: the K
        folds run at once while the parent waits once.  ``raws`` is one
        command for all shards or one per shard.  Holds every shard's rpc
        lock (index order); a shard that crashes is respawned and retried
        alone.  Returns ``on_reply(sh, reply)`` per shard."""
        if isinstance(raws, bytes):
            raws = [raws] * self.n_shards
        if self.inprocess:
            # the emulation dispatches inline: a sequential sweep
            return [self._rpc(sh, raw, lambda reply, sh=sh: on_reply(sh, reply))
                    for sh, raw in zip(self._proc_shards, raws, strict=True)]
        for sh in self._proc_shards:
            sh.rpc_lock.acquire()
        try:
            for sh, raw in zip(self._proc_shards, raws, strict=True):
                with sh.journal_lock:
                    self._flush_outbox(sh)
                sh.handle.put(raw)               # scatter: no waiting yet
            out = []
            for sh, raw in zip(self._proc_shards, raws, strict=True):
                try:
                    reply = self._decode(
                        sh.handle.rpc_recv(self.drain_timeout_s))
                except transport.WorkerUnavailable as e:
                    if isinstance(e, transport.WorkerTimeout):
                        self._count_drain_timeout(sh.idx)
                    self._respawn(sh)
                    reply = self._exchange(        # journal replayed
                        sh, raw,
                        self.drain_timeout_s + self.SPAWN_ALLOWANCE_S)
                self._check_error(sh, reply)
                out.append(on_reply(sh, reply))
            return out
        finally:
            for sh in self._proc_shards:
                sh.rpc_lock.release()

    def _push_replicas(self, sh: _ProcShard, key: str, params, meta_w):
        """Best-effort ``mirror`` push to the shard's read replicas after a
        mirror swap.  A dead replica drops pushes and gets a throttled
        reconnect, whose re-seed resyncs every key it missed.  Callers hold
        ``sh.rpc_lock``, never ``journal_lock``."""
        if not sh.replicas:
            return
        raw = server_proc.packb(["mirror", key, params, meta_w])
        for h in sh.replicas:
            if h.alive():
                h.put(raw)
                sh.replica_pushes += 1
                continue
            sh.replica_drops += 1
            if sh.replica_drops % 32 == 1:
                try:
                    h.restart(self._seed_blob(sh.idx))
                    h.put(raw)
                    sh.replica_pushes += 1
                except (transport.WorkerUnavailable, OSError):
                    h.discard()

    def _apply_drained(self, sh: _ProcShard, reply) -> int:
        _, key, folded, fast, batches, acked, params, meta_w = reply
        if not folded:
            return 0
        rec = self._record(key)
        if params is None:
            # meta-only ack (lazy sync): keep the entries journaled, mark
            # the mirror dirty, defer the stats until the params land
            with sh.journal_lock:
                sh.dirty.add(key)
                d = sh.deferred.setdefault(key, [0, 0, 0])
                d[0] += folded
                d[1] += fast
                d[2] += batches
            return folded
        with sh.journal_lock:
            rec.swap(params, meta_from_wire(meta_w))
            self._ack(sh, acked)     # flushes earlier meta-only acks too
            sh.dirty.discard(key)
            dfolded, dfast, dbatches = sh.deferred.pop(key, (0, 0, 0))
        self._push_replicas(sh, key, params, meta_w)
        self._count_drain(folded + dfolded, fast + dfast,
                          batches=batches + dbatches)
        return folded

    def drain(self, level: str, cluster_key: str | None = None) -> int:
        key = self._key(level, cluster_key)
        if key == GLOBAL_KEY:
            return self.drain_global()
        sh = self._proc_shards[self.shard_of(key)]
        return self._rpc(sh, server_proc.packb(["drain", key]),
                         lambda reply: self._apply_drained(sh, reply))

    def _apply_shard_beat(self, sh: _ProcShard, reply) -> int:
        """Apply one ``shard_drained`` reply: each key's folded state
        swapped into its mirror and acked."""
        total = 0
        for per_key in reply[1]:
            total += self._apply_drained(sh, ["drained"] + list(per_key))
        return total

    def drain_shard(self, shard: int) -> int:
        """One drain beat for a whole worker: every cluster model it owns,
        folded in one round trip."""
        sh = self._proc_shards[shard]
        return self._rpc(sh, server_proc.packb(["drain_shard"]),
                         lambda reply: self._apply_shard_beat(sh, reply))

    def _abort_global_drain(self):
        """Undo a half-done cross-server merge: clear custody so the
        journal is authoritative again, then respawn every worker (nothing
        was acked, so the replay restores each slice)."""
        for sh in self._proc_shards:
            with sh.journal_lock:
                for e in sh.journal.values():
                    e.custody = False
            with sh.rpc_lock:
                self._respawn(sh)

    def drain_global(self) -> int:
        """Cross-server two-level merge: gather every server's slice
        metadata (``gmeta``), plan once over the seq-sorted concatenation
        (the flat fold's coefficients), let each worker reduce its members
        to one convex partial (``greduce``: only K partials cross the
        wire), then merge them mass-weighted in the parent."""
        rec = self._record(GLOBAL_KEY)
        with rec.lock:
            metas = self._scatter_gather(server_proc.packb(["gmeta"]),
                                         lambda sh, reply: reply[1])
            flat = sorted((int(it[0]), k, meta_from_wire(it[1]),
                           delta_from_wire(it[2]))
                          for k, items in enumerate(metas) for it in items)
            n = len(flat)
            if n == 0:
                return 0
            plan = plan_coalesce(rec.meta, [(m, d) for _, _, m, d in flat],
                                 self.agg_cfg)
            by_shard: dict[int, list] = {k: [] for k in range(self.n_shards)}
            for (seq, k, _, _), w in zip(flat, plan.weights[1:], strict=True):
                by_shard[k].append([seq, w])
            try:
                # custody marks the reduced entries, so a concurrent
                # respawn cannot replay them while the merge is in flight
                def collect(sh, reply):
                    with sh.journal_lock:
                        for seq in reply[1]:
                            e = sh.journal.get(int(seq))
                            if e is not None:
                                e.custody = True
                    return reply
                raws = [server_proc.packb(["greduce", by_shard[k]])
                        for k in range(self.n_shards)]
                replies = self._scatter_gather(raws, collect)
                acked = [[int(s) for s in reply[1]] for reply in replies]
                partials = [(reply[3], reply[2]) for reply in replies
                            if reply[3] is not None and reply[2] > 0.0]
                base_w = plan.weights[0]
                entries = (([(rec.params, base_w)] if base_w != 0.0 else [])
                           + partials)
                if not entries:
                    new_params = rec.params
                else:
                    entries = chunked_convex_reduce(entries,
                                                    self.max_coalesce,
                                                    self.agg_cfg)
                    new_params = (entries[0][0] if len(entries) == 1 else
                                  multi_aggregate([p for p, _ in entries],
                                                  [m for _, m in entries],
                                                  self.agg_cfg))
            except BaseException:
                self._abort_global_drain()
                raise
            with rec.pending_lock:
                rec.swap(new_params, plan.meta)
                for sh, sq in zip(self._proc_shards, acked, strict=True):
                    with sh.journal_lock:
                        self._ack(sh, sq)
        with self._drain_lock:
            self._n_drain_updates += n
            self._n_drain_fast_path += plan.n_fast_path
            self.n_drain_batches += 1
            self.n_drained += n
            self.n_global_drains += 1
            self.n_global_partials += len(partials)
        return n

    def drain_all(self) -> int:
        """One full beat: the cross-server global merge, then one
        ``drain_shard`` broadcast (the threaded runtime's process pump)."""
        total = self.drain_global()
        total += sum(self._scatter_gather(server_proc.packb(["drain_shard"]),
                                          self._apply_shard_beat))
        return total

    # ---------------------------------------------------- lazy mirror sync
    def _apply_synced(self, sh: _ProcShard, reply) -> int:
        """Apply one ``synced`` reply: swap each shipped (params, meta) in,
        retire the accumulated acks, release the deferred stats."""
        n = 0
        for key, acked, params, meta_w in reply[1]:
            rec = self._record(key)
            with sh.journal_lock:
                rec.swap(params, meta_from_wire(meta_w))
                self._ack(sh, acked)
                sh.dirty.discard(key)
                counts = sh.deferred.pop(key, None)
            self._push_replicas(sh, key, params, meta_w)
            if counts:
                self._count_drain(counts[0], counts[1], batches=counts[2])
            n += 1
        return n

    def _sync_shard(self, sh: _ProcShard) -> int:
        with self._drain_lock:
            self.n_mirror_syncs += 1
        return self._rpc(sh, server_proc.packb(["sync"]),
                         lambda reply: self._apply_synced(sh, reply))

    def fetch_endpoints(self):
        """Read-tier addresses per shard (replicas first, the owner last),
        or ``None`` when the workers are not reachable over TCP."""
        if self.server_hosts is None:
            return None
        out = []
        for sh in self._proc_shards:
            addrs = (list(self.replica_hosts[sh.idx])
                     if self.replica_hosts else [])
            addrs.append(self.server_hosts[sh.idx])
            out.append(addrs)
        return out

    def _sync_key(self, key: str):
        """Read barrier for one model: a dirty mirror pulls the worker's
        params before the read.  The dirty mark is set and checked under
        ``journal_lock``, so a read that starts after a meta-only ack was
        applied always syncs."""
        if self.mirror_sync_every <= 1 or key == GLOBAL_KEY or self._closed:
            return
        sh = self._proc_shards[self.shard_of(key)]
        with sh.journal_lock:
            if key not in sh.dirty:
                return
        self._sync_shard(sh)

    def sync_mirrors(self) -> int:
        """Barrier: flush every worker's folded-but-unshipped params into
        the mirrors.  Returns the models synced (0 when every drain reply
        ships params)."""
        if self.mirror_sync_every <= 1 or self._closed:
            return 0
        synced = 0
        for sh in self._proc_shards:
            with sh.journal_lock:
                dirty = bool(sh.dirty)
            if dirty:
                synced += self._sync_shard(sh)
        return synced

    # ------------------------------------------------- reads (sync barrier)
    def request_model(self, level: str, cluster_key: str | None = None):
        self._sync_key(self._key(level, cluster_key))
        return super().request_model(level, cluster_key)

    def params(self, level: str, cluster_key: str | None = None):
        self._sync_key(self._key(level, cluster_key))
        return super().params(level, cluster_key)

    def meta(self, level: str, cluster_key: str | None = None) -> ModelMeta:
        self._sync_key(self._key(level, cluster_key))
        return super().meta(level, cluster_key)

    # ---------------------------------------------------- secure aggregation
    def submit_secure(self, level: str, cluster_key: str | None,
                      client_id: str, round_id: int, masked_delta,
                      delta: UpdateDelta) -> int:
        key = self._key(level, cluster_key)
        if key == GLOBAL_KEY:
            # the parent owns the global model, so its secure rounds fold
            # in the parent
            return super().submit_secure(level, cluster_key, client_id,
                                         round_id, masked_delta, delta)
        self._record(key)
        seq = next(self._gseq)
        bucket = (key, int(round_id))
        delta_w = delta_to_wire(delta)
        while True:
            idx = self.shard_of(key)
            sh = self._proc_shards[idx]
            with sh.journal_lock:
                if self.shard_of(key) != idx:
                    continue    # migration fenced this key: reroute
                sh.stats.count_enqueue()    # once, before publish
                raw = server_proc.packb(
                    ["ssub", seq, key, int(round_id), str(client_id),
                     masked_delta, delta_w, self.ring.epoch])
                sh.journal[seq] = _JournalEntry("secure", key, delta.rounds,
                                                raw)
                sh.secure_counts[bucket] = sh.secure_counts.get(bucket, 0) + 1
                depth = sh.secure_counts[bucket]
                self._outbox_put(sh, raw)
            break
        sh.stats.observe_depth(depth)
        return depth

    def drain_secure(self, level: str, cluster_key: str | None,
                     round_id: int, expected_ids) -> int:
        key = self._key(level, cluster_key)
        if key == GLOBAL_KEY:
            return super().drain_secure(level, cluster_key, round_id,
                                        expected_ids)
        sh = self._proc_shards[self.shard_of(key)]

        def apply(reply):
            _, _, folded, recovered, acked, params, meta_w = reply
            if not folded:
                return 0
            rec = self._record(key)
            with sh.journal_lock:
                rec.swap(params, meta_from_wire(meta_w))
                # secure replies always ship params, flushing earlier
                # meta-only acks of the key with them
                self._ack(sh, acked)
                sh.secure_counts.pop((key, int(round_id)), None)
                sh.dirty.discard(key)
                counts = sh.deferred.pop(key, None)
            self._push_replicas(sh, key, params, meta_w)
            if counts:
                self._count_drain(counts[0], counts[1], batches=counts[2])
            self._count_drain(folded, 0, secure=True, recovered=recovered)
            return folded

        return self._rpc(
            sh, server_proc.packb(["sdrain", key, int(round_id),
                                   [str(i) for i in expected_ids]]), apply)

    # ---------------------------------------------------- cluster migration
    def migrate_cluster(self, cluster_key: str, dst_shard: int) -> int:
        """Live-migrate one cluster model to another worker; returns the
        new ownership epoch.

        Under both workers' rpc locks (index order): sync the key's
        meta-only acks, fence by flipping the ring override (new submits
        route to the new owner from then on), flush the old owner's outbox,
        move the key's journal entries and counters to the new owner, then
        ``mig_export`` (the old worker ships params, queue and secure
        buckets and tombstones the key) and ``mig_install`` (the new worker
        takes them, skipping held seqs).  Finally ``mig_redirects``
        re-delivers submits the old worker parked.  A failure after the
        journal move falls back to respawning the destination: mirror and
        journal complete the migration."""
        key = self._key("cluster", cluster_key)
        rec = self._record(key)              # unknown cluster -> KeyError
        dst_i = int(dst_shard)
        if not 0 <= dst_i < self.n_shards:
            raise ValueError(f"destination shard {dst_i} out of range "
                             f"[0, {self.n_shards})")
        src_i = self.shard_of(key)
        if src_i == dst_i:
            # fedlint: unlocked-ok(monotone int; no-op returns current epoch)
            return self.ring.epoch           # already owned by dst: no-op
        src, dst = self._proc_shards[src_i], self._proc_shards[dst_i]
        first, second = (src, dst) if src_i < dst_i else (dst, src)
        with first.rpc_lock, second.rpc_lock:
            epoch = self._migrate_locked(key, rec, src, dst)
        with self._drain_lock:
            self.n_cluster_migrations += 1
        return epoch

    def _migrate_locked(self, key: str, rec: ModelRecord, src: _ProcShard,
                        dst: _ProcShard) -> int:
        """The fence, ship, ack and replay body of ``migrate_cluster``.
        Caller holds both shards' rpc locks (index order)."""
        # 1. flush meta-only acks: then the journal holds exactly the seqs
        # the src worker still queues for this key
        if self.mirror_sync_every > 1:
            with src.journal_lock:
                dirty = key in src.dirty
            if dirty:
                self._sync_shard(src)
        # 2. fence: from here every submit routes (and journals) to dst
        epoch = self.ring.assign(key, dst.idx)
        # 3. pre-fence stragglers in the outbox reach src before the export
        with src.journal_lock:
            self._flush_outbox(src)
        # 4. move the key's journal entries and counters to dst: after this
        # a dst respawn alone completes the migration
        a, b = (src, dst) if src.idx < dst.idx else (dst, src)
        with a.journal_lock, b.journal_lock:
            for seq in [s for s, e in src.journal.items() if e.key == key]:
                dst.journal[seq] = src.journal.pop(seq)
            if key in src.pending_counts:
                dst.pending_counts[key] = dst.pending_counts.get(key, 0) + \
                    src.pending_counts.pop(key)
                dst.pending_rounds[key] = dst.pending_rounds.get(key, 0) + \
                    src.pending_rounds.pop(key, 0)
            for bkt in [b for b in src.secure_counts if b[0] == key]:
                dst.secure_counts[bkt] = dst.secure_counts.get(bkt, 0) + \
                    src.secure_counts.pop(bkt)
            if key in src.dirty:          # empty after step 1; defensive
                src.dirty.discard(key)
                dst.dirty.add(key)
            d = src.deferred.pop(key, None)
            if d is not None:
                dd = dst.deferred.setdefault(key, [0, 0, 0])
                for i in range(3):
                    dd[i] += d[i]
        # 5. export; a None state means src was respawned mid-export (its
        # post-flip seed excludes the key): reseed dst instead
        try:
            reply = self._exchange(src, server_proc.packb(
                ["mig_export", key, epoch, dst.idx]))
            self._check_error(src, reply)
            state = reply[2]
        except BaseException:
            # a deferred submit-path error surfaced on the export: reset
            # both workers to the journal before re-raising, so the
            # half-moved key cannot fold twice
            self._respawn(src)
            self._respawn(dst)
            raise
        if state is None:
            self._respawn(dst)
        else:
            try:
                reply = self._exchange(dst, server_proc.packb(
                    ["mig_install", key, epoch, state]))
                self._check_error(dst, reply)
            except (RuntimeError, transport.WorkerUnavailable):
                # journal and mirror are authoritative; a fresh dst seed
                # and replay complete the migration
                self._respawn(dst)
        # 6. re-deliver submits src parked for migrated keys; dst's held-seq
        # dedup makes a duplicate delivery a no-op
        try:
            reply = self._exchange(src, server_proc.packb(["mig_redirects"]))
            self._check_error(src, reply)
            redirected = reply[1]
        except (RuntimeError, transport.WorkerUnavailable):
            redirected = []   # a respawned src parked nothing
        if redirected:
            with dst.journal_lock:
                for raw in redirected:
                    self._outbox_put(dst, raw)
        # 7. the new owner's replicas serve the key from the parent mirror
        # until the next fold pushes a fresher one
        params, meta = rec.snapshot()
        self._push_replicas(dst, key, params, meta_to_wire(meta))
        return epoch

    # ------------------------------------------------------------- inspection
    def _count_drain_timeout(self, shard: int | None = None):
        """Deadline misses, also attributed per worker."""
        with self._drain_lock:
            self.n_drain_timeouts += 1
            if shard is not None:
                self.n_shard_drain_timeouts[shard] += 1

    def transport_kind(self) -> str:
        if self.server_hosts is not None:
            return "tcp"
        return "inprocess" if self.inprocess else "process"

    def wire_bytes(self) -> tuple[int, int]:
        """(tx, rx) payload bytes across every worker transport."""
        tx = sum(sh.handle.tx_bytes for sh in self._proc_shards)
        rx = sum(sh.handle.rx_bytes for sh in self._proc_shards)
        for sh in self._proc_shards:
            tx += sum(h.tx_bytes for h in sh.replicas)
            rx += sum(h.rx_bytes for h in sh.replicas)
        return tx, rx

    def agg_stats(self) -> dict:
        tx, rx = self.wire_bytes()
        with self._drain_lock:
            extra = {"processes": 0 if self.inprocess else self.n_shards,
                     "transport": self.transport_kind(),
                     "respawns": self.n_respawns,
                     "mirror_syncs": self.n_mirror_syncs,
                     "shard_drain_timeouts":
                         list(self.n_shard_drain_timeouts),
                     "wire_tx_bytes": tx,
                     "wire_rx_bytes": rx,
                     "replicas": sum(len(sh.replicas)
                                     for sh in self._proc_shards),
                     "replica_pushes": sum(sh.replica_pushes
                                           for sh in self._proc_shards),
                     "replica_drops": sum(sh.replica_drops
                                          for sh in self._proc_shards),
                     "ownership_epoch": self.ring.epoch,
                     "cluster_migrations": self.n_cluster_migrations}
        return _sharded_agg_stats(self, self._proc_shards, extra)
