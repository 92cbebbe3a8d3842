"""Shard servers as worker processes: the process server tier.

``ProcessShardedModelStore`` (``repro_torch.core.store``) promotes each
shard of the sharded server to a worker: the parent serializes submits
onto per-shard command queues, each worker owns its shard's cluster
models, pending queues and secure-round buckets and folds them with the
same ``coalesced_aggregate`` the in-thread stores use (the ``fedavg_agg``
kernel on a CUDA worker), and drain replies ship the folded ``(params,
meta)`` back for the parent's mirror.

This module holds what a spawned child imports:

  * the wire helpers (``meta_to_wire`` and the others) and
    ``make_seed_blob``; payloads use the checkpoint codec, whose bytes
    equal the reference's, so seed blobs, commands and replies are wire v4
    byte for byte;
  * ``ShardWorker``, the shard server's logic, driven by the spawned main
    loop, by the standalone TCP server (``repro_torch.launch.shard_server``)
    and by the deterministic in-process emulation, all through the same
    serialized messages;
  * ``ProcessWorkerHandle`` / ``InprocessWorkerHandle``, two of the three
    ``Transport`` flavours (the TCP one is in ``repro_torch.core.transport``).

A worker's device is an argument of the worker, never part of the seed
blob: tensors arrive on the wire as host bytes and are decoded onto the
worker's device, and a worker asked for CUDA where there is none raises.
Spawned workers use the ``spawn`` start method (a forked child cannot use
CUDA once the parent has).

Crash safety is the parent's job: every update a worker holds is journaled
in the parent until the drain that folded it is acked, so a killed worker
is respawned from the parent's mirrors and its journal replayed.  Replays
are idempotent: submits carry a monotone ``seq`` and the worker drops a seq
it already holds (``held``).

Lazy mirror sync (``sync_every`` in the seed blob): drain replies ship the
folded params only every Nth non-empty reply per model and ack with
seq-stamped metadata otherwise; a ``sync`` command ships the rest.

Migration (wire v4): ``mig_export`` / ``mig_install`` / ``mig_redirects``
move a cluster's fold state between workers; a migrated-away key is
tombstoned and answers replying ops with a ``redirect`` naming the new
owner; submits racing a fence park worker-side and are replayed or handed
back.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as _queue
import threading
from collections import deque

import torch

from repro_torch.checkpoint.msgpack_ckpt import packb, unpackb
from repro_torch.core.aggregation import (
    AggregationConfig,
    ModelMeta,
    UpdateDelta,
    chunked_convex_reduce,
    coalesced_aggregate,
    multi_aggregate,
    secure_coalesced_aggregate,
)
from repro_torch.core.fetch import WireCache, serve_fetch
from repro_torch.core.transport import (
    Transport,
    WorkerTimeout,
    WorkerUnavailable,
)
from repro_torch.obs import clock
from repro_torch.obs.record import Telemetry, current_trace, trace_scope
from repro_torch.utils.device import resolve_device

# commands that produce exactly one reply; everything else is fire-and-forget
REPLY_OPS = frozenset({"drain", "drain_shard", "gmeta", "greduce", "sdrain",
                       "sync", "ping", "obsdump", "stop", "fetch",
                       "mig_export", "mig_install", "mig_redirects"})


# ------------------------------------------------------------------ wire fmt

def meta_to_wire(meta) -> list:
    return [meta.samples_learned, meta.epochs_learned, meta.round]


def meta_from_wire(w) -> ModelMeta:
    return ModelMeta(int(w[0]), int(w[1]), int(w[2]))


def delta_to_wire(delta) -> list:
    return [delta.samples_learned, delta.epochs_learned, delta.rounds]


def delta_from_wire(w) -> UpdateDelta:
    return UpdateDelta(int(w[0]), int(w[1]), int(w[2]))


def observe_fold(tel, route: str, t0: int, base_round: int, items,
                 name: str = "fold", args: dict | None = None) -> None:
    """Record one fold of ``items`` (``(meta, delta)`` pairs in arrival
    order) that started at ``t0``: its host time, its batch size and each
    update's telescoped staleness.

    ``ModelMeta.accumulate`` advances ``round`` additively by each delta's
    rounds, so measuring every update against base + the rounds folded
    before it does not depend on where drains cut the queue: the histogram
    is the same on every topology's drains of one FIFO schedule.  On a card
    the fold launches asynchronously, so the duration is the host time of
    the call, not the device's work."""
    dur = clock.monotonic_ns() - t0
    tel.metrics.histogram(f"drain_fold_ns_{route}").observe(dur)
    tel.metrics.histogram("coalesce_batch").observe(len(items))
    stale = tel.metrics.histogram("staleness_at_fold")
    cum = 0
    for m, d in items:
        stale.observe(max(0, base_round + cum - m.round))
        cum += d.rounds
    tel.event(name, t0, dur, current_trace(), args)


def make_seed_blob(shard_records, max_coalesce: int, agg_cfg,
                   masker, mirror_sync_every: int = 1,
                   telemetry=None, epoch: int = 0,
                   migrated=None) -> bytes:
    """Everything a fresh worker needs, in wire format: its cluster
    records, the fold config, the masker's parameters (secure rounds fold
    inside the owning worker), the lazy-sync cadence, the telemetry config
    (``None``: off), the ownership ``epoch`` and the ``migrated`` tombstones
    (``key -> [dst, epoch]``).

    The ``"agg"`` pair is ``[use_pallas, sequential_fast_path]``.  The port
    has no route switch (the device decides), so it writes ``False``, the
    reference's default, and the blob equals a default JAX parent's."""
    return packb({
        "records": [[key, params, meta_to_wire(meta)]
                    for key, params, meta in shard_records],
        "max_coalesce": int(max_coalesce),
        "agg": [False, bool(agg_cfg.sequential_fast_path)],
        "masker": (None if masker is None
                   else [int(masker.seed), float(masker.mask_scale)]),
        "sync_every": int(mirror_sync_every),
        "telemetry": telemetry,
        "epoch": int(epoch),
        "migrated": {str(k): [int(v[0]), int(v[1])]
                     for k, v in (migrated or {}).items()},
    })


# ------------------------------------------------------------------- worker

class ShardWorker:
    """One shard server's logic.

    Owns working copies of the shard's cluster models (tensors on
    ``device``), their pending queues, their secure-round buckets and the
    shard's slice of the global queue.  The command path is single-threaded
    (one consumer per queue or command session), so it takes no locks.
    ``fetch`` is the one entry point called concurrently (from TCP read
    sessions): it reads only each record's published ``snap`` tuple,
    swapped by one reference assignment after every fold, and the locked
    wire cache.

    The seed blob's ``use_pallas`` flag is read and ignored: the device
    decides the fold's route.  Its telemetry config (``None``: off, else
    ``{"sample_n": N}``) gives the worker a ``Telemetry`` of its own, site
    ``shard-{idx}``, whose dump answers ``obsdump`` (``None`` when off).
    The fold histogram is ``drain_fold_ns_cuda`` on a card and
    ``drain_fold_ns_host`` elsewhere.
    """

    def __init__(self, shard_idx: int, seed_blob: bytes, device=None):
        self.device = resolve_device(device)
        blob = self.decode(seed_blob)
        self.idx = shard_idx
        self.max_coalesce = max(int(blob["max_coalesce"]), 1)
        self.sync_every = max(int(blob.get("sync_every", 1)), 1)
        _use_pallas, fast_path = blob["agg"]
        self.agg_cfg = AggregationConfig(sequential_fast_path=bool(fast_path))
        self.masker = None
        if blob["masker"] is not None:
            from repro_torch.privacy.secure_agg import PairwiseMasker

            seed, scale = blob["masker"]
            self.masker = PairwiseMasker(seed=seed, mask_scale=scale)
        tcfg = blob.get("telemetry")
        self.tel = (Telemetry(sample_n=int(tcfg.get("sample_n", 1)),
                              site=f"shard-{shard_idx}")
                    if tcfg else None)
        self._route = "cuda" if self.device.type == "cuda" else "host"
        # key -> {"params", "meta", "pending": deque[(seq, p, m, d)],
        #         "secure": {round_id: [(seq, client_id, masked, delta)]},
        #         "unsynced": [seqs folded but not yet shipped with params],
        #         "drains": replies since the last params-carrying one}
        self.records: dict[str, dict] = {}
        self.wire_cache = WireCache()
        for key, params, meta_w in blob["records"]:
            self._ensure(key, params, meta_from_wire(meta_w))
        self.gslice: deque = deque()       # (seq, params, meta, delta)
        # the highest ownership epoch seen, and the tombstones of clusters
        # migrated away: replying ops on them answer a redirect
        self.epoch = int(blob.get("epoch", 0))
        self.migrated: dict[str, tuple[int, int]] = {
            str(k): (int(v[0]), int(v[1]))
            for k, v in (blob.get("migrated") or {}).items()}
        # submits that raced a migration fence, in arrival order (key, raw)
        self.parked: list[tuple[str, bytes]] = []
        # seqs this worker holds (queued, not folded): a replayed duplicate
        # is dropped; a failed submit never enters, so its replay is taken
        self.held: set[int] = set()
        # errors of fire-and-forget commands, surfaced as the error reply
        # of the next replying command
        self.pending_errors: list[str] = []

    def decode(self, raw: bytes):
        """One wire message with its arrays as tensors on this worker's
        device."""
        return unpackb(raw, self.device)

    def _ensure(self, key: str, params, meta=None):
        if key not in self.records:
            rec = {"params": params,
                   "meta": meta if meta is not None else ModelMeta(),
                   "pending": deque(), "secure": {},
                   "unsynced": [], "drains": 0}
            self._publish(rec)
            self.records[key] = rec

    @staticmethod
    def _publish(rec):
        """Swap the record's read-path snapshot in one assignment, so a
        concurrent ``fetch`` sees (params, meta) move together."""
        rec["snap"] = (rec["params"], meta_to_wire(rec["meta"]))

    def _serves(self, key: str) -> bool:
        """False while a migration races: the key was migrated away, or is
        migrating in and ``mig_install`` has not landed."""
        return key in self.records and key not in self.migrated

    def _park(self, key: str, msg):
        """Hold a submit that raced a migration fence, re-serialized so a
        replay or redirect re-delivers the same bytes."""
        self.parked.append((key, packb(msg)))
        if self.tel is not None:
            self.tel.metrics.counter("parked_submits").inc()
        return None

    # --------------------------------------------------------------- dispatch
    def handle(self, msg):
        """One decoded command -> reply list (``None`` for fire-and-forget)."""
        op = msg[0]
        if op in REPLY_OPS and self.pending_errors:
            errs = "; ".join(self.pending_errors)
            self.pending_errors = []
            return ["error", op, f"deferred submit-path errors: {errs}"]
        if op == "batch":
            # many fire-and-forget commands in one message; one poison item
            # must not strand its batchmates
            for raw in msg[1]:
                try:
                    self.handle(self.decode(raw))
                except Exception as e:
                    self.pending_errors.append(
                        f"batch-item: {type(e).__name__}: {e}")
            return None
        if op == "sub":
            _, seq, key, params, meta_w, delta_w, _epoch = msg
            if not self._serves(key):
                return self._park(key, msg)
            if int(seq) not in self.held:
                self.records[key]["pending"].append(
                    (seq, params, meta_from_wire(meta_w),
                     delta_from_wire(delta_w)))
                self.held.add(int(seq))
            return None
        if op == "gsub":
            _, seq, params, meta_w, delta_w = msg
            if int(seq) not in self.held:
                self.gslice.append((seq, params, meta_from_wire(meta_w),
                                    delta_from_wire(delta_w)))
                self.held.add(int(seq))
            return None
        if op == "ssub":
            _, seq, key, round_id, client_id, masked, delta_w, _epoch = msg
            if not self._serves(key):
                return self._park(key, msg)
            if int(seq) not in self.held:
                bucket = self.records[key]["secure"].setdefault(
                    int(round_id), [])
                bucket.append((seq, client_id, masked,
                               delta_from_wire(delta_w)))
                self.held.add(int(seq))
            return None
        if op == "ensure":
            _, key, params, _epoch = msg
            if key in self.migrated:
                return self._park(key, msg)
            self._ensure(key, params)
            return None
        if op == "fetch":
            return self.fetch(msg[1], msg[2] if len(msg) > 2 else None)
        if op == "mirror":
            _, key, params, meta_w = msg
            if key in self.migrated:
                return None      # stale push that raced the fence: drop
            self._mirror(key, params, meta_w)
            return None
        if op == "mig_export":
            return self._mig_export(msg[1], int(msg[2]), int(msg[3]))
        if op == "mig_install":
            return self._mig_install(msg[1], int(msg[2]), msg[3])
        if op == "mig_redirects":
            return self._mig_redirects()
        if op == "drain":
            return self._drain_key(msg[1])
        if op == "drain_shard":
            out = []
            for key in self.records:
                r = self._drain_key(key)
                if r[0] == "error":
                    return r           # a fold error fails the whole beat
                out.append(r[1:])
            return ["shard_drained", out]
        if op == "gmeta":
            # metadata of the global slice: the parent plans over metas,
            # params stay here until greduce folds them into one partial
            return ["gmetas", [[seq, meta_to_wire(m), delta_to_wire(d)]
                               for seq, _, m, d in self.gslice]]
        if op == "greduce":
            return self._greduce(msg[1])
        if op == "sdrain":
            _, key, round_id, expected_ids = msg
            return self._drain_secure(key, int(round_id), expected_ids)
        if op == "sync":
            # the sync_mirrors() barrier: params and accumulated acks of
            # every model with meta-only acks outstanding
            out = []
            for key, rec in self.records.items():
                if not rec["unsynced"]:
                    continue
                acked, rec["unsynced"], rec["drains"] = rec["unsynced"], [], 0
                out.append([key, acked, rec["params"],
                            meta_to_wire(rec["meta"])])
            return ["synced", out]
        if op == "obsdump":
            # the worker's metrics and event rings, with the wall-clock
            # anchor that puts this site on the parent's timeline
            return ["obsdumped",
                    self.tel.dump() if self.tel is not None else None]
        if op == "ping":
            return ["pong", self.idx, sorted(self.records)]
        raise ValueError(f"unknown worker op {op!r}")

    # -------------------------------------------------------------- read path
    def fetch(self, key: str, held=None):
        """Serve one conditional fetch from the published snapshot; a
        tombstoned key answers a redirect naming the new owner."""
        mig = self.migrated.get(key)
        if mig is not None:
            return ["redirect", key, mig[0], mig[1]]
        rec = self.records.get(key)
        snap = rec.get("snap") if rec is not None else None
        if snap is None:
            raise KeyError(f"shard {self.idx} does not serve {key!r}")
        params, meta_w = snap
        tel = self.tel
        t0 = clock.monotonic_ns() if tel is not None else 0
        kind, payload = serve_fetch(self.wire_cache, key, params, meta_w,
                                    held)
        if tel is not None:
            name = ("full", "not_modified", "delta")[kind]
            tel.metrics.counter(f"fetch_{name}").inc()
            tel.metrics.histogram("fetch_serve_ns").observe(
                clock.monotonic_ns() - t0)
            if payload is not None:
                tel.metrics.histogram("fetch_reply_bytes").observe(
                    len(payload))
        return ["fetched", key, kind, payload, meta_w]

    def _mirror(self, key: str, params, meta_w):
        """Replica push: overwrite this server's copy of a model it
        mirrors for read fan-out (replicas never fold)."""
        self._ensure(key, params, meta_from_wire(meta_w))
        rec = self.records[key]
        rec["params"], rec["meta"] = params, meta_from_wire(meta_w)
        self._publish(rec)

    # -------------------------------------------------------------- migration
    def _mig_export(self, key: str, epoch: int, dst: int):
        """Ship one cluster's fold state to its new owner and tombstone the
        key.  ``None`` state: this worker no longer holds the record (it was
        respawned after the ring flipped), and the parent reseeds the
        destination instead."""
        self.epoch = max(self.epoch, int(epoch))
        rec = self.records.pop(key, None)
        if rec is None:
            return ["mig_state", key, None]
        self.migrated[key] = (int(dst), int(epoch))
        state = {
            "params": rec["params"],
            "meta": meta_to_wire(rec["meta"]),
            "pending": [[seq, p, meta_to_wire(m), delta_to_wire(d)]
                        for seq, p, m, d in rec["pending"]],
            "secure": [[rid, [[seq, cid, masked, delta_to_wire(d)]
                              for seq, cid, masked, d in bucket]]
                       for rid, bucket in rec["secure"].items()],
            "unsynced": list(rec["unsynced"]),
            "drains": int(rec["drains"]),
        }
        shipped = {int(s) for s, _, _, _ in rec["pending"]}
        for bucket in rec["secure"].values():
            shipped.update(int(s) for s, _, _, _ in bucket)
        self.held.difference_update(shipped)
        return ["mig_state", key, state]

    def _mig_install(self, key: str, epoch: int, state):
        """Install a migrated cluster as its new owner; idempotent: seqs
        already held are skipped and the params overwrite equals the
        parent-mirror seed a respawn would use."""
        self.epoch = max(self.epoch, int(epoch))
        self.migrated.pop(key, None)
        params = state["params"]
        meta = meta_from_wire(state["meta"])
        self._ensure(key, params, meta)
        rec = self.records[key]
        rec["params"], rec["meta"] = params, meta
        self._publish(rec)
        n_shipped = 0
        for seq, p, m_w, d_w in state.get("pending", []):
            if int(seq) in self.held:
                continue
            rec["pending"].append((seq, p, meta_from_wire(m_w),
                                   delta_from_wire(d_w)))
            self.held.add(int(seq))
            n_shipped += 1
        for rid, bucket in state.get("secure", []):
            dst_bucket = rec["secure"].setdefault(int(rid), [])
            for seq, cid, masked, d_w in bucket:
                if int(seq) in self.held:
                    continue
                dst_bucket.append((seq, cid, masked, delta_from_wire(d_w)))
                self.held.add(int(seq))
                n_shipped += 1
        rec["unsynced"].extend(int(s) for s in state.get("unsynced", []))
        rec["drains"] = max(rec["drains"], int(state.get("drains", 0)))
        self._replay_parked(key)
        return ["mig_installed", key, n_shipped]

    def _replay_parked(self, key: str):
        """Re-dispatch the messages parked for a key that just installed,
        in arrival order, after its shipped queue."""
        mine, rest = [], []
        for k, raw in self.parked:
            (mine if k == key else rest).append((k, raw))
        self.parked = rest
        for _, raw in mine:
            self.handle(self.decode(raw))

    def _mig_redirects(self):
        """Hand back the messages parked for migrated-away keys, for the
        parent to re-deliver to the new owner."""
        out, keep = [], []
        for k, raw in self.parked:
            (out if k in self.migrated else keep).append((k, raw))
        self.parked = keep
        return ["redirected", [raw for _, raw in out]]

    # ----------------------------------------------------------------- drains
    def _drain_key(self, key: str):
        """Fold every pending update of one model, ``max_coalesce`` at a
        time (one kernel launch a batch on CUDA).  On a fold error the
        popped batch goes back to the queue head.  Lazy sync: only every
        ``sync_every``-th non-empty reply carries the params, and such a
        reply flushes every accumulated ack."""
        mig = self.migrated.get(key)
        if mig is not None:
            return ["redirect", key, mig[0], mig[1]]
        rec = self.records[key]
        tel = self.tel
        folded = fast = batches = 0
        acked: list[int] = []
        while rec["pending"]:
            take = min(len(rec["pending"]), self.max_coalesce)
            batch = [rec["pending"].popleft() for _ in range(take)]
            t0 = clock.monotonic_ns() if tel is not None else 0
            try:
                res = coalesced_aggregate(
                    rec["params"], rec["meta"],
                    [(p, m, d) for _, p, m, d in batch], self.agg_cfg)
            except Exception as e:
                rec["pending"].extendleft(reversed(batch))
                return ["error", key, f"{type(e).__name__}: {e}"]
            if tel is not None:
                observe_fold(tel, self._route, t0, rec["meta"].round,
                             [(m, d) for _, _, m, d in batch],
                             name="worker.fold",
                             args={"key": key, "n": len(batch),
                                   "seqs": [int(s) for s, _, _, _ in batch]})
            rec["params"], rec["meta"] = res.params, res.meta
            self._publish(rec)
            folded += res.n_folded
            fast += res.n_fast_path
            batches += 1
            acked.extend(seq for seq, _, _, _ in batch)
            self.held.difference_update(int(s) for s, _, _, _ in batch)
        if not folded:
            return ["drained", key, 0, 0, 0, [], None, None]
        rec["unsynced"].extend(acked)
        rec["drains"] += 1
        if self.sync_every > 1 and rec["drains"] < self.sync_every:
            return ["drained", key, folded, fast, batches, acked,
                    None, meta_to_wire(rec["meta"])]
        if tel is not None:
            # mirror-sync age: the drain replies this params-carrying one
            # accumulated (1 = eager sync, about sync_every when lazy)
            tel.metrics.histogram("mirror_sync_lag").observe(rec["drains"])
        full_acked, rec["unsynced"], rec["drains"] = rec["unsynced"], [], 0
        return ["drained", key, folded, fast, batches, full_acked,
                rec["params"], meta_to_wire(rec["meta"])]

    def _greduce(self, pairs):
        """Reduce this server's slice members to one convex partial.

        ``pairs`` is ``[[seq, weight], ...]``: the coefficients the parent
        planned over every server's metas for the seqs of its ``gmeta``
        snapshot.  The selected members leave the slice; the nonzero-weight
        ones fold (arity bounded by ``max_coalesce``) into the partial
        ``sum_i (w_i / W) p_i`` of mass ``W = sum w_i``, which the parent's
        mass-weighted merge turns back into the flat fold's sum."""
        want = {int(s): float(w) for s, w in pairs}
        keep = deque()
        take = []
        for item in self.gslice:
            (take if item[0] in want else keep).append(item)
        entries = [(p, want[seq]) for seq, p, _, _ in take
                   if want[seq] != 0.0]
        partial, mass = None, 0.0
        if entries:
            try:
                entries = chunked_convex_reduce(entries, self.max_coalesce,
                                                self.agg_cfg)
                partial = (entries[0][0] if len(entries) == 1 else
                           multi_aggregate([p for p, _ in entries],
                                           [m for _, m in entries],
                                           self.agg_cfg))
            except Exception as e:
                return ["error", "greduce", f"{type(e).__name__}: {e}"]
            mass = float(sum(m for _, m in entries))
        self.gslice = keep
        self.held.difference_update(int(s) for s, _, _, _ in take)
        return ["gpartial", [seq for seq, _, _, _ in take], mass, partial]

    def _drain_secure(self, key: str, round_id: int, expected_ids):
        """Fold one secure round inside this worker: the pairwise masks
        cancel inside one fused sum, and dropouts are recovered from the
        worker's own masker."""
        mig = self.migrated.get(key)
        if mig is not None:
            return ["redirect", key, mig[0], mig[1]]
        rec = self.records[key]
        batch = rec["secure"].pop(round_id, [])
        if not batch:
            return ["sdrained", key, 0, 0, [], None, None]
        t0 = clock.monotonic_ns() if self.tel is not None else 0
        try:
            submitted = {cid for _, cid, _, _ in batch}
            missing = sorted(set(expected_ids) - submitted)
            correction = None
            if missing:
                if self.masker is None:
                    raise RuntimeError(
                        "secure round has dropouts but no masker is attached "
                        "for seed reconstruction")
                correction = self.masker.reconstruct(
                    rec["params"], missing, sorted(submitted), round_id, key)
            res = secure_coalesced_aggregate(
                rec["params"], rec["meta"],
                [(masked, d) for _, _, masked, d in batch],
                self.agg_cfg, correction)
        except Exception as e:
            rec["secure"][round_id] = batch + rec["secure"].get(round_id, [])
            return ["error", key, f"{type(e).__name__}: {e}"]
        if self.tel is not None:
            dur = clock.monotonic_ns() - t0
            self.tel.metrics.histogram("secure_round_ns").observe(dur)
            self.tel.event("worker.secure_fold", t0, dur, current_trace(),
                           {"key": key, "n": len(batch),
                            "missing": len(missing)})
        rec["params"], rec["meta"] = res.params, res.meta
        self._publish(rec)
        self.held.difference_update(int(s) for s, _, _, _ in batch)
        # secure replies always carry params, so they flush every earlier
        # meta-only ack of the key
        acked = rec["unsynced"] + [seq for seq, _, _, _ in batch]
        rec["unsynced"], rec["drains"] = [], 0
        return ["sdrained", key, len(batch), len(missing), acked,
                rec["params"], meta_to_wire(rec["meta"])]


def load_kernels(device) -> None:
    """Create the CUDA context and load the kernel library on a CUDA
    worker before it serves, so its first fold pays neither (the parent
    has built the library)."""
    device = resolve_device(device)
    if device.type == "cuda":
        from repro_torch.kernels import build

        torch.cuda.synchronize(device)
        build.library()


def worker_main(shard_idx: int, cmd_q, rsp_q, device):
    """Spawned shard-server entry point.  Takes its seed blob as the first
    item of ``cmd_q``, announces ``["ready", idx]`` once the worker is
    built on its device (CUDA context and kernel library loaded), then
    decodes, dispatches and replies.  Each command arrives as
    ``(trace_ctx, raw)``: the sender's trace context, restored around the
    dispatch as a TCP server restores a frame's.  Errors of fire-and-forget
    commands become the error reply of the next replying command (replies
    pair positionally)."""
    load_kernels(device)
    worker = ShardWorker(shard_idx, cmd_q.get()[1], device)
    rsp_q.put(packb(["ready", shard_idx]))
    while True:
        trace, raw = cmd_q.get()
        msg = worker.decode(raw)
        op = msg[0]
        if op == "stop":
            rsp_q.put(packb(["stopped", shard_idx]))
            return
        try:
            with trace_scope(trace):
                reply = worker.handle(msg)
        except Exception as e:
            reply = ["error", op, f"{type(e).__name__}: {e}"]
            if op not in REPLY_OPS:
                worker.pending_errors.append(f"{op}: {type(e).__name__}: {e}")
        if op in REPLY_OPS:
            rsp_q.put(packb(reply))


# ----------------------------------------------------------------- transports

class ProcessWorkerHandle(Transport):
    """Parent-side endpoint of one spawned shard server on ``device``.

    Many parent threads may ``put`` (the queue is thread-safe and buffers
    through its feeder thread); exactly one worker consumes.  Replying
    commands pair positionally, so callers serialize them per shard (the
    store's ``_ProcShard.rpc_lock``).

    A cold child imports torch, creates its CUDA context and loads the
    kernel library before it can fold: seconds.  ``wait_ready`` waits for
    its ``ready`` message (up to ``COLD_START_S``) and records the time in
    ``cold_start_s``, so no drain deadline ever runs against a cold child.
    """

    COLD_START_S = 180.0

    def __init__(self, shard_idx: int, seed_blob: bytes, device=None):
        self.idx = shard_idx
        self.device = str(resolve_device(device))
        self.spawns = 0
        # put() (journal-lock holders) and rpc() (rpc-lock holders) both
        # bump tx_bytes, so the counter has its own lock; rx_bytes has one
        # writer population (rpc-lock holders)
        self._send_lock = threading.Lock()
        self.tx_bytes = 0
        self.rx_bytes = 0
        self.cold_start_s = None
        self._ctx = mp.get_context("spawn")
        self._start(seed_blob)

    def _start(self, seed_blob: bytes):
        self.cmd_q = self._ctx.Queue()
        self.rsp_q = self._ctx.Queue()
        # the seed goes by the queue, not the spawn's arguments: a child
        # unpickles its arguments while it imports torch, so a blob larger
        # than the pipe's buffer held this thread (and the next worker's
        # spawn) for that import
        self.proc = self._ctx.Process(
            target=worker_main,
            args=(self.idx, self.cmd_q, self.rsp_q, self.device),
            daemon=True, name=f"fedccl-shard-{self.idx}")
        self._t_start = clock.monotonic()
        self.proc.start()
        self.cmd_q.put((None, seed_blob))
        self.spawns += 1
        self._ready = False

    def wait_ready(self):
        """Block until the child announced itself ready; raises
        ``WorkerUnavailable`` if it died first (a CUDA worker where there
        is no card, say) and ``WorkerTimeout`` after ``COLD_START_S``."""
        if self._ready:
            return
        reply = self._await(self.COLD_START_S, "cold start")
        msg = unpackb(reply, "cpu")
        if msg[0] != "ready":
            raise WorkerUnavailable(
                f"shard worker {self.idx} sent {msg[0]!r} before ready")
        self.cold_start_s = clock.monotonic() - self._t_start
        self._ready = True

    def _await(self, timeout: float, what: str) -> bytes:
        deadline = clock.monotonic() + timeout
        while True:
            remaining = deadline - clock.monotonic()
            try:
                return self.rsp_q.get(timeout=max(min(remaining, 0.2), 0.01))
            except _queue.Empty:
                if not self.proc.is_alive():
                    raise WorkerUnavailable(
                        f"shard worker {self.idx} died "
                        f"(exitcode {self.proc.exitcode})") from None
                if remaining <= 0:
                    raise WorkerTimeout(
                        f"shard worker {self.idx} missed the {timeout:.1f}s "
                        f"{what} deadline") from None

    def put(self, raw: bytes):
        with self._send_lock:
            self.tx_bytes += len(raw)
        # the trace context rides with the message, as in a TCP frame
        self.cmd_q.put((current_trace(), raw))

    def rpc(self, raw: bytes, timeout: float) -> bytes:
        """Send one replying command and await its reply.  Caller holds
        the shard's rpc lock."""
        self.put(raw)
        return self.rpc_recv(timeout)

    def rpc_recv(self, timeout: float) -> bytes:
        """Await one reply for a command already sent (a scatter-gather
        drain sends first and gathers later), polling liveness: a dead
        worker raises ``WorkerUnavailable`` at once, a silent live one
        ``WorkerTimeout`` at the deadline.  Caller holds the rpc lock."""
        self.wait_ready()
        reply = self._await(timeout, "drain")
        self.rx_bytes += len(reply)
        return reply

    def restart(self, seed_blob: bytes):
        """Replace a dead or stuck worker with a fresh one on fresh queues
        and wait until it is ready; the caller replays the journal."""
        self.discard()
        self._start(seed_blob)
        self.wait_ready()

    def alive(self) -> bool:
        return self.proc.is_alive()

    def kill(self):
        """SIGKILL: the crash-injection hook."""
        self.proc.kill()
        self.proc.join(5.0)

    def discard(self):
        """Tear down: SIGKILL works even on a stopped process."""
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(5.0)
        for q in (self.cmd_q, self.rsp_q):
            q.close()
            q.cancel_join_thread()

    def stop(self, timeout: float):
        """Graceful bounded shutdown, then a kill.  Caller holds the rpc
        lock."""
        try:
            reply = unpackb(self.rpc(packb(["stop"]), timeout), "cpu")
            if reply[0] == "stopped":
                self.proc.join(timeout)
        except WorkerUnavailable:
            pass
        finally:
            self.discard()


class InprocessWorkerHandle(Transport):
    """Deterministic in-process emulation of a shard server: every message
    still crosses the wire codec and ``ShardWorker.handle``, on ``device``;
    only the process (and its scheduling) is gone.  Byte counters count
    the serialized payloads."""

    def __init__(self, shard_idx: int, seed_blob: bytes, device=None):
        self.idx = shard_idx
        self.device = resolve_device(device)
        self.spawns = 0
        self._send_lock = threading.Lock()
        self.tx_bytes = 0
        self.rx_bytes = 0
        # a real worker's queue serializes every message; the emulation
        # dispatches inline, so this lock plays the queue's part
        self._dispatch_lock = threading.Lock()
        self._start(seed_blob)

    def _start(self, seed_blob: bytes):
        self.worker = ShardWorker(self.idx, seed_blob, self.device)
        self._dead = False
        self.spawns += 1

    def put(self, raw: bytes):
        if self._dead:
            return                      # a dead worker's queue eats messages
        with self._send_lock:
            self.tx_bytes += len(raw)
        msg = self.worker.decode(raw)
        try:
            with self._dispatch_lock:
                self.worker.handle(msg)
        except Exception as e:          # deferred, as in worker_main
            if msg[0] in REPLY_OPS:
                raise
            self.worker.pending_errors.append(
                f"{msg[0]}: {type(e).__name__}: {e}")

    def rpc_recv(self, timeout: float) -> bytes:
        raise NotImplementedError(
            "the in-process emulation dispatches inline; scatter-gather "
            "degenerates to sequential rpc() calls")

    def rpc(self, raw: bytes, timeout: float) -> bytes:
        """Dispatch one replying command inline.  Caller holds the shard's
        rpc lock (which keeps ``rx_bytes`` single-writer)."""
        if self._dead:
            raise WorkerUnavailable(
                f"shard worker {self.idx} died (in-process emulation)")
        with self._send_lock:
            self.tx_bytes += len(raw)
        msg = self.worker.decode(raw)
        try:
            with self._dispatch_lock:
                reply = self.worker.handle(msg)
        except Exception as e:          # worker_main's error envelope
            reply = ["error", msg[0], f"{type(e).__name__}: {e}"]
        out = packb(reply)
        self.rx_bytes += len(out)
        return out

    def restart(self, seed_blob: bytes):
        self._start(seed_blob)

    def alive(self) -> bool:
        return not self._dead

    def kill(self):
        self._dead = True
        self.worker = None

    def discard(self):
        self.kill()

    def stop(self, timeout: float):
        self.kill()
