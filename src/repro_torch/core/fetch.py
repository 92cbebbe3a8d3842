"""The read tier: conditional model fetches, served by the shard servers.

Three pieces, shared by every serving site (a shard worker, a read
replica, the parent's fallback):

* a version-keyed wire cache (``WireCache``): each model snapshot is
  serialized to its msgpack bytes at most once per version, a version
  being the model's ``(samples, epochs, round)`` meta triple;
* ``serve_fetch``: a client that says "I hold version V" gets a
  not-modified ack when V is current, a compressed byte delta when V is in
  the cache's history, and the full packed snapshot otherwise;
* ``FetchClient``: opens read-only TCP sessions to shard owners and read
  replicas (round-robin per shard), keeps the last packed snapshot per key
  so conditional fetches work, and falls back to the parent store when the
  topology has no servers, the key is the parent-owned global model, or a
  server is unreachable.

Delta codec: two versions of one model encode to equal-length byte strings
(the codec writes fixed-width little-endian arrays), so
``zlib(xor(base, new))`` is small and lossless: ``apply_delta(base,
delta)`` gives the new bytes exactly.  A delta that does not beat
``_DELTA_MAX_RATIO`` of the full payload is dropped for the full snapshot.

Every byte here equals the reference's (``repro.core.fetch``) on the same
inputs: fetch replies from a torch server serve a JAX client and the
reverse.  Decoded params are tensors on the client's device.
"""

from __future__ import annotations

import socket
import threading
import zlib
from collections import deque

import numpy as np

from repro_torch.checkpoint.msgpack_ckpt import packb, unpackb, unpackb_np
from repro_torch.core.aggregation import ModelMeta
from repro_torch.core.transport import KIND_COMMAND, pack_frame, recv_frame
from repro_torch.utils.device import resolve_device

# result kinds carried in the ``fetched`` reply (payload discriminators,
# integers on the wire)
FETCH_FULL = 0          # payload = packed snapshot bytes
FETCH_NOT_MODIFIED = 1  # payload = None; client's held version is current
FETCH_DELTA = 2         # payload = zlib(xor) patch over the held version

#: packed versions kept per key as delta bases, beyond the current one
DELTA_HISTORY = 4
#: a delta must be at least this much smaller than the full payload to be
#: worth the decompress and xor on the client
_DELTA_MAX_RATIO = 0.9


# ---------------------------------------------------------------- codec

def encode_delta(base: bytes, new: bytes) -> bytes | None:
    """Compressed byte-XOR patch taking ``base`` to ``new``; ``None`` when
    the encodings have different lengths (the tree's structure changed)."""
    if len(base) != len(new):
        return None
    x = np.bitwise_xor(np.frombuffer(base, dtype=np.uint8),
                       np.frombuffer(new, dtype=np.uint8))
    return zlib.compress(x.tobytes(), 1)


def apply_delta(base: bytes, delta: bytes) -> bytes:
    """Invert ``encode_delta``: the exact bytes of the new encoding."""
    x = zlib.decompress(delta)
    if len(x) != len(base):
        raise ValueError(
            f"delta length {len(x)} does not match held snapshot "
            f"{len(base)} — held version is not the delta's base")
    return np.bitwise_xor(np.frombuffer(base, dtype=np.uint8),
                          np.frombuffer(x, dtype=np.uint8)).tobytes()


# ----------------------------------------------------------- wire cache

class WireCache:
    """Version-keyed cache of packed snapshots.

    ``packed_for`` serializes a model at most once per version and retires
    superseded versions into a bounded per-key history that ``base_for``
    searches for delta bases.  Thread-safe: serving sites call it from
    concurrent read sessions; ``packb`` (which copies a device's tensors
    to the host) runs outside the lock and the first finished encoding of
    a version wins.
    """

    def __init__(self, history: int = DELTA_HISTORY):
        self._lock = threading.Lock()
        self._cur: dict[str, tuple[tuple, bytes]] = {}
        self._hist: dict[str, deque] = {}
        self.history = int(history)

    def packed_for(self, key: str, version, params) -> bytes:
        version = tuple(int(v) for v in version)
        with self._lock:
            cur = self._cur.get(key)
            if cur is not None and cur[0] == version:
                return cur[1]
        packed = packb(params)
        with self._lock:
            cur = self._cur.get(key)
            if cur is not None and cur[0] == version:
                return cur[1]
            if cur is not None:
                self._hist.setdefault(
                    key, deque(maxlen=self.history)).append(cur)
            self._cur[key] = (version, packed)
        return packed

    def base_for(self, key: str, version) -> bytes | None:
        version = tuple(int(v) for v in version)
        with self._lock:
            cur = self._cur.get(key)
            if cur is not None and cur[0] == version:
                return cur[1]
            for v, p in reversed(self._hist.get(key, deque())):
                if v == version:
                    return p
        return None


def serve_fetch(cache: WireCache, key: str, params, meta_w, held):
    """``(kind, payload)`` tail of a ``fetched`` reply.

    ``held`` is the client's ``[samples, epochs, round]`` triple or
    ``None`` for an unconditional fetch.  ``params`` is serialized only
    when the reply carries bytes and the cache does not hold them.
    """
    version = tuple(int(v) for v in meta_w)
    if held is not None and tuple(int(v) for v in held) == version:
        return FETCH_NOT_MODIFIED, None
    packed = cache.packed_for(key, version, params)
    if held is not None:
        base = cache.base_for(key, held)
        if base is not None:
            delta = encode_delta(base, packed)
            if delta is not None and len(delta) < _DELTA_MAX_RATIO * len(packed):
                return FETCH_DELTA, delta
    return FETCH_FULL, packed


# ----------------------------------------------------------- read conns

class FetchUnavailable(ConnectionError):
    """Every serving endpoint for the shard failed; the caller falls back
    to the parent store."""


class _ReadConn:
    """One read-only session to a shard server: its first command, a
    ``fetch`` or ``ping``, makes it a concurrent read session (no seed
    handshake)."""

    def __init__(self, addr, connect_timeout: float, io_timeout: float):
        self.sock = socket.create_connection(addr, timeout=connect_timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.settimeout(io_timeout)
        self.lock = threading.Lock()

    def rpc(self, msg) -> tuple[list, int, int]:
        """Returns ``(reply, tx_bytes, rx_bytes)``; replies hold no arrays
        (the snapshot rides as msgpack bytes)."""
        frame = pack_frame(packb(msg), KIND_COMMAND)
        with self.lock:
            self.sock.sendall(frame)
            _kind, payload, _trace = recv_frame(self.sock)
        return unpackb_np(payload), len(frame), 16 + len(payload)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------- fetch client

class FetchClient:
    """Conditional model fetches, served by the shard servers where the
    topology allows.

    ``fetch(level, cluster_key)`` returns ``(params, meta)`` with params
    decoded from the wire bytes onto ``device`` (``None``: CUDA, as the
    entry points).  The client keeps the packed bytes of each key it
    fetched, so a repeat fetch costs a not-modified ack or a delta.

    Serving order per shard is round-robin over ``store.fetch_endpoints()``
    (read replicas, then the shard owner); a failed endpoint is skipped and
    its connection dropped, and when every endpoint fails, the store has
    no TCP servers, or the key is the global model, the parent serves the
    fetch through ``store.fetch_wire`` with the same conditional semantics.

    The endpoint map carries the store's ownership epoch: a fetch that
    finds the epoch moved (a cluster migrated) refreshes the map first,
    and a ``redirect`` reply from a migrated-away owner triggers the same
    refresh and one retry.
    """

    def __init__(self, store, *, device=None, use_workers: bool | None = None,
                 conditional: bool = True, endpoints=None,
                 connect_timeout: float = 5.0, io_timeout: float = 30.0):
        self.store = store
        self.device = resolve_device(device)
        if endpoints is None:
            eps = getattr(store, "fetch_endpoints", None)
            endpoints = eps() if callable(eps) else None
        self._endpoints = endpoints
        if use_workers is None:
            use_workers = endpoints is not None
        self.use_workers = bool(use_workers) and endpoints is not None
        self.conditional = bool(conditional)
        self._global_key = store.model_key("global")
        self._connect_timeout = float(connect_timeout)
        self._io_timeout = float(io_timeout)
        self._lock = threading.Lock()
        self._held: dict[str, tuple[tuple, bytes, object, object]] = {}
        self._conns: dict[tuple[int, int], _ReadConn] = {}
        self._rr: dict[int, int] = {}
        self._endpoint_epoch = self._store_epoch()
        self.tx_bytes = 0
        self.rx_bytes = 0
        self.counts = {"full": 0, "not_modified": 0, "delta": 0,
                       "fallback": 0, "redirects": 0,
                       "endpoint_refreshes": 0}

    # -- wiring -----------------------------------------------------

    def _store_epoch(self) -> int:
        ep = getattr(self.store, "ownership_epoch", None)
        return int(ep()) if callable(ep) else 0

    def refresh_endpoints(self, observed_epoch: int | None = None) -> bool:
        """Re-read the store's endpoint map after an ownership-epoch bump,
        remember the epoch it was read at, and drop every cached
        connection.

        ``observed_epoch`` deduplicates refresh storms: a caller passes the
        endpoint epoch it found stale, and the refresh is skipped when
        another thread already replaced that map.  Returns whether a
        refresh happened (``counts["endpoint_refreshes"]`` tallies them)."""
        with self._lock:
            if (observed_epoch is not None
                    and self._endpoint_epoch != observed_epoch):
                return False
        eps = getattr(self.store, "fetch_endpoints", None)
        endpoints = eps() if callable(eps) else None
        epoch = self._store_epoch()
        with self._lock:
            if (observed_epoch is not None
                    and self._endpoint_epoch != observed_epoch):
                return False    # raced: another caller already refreshed
            if endpoints is not None:
                self._endpoints = endpoints
            self._endpoint_epoch = epoch
            self.counts["endpoint_refreshes"] += 1
            conns, self._conns = dict(self._conns), {}
            self._rr = {}
        for conn in conns.values():
            conn.close()
        return True

    def _conn_for(self, shard: int, slot: int) -> _ReadConn:
        ck = (shard, slot)
        conn = self._conns.get(ck)
        if conn is None:
            conn = _ReadConn(self._endpoints[shard][slot],
                             self._connect_timeout, self._io_timeout)
            self._conns[ck] = conn
        return conn

    def _drop_conn(self, shard: int, slot: int):
        conn = self._conns.pop((shard, slot), None)
        if conn is not None:
            conn.close()

    def _fetch_remote(self, key: str, held):
        last_err: Exception | None = None
        for attempt in range(2):
            # epoch check first: a migration invalidates the captured
            # endpoint map; passing the stale epoch deduplicates the
            # refresh across concurrent fetchers
            captured = self._endpoint_epoch
            if self._store_epoch() != captured:
                self.refresh_endpoints(observed_epoch=captured)
                captured = self._endpoint_epoch     # epoch of the map in use
            shard = self.store.shard_of(key)
            slots = len(self._endpoints[shard])
            start = self._rr.get(shard, 0)
            self._rr[shard] = (start + 1) % slots
            redirected = False
            for i in range(slots):
                slot = (start + i) % slots
                try:
                    reply, tx, rx = self._conn_for(shard, slot).rpc(
                        ["fetch", key, held])
                except (OSError, ConnectionError, TimeoutError) as e:
                    self._drop_conn(shard, slot)
                    last_err = e
                    continue
                self.tx_bytes += tx
                self.rx_bytes += rx
                if reply and reply[0] == "redirect":
                    # migrated-away owner: refresh the map and retry once
                    self.counts["redirects"] += 1
                    last_err = ConnectionError(
                        f"{key!r} migrated to shard {reply[2]} "
                        f"(epoch {reply[3]})")
                    redirected = True
                    break
                if reply and reply[0] == "error":
                    # e.g. a replica that has not mirrored this key yet:
                    # try the next endpoint, then the parent
                    last_err = KeyError(str(reply[2:3]))
                    continue
                return reply[2], reply[3], reply[4]
            if redirected and attempt == 0:
                self.refresh_endpoints(observed_epoch=captured)
                continue
            break
        raise FetchUnavailable(str(last_err))

    # -- public API -------------------------------------------------

    def fetch(self, level: str, cluster_key: str | None = None):
        """``(params, meta)`` of one model, served by a shard server where
        possible.  Unknown models raise ``KeyError`` through the parent,
        which is authoritative for the key space."""
        key = self.store.model_key(level, cluster_key)
        with self._lock:
            h = self._held.get(key)
        held = list(h[0]) if (self.conditional and h is not None) else None
        kind = payload = meta_w = None
        if self.use_workers and key != self._global_key:
            try:
                kind, payload, meta_w = self._fetch_remote(key, held)
            except FetchUnavailable:
                self.counts["fallback"] += 1
        if meta_w is None:
            kind, payload, meta_w = self.store.fetch_wire(
                level, cluster_key, held=held)
        params, meta, packed = self._decode(key, kind, payload, meta_w, h)
        with self._lock:
            self._held[key] = (tuple(int(v) for v in meta_w), packed,
                               params, meta)
            self.counts[("full", "not_modified", "delta")[kind]] += 1
        return params, meta

    def _decode(self, key, kind, payload, meta_w, h):
        if kind == FETCH_NOT_MODIFIED:
            if h is None:
                raise ValueError(f"not-modified for {key!r} but nothing held")
            return h[2], h[3], h[1]
        if kind == FETCH_DELTA:
            if h is None:
                raise ValueError(f"delta for {key!r} but nothing held")
            packed = apply_delta(h[1], payload)
        else:
            packed = payload
        meta = ModelMeta(int(meta_w[0]), int(meta_w[1]), int(meta_w[2]))
        return unpackb(packed, self.device), meta, packed

    def close(self):
        with self._lock:
            conns, self._conns = dict(self._conns), {}
        for conn in conns.values():
            conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
