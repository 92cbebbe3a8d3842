"""Worker transports: the parent's view of a shard server, anywhere.

The process and TCP server tier (``repro_torch.core.store.
ProcessShardedModelStore``) talks to its shard workers only through the
small interface defined here: ``put`` (fire-and-forget submit), ``rpc`` /
``rpc_recv`` (one replying command, bounded), ``restart`` (reset the worker
from a fresh seed blob so the parent can replay its journal),
``alive``/``kill``/``discard``/``stop``.  Three flavours implement it:

  * ``InprocessWorkerHandle`` (``repro_torch.core.server_proc``): the
    deterministic in-process emulation the sim runtime uses;
  * ``ProcessWorkerHandle`` (``repro_torch.core.server_proc``): spawned
    worker processes on ``multiprocessing`` queues;
  * ``TcpWorkerHandle`` (here): a standalone shard server
    (``repro_torch.launch.shard_server``) reached over a TCP socket.

Every payload uses the checkpoint codec
(``repro_torch.checkpoint.msgpack_ckpt``), whose bytes equal the
reference's, and every TCP frame is wire version 4, byte for byte the
reference's (``docs/WIRE_PROTOCOL.md``).  So a JAX parent can drive torch
shard servers and a torch parent JAX ones.

Frame layout (all integers big-endian):

    offset  size  field
    0       2     magic      b"FC"
    2       1     version    0x04
    3       1     kind       0x00 command (parent->worker),
                             0x01 reply   (worker->parent)
    4       4     length     payload byte length (u32)
    8       8     trace_ctx  telemetry trace context (u64; the port sends
                             0, as the reference does with telemetry off)
    16      len   payload    msgpack message

Each (re)connect sends ``["seed", shard_idx, seed_blob]`` and waits for
``["seeded", shard_idx]``: the worker rebuilds its state from the parent's
mirrors, then the parent replays its journal of unacked updates, which the
worker deduplicates by update ``seq``.
"""

from __future__ import annotations

import os
import pathlib
import select
import socket
import struct
import subprocess
import sys
import threading
import time

from repro_torch.checkpoint.msgpack_ckpt import packb
from repro_torch.checkpoint.msgpack_ckpt import unpackb_np

FRAME_MAGIC = b"FC"
WIRE_VERSION = 4
KIND_COMMAND = 0x00
KIND_REPLY = 0x01
_HEADER = struct.Struct(">2sBBIQ")      # magic, version, kind, length,
HEADER_SIZE = _HEADER.size              # trace_ctx: 16 bytes
MAX_FRAME_BYTES = 1 << 31               # sanity bound on declared lengths


class WorkerUnavailable(RuntimeError):
    """The shard worker died (or was never reachable) mid-command."""


class WorkerTimeout(WorkerUnavailable):
    """The shard worker is alive but missed the bounded reply deadline."""


class FrameProtocolError(RuntimeError):
    """The peer sent bytes that are not a FedCCL wire frame."""


class FrameVersionError(FrameProtocolError):
    """The peer speaks another wire version: refuse instead of unpacking
    garbage params."""


# -------------------------------------------------------------------- frames

def pack_frame(payload: bytes, kind: int = KIND_COMMAND,
               trace_ctx: int = 0) -> bytes:
    """One wire frame, header then payload."""
    return _HEADER.pack(FRAME_MAGIC, WIRE_VERSION, kind, len(payload),
                        trace_ctx) + payload


def parse_header(header: bytes) -> tuple[int, int, int]:
    """Validate a 16-byte frame header; returns (kind, payload_length,
    trace_ctx).  Raises ``FrameProtocolError`` / ``FrameVersionError``."""
    magic, version, kind, length, trace_ctx = _HEADER.unpack(header)
    if magic != FRAME_MAGIC:
        raise FrameProtocolError(
            f"not a FedCCL frame (magic {magic!r}, expected {FRAME_MAGIC!r})")
    if version != WIRE_VERSION:
        raise FrameVersionError(
            f"peer speaks wire version {version}, this build speaks "
            f"{WIRE_VERSION} — upgrade the older side (frames are not "
            f"cross-version compatible; see docs/WIRE_PROTOCOL.md)")
    if kind not in (KIND_COMMAND, KIND_REPLY):
        raise FrameProtocolError(f"unknown frame kind 0x{kind:02x}")
    if length > MAX_FRAME_BYTES:
        raise FrameProtocolError(f"frame length {length} exceeds sanity "
                                 f"bound {MAX_FRAME_BYTES}")
    return kind, length, trace_ctx


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed the connection mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def send_frame(sock: socket.socket, payload: bytes,
               kind: int = KIND_COMMAND, trace_ctx: int = 0) -> int:
    """Write one frame; returns bytes put on the wire."""
    frame = pack_frame(payload, kind, trace_ctx)
    sock.sendall(frame)
    return len(frame)


def recv_frame(sock: socket.socket) -> tuple[int, bytes, int]:
    """Read one frame; returns (kind, payload, trace_ctx).  Raises
    ``ConnectionError`` on EOF, ``TimeoutError`` on the socket's deadline
    and the frame errors above on malformed bytes."""
    kind, length, trace_ctx = parse_header(_recv_exact(sock, HEADER_SIZE))
    return kind, (_recv_exact(sock, length) if length else b""), trace_ctx


def parse_host(spec: str) -> tuple[str, int]:
    """``"host:port"`` -> ``(host, port)`` (IPv6 literals in brackets)."""
    s = str(spec).strip()
    if s.startswith("["):                         # [::1]:9000
        host, _, rest = s[1:].partition("]")
        port = rest.lstrip(":")
    else:
        host, _, port = s.rpartition(":")
    if not host or not port:
        raise ValueError(f"server host {spec!r} is not 'host:port'")
    return host, int(port)


# ------------------------------------------------------------ loopback spawn

class LoopbackShardServers:
    """Spawn N standalone shard servers (``python -m
    repro_torch.launch.shard_server``) on loopback ephemeral ports, each
    folding on ``device``; ``hosts`` feeds ``FedCCLConfig.server_hosts``.

    The helper is the servers' supervisor for local runs: ``kill`` /
    ``respawn`` inject and recover crashes (respawn reuses the port, so
    the parent's reconnect finds the fresh server), and the context
    manager stops them all.  A CUDA server loads the kernel library before
    it announces its port, so ``startup_timeout`` covers the cold start
    (interpreter, torch import, CUDA context, library load).
    """

    def __init__(self, n: int, *, device: str = "cuda",
                 startup_timeout: float = 120.0):
        self.device = str(device)
        self.startup_timeout = float(startup_timeout)
        self._src = str(pathlib.Path(__file__).resolve().parents[2])
        self.procs: list = [None] * n
        self.ports: list[int] = [0] * n
        self.startup_s: list[float] = [0.0] * n
        try:
            # start every server, then wait for each: cold starts overlap
            started = [self._launch(i, port=0) for i in range(n)]
            for i, t0 in enumerate(started):
                self._await_announce(i, t0)
        except BaseException:
            self.close()
            raise

    def _launch(self, i: int, port: int) -> float:
        env = dict(os.environ)
        env["PYTHONPATH"] = self._src + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        t0 = time.monotonic()
        self.procs[i] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.shard_server",
             "--host", "127.0.0.1", "--port", str(port),
             "--device", self.device],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=env)
        return t0

    def _await_announce(self, i: int, t0: float):
        proc = self.procs[i]
        deadline = t0 + self.startup_timeout
        line = ""
        while True:
            if time.monotonic() >= deadline:
                proc.kill()
                proc.wait(10.0)
                raise RuntimeError(
                    f"shard server {i} did not announce within "
                    f"{self.startup_timeout:.0f}s")
            # select-gate the pipe: a bare readline() would block past the
            # deadline on a server that hangs before announcing
            ready, _, _ = select.select([proc.stdout], [], [], 0.25)
            if not ready:
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"shard server {i} exited with {proc.returncode} "
                        f"before listening")
                continue
            line = proc.stdout.readline()
            if "SHARD_SERVER_LISTENING" in line:
                break
            if not line and proc.poll() is not None:
                raise RuntimeError(
                    f"shard server {i} exited with {proc.returncode} "
                    f"before listening")
        self.ports[i] = int(line.rsplit("port=", 1)[1])
        self.startup_s[i] = time.monotonic() - t0

    @property
    def hosts(self) -> list[str]:
        """``FedCCLConfig.server_hosts``-shaped addresses."""
        return [f"127.0.0.1:{p}" for p in self.ports]

    @property
    def pids(self) -> list[int]:
        return [p.pid for p in self.procs]

    def kill(self, i: int):
        """SIGKILL one server: the crash-injection hook."""
        self.procs[i].kill()
        self.procs[i].wait(10.0)

    def respawn(self, i: int):
        """Restart on the same port, so the parent's journaled reconnect
        finds the fresh server at the old address."""
        if self.procs[i].poll() is None:
            self.kill(i)
        self._await_announce(i, self._launch(i, port=self.ports[i]))

    def close(self):
        for proc in self.procs:
            if proc is not None and proc.poll() is None:
                proc.terminate()
        for proc in self.procs:
            if proc is not None:
                try:
                    proc.wait(10.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(10.0)
                if proc.stdout is not None:
                    proc.stdout.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ----------------------------------------------------------------- interface

class Transport:
    """One shard server, as the parent store sees it.

      * ``put(raw)``: fire-and-forget command; never raises on a dead
        worker (the journal keeps the update; the next replying command
        surfaces the failure and triggers recovery).
      * ``rpc(raw, timeout)`` / ``rpc_recv(timeout)``: one replying command
        (callers serialize per shard through the store's rpc lock); raises
        ``WorkerUnavailable`` if the worker is gone and ``WorkerTimeout``
        if it misses the deadline.
      * ``restart(seed_blob)``: reset the worker from the parent's mirrors;
        the caller replays its journal right after.
      * ``spawns``: (re)starts so far; ``tx_bytes`` / ``rx_bytes``: payload
        bytes sent and received.
    """

    idx: int
    spawns: int = 0
    tx_bytes: int = 0
    rx_bytes: int = 0

    def put(self, raw: bytes):
        raise NotImplementedError

    def rpc(self, raw: bytes, timeout: float) -> bytes:
        raise NotImplementedError

    def rpc_recv(self, timeout: float) -> bytes:
        raise NotImplementedError

    def restart(self, seed_blob: bytes):
        raise NotImplementedError

    def alive(self) -> bool:
        raise NotImplementedError

    def kill(self):
        raise NotImplementedError

    def discard(self):
        raise NotImplementedError

    def stop(self, timeout: float):
        raise NotImplementedError


# ---------------------------------------------------------------- tcp flavor

class TcpWorkerHandle(Transport):
    """Parent-side endpoint of a standalone shard server.

    The socket carries the messages the process queues carry, in frames.
    Sends take a lock (submit threads share one socket); receives happen
    only on the replying-command paths, which the store serializes per
    shard.  Any socket error marks the connection broken: ``put`` never
    raises, the next ``rpc``/``rpc_recv`` raises ``WorkerUnavailable``, and
    the store calls ``restart``: reconnect (with bounded retry, so a
    server restarted on the same address is picked up), re-seed, then
    journal replay, made idempotent by the worker's held-seq dedup.
    """

    def __init__(self, shard_idx: int, seed_blob: bytes, address,
                 connect_timeout: float = 30.0):
        self.idx = shard_idx
        self.address = (address if isinstance(address, tuple)
                        else parse_host(address))
        self.connect_timeout = float(connect_timeout)
        self.spawns = 0
        self.tx_bytes = 0
        self.rx_bytes = 0
        self._send_lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._broken = True
        self._start(seed_blob)

    def _where(self) -> str:
        return f"shard server {self.address[0]}:{self.address[1]}"

    # ------------------------------------------------------------- lifecycle
    def _start(self, seed_blob: bytes):
        deadline = time.monotonic() + self.connect_timeout
        while True:
            try:
                sock = socket.create_connection(self.address, timeout=5.0)
                break
            except OSError as e:
                if time.monotonic() >= deadline:
                    raise WorkerUnavailable(
                        f"{self._where()} unreachable within "
                        f"{self.connect_timeout:.0f}s: {e}") from e
                time.sleep(0.2)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._broken = False
        # handshake: seed the worker from the parent mirrors and wait for
        # the ack, so connect failures surface here, not on the first drain
        try:
            self._send(packb(["seed", self.idx, seed_blob]))
            reply = unpackb_np(self._recv(self.connect_timeout))
        except WorkerUnavailable:
            raise
        except Exception as e:
            self._mark_broken()
            raise WorkerUnavailable(
                f"{self._where()} failed the seed handshake: "
                f"{type(e).__name__}: {e}") from e
        if reply[0] == "error":
            self._mark_broken()
            raise WorkerUnavailable(
                f"{self._where()} rejected the seed: {reply[2]}")
        if reply[0] != "seeded" or int(reply[1]) != self.idx:
            self._mark_broken()
            raise WorkerUnavailable(
                f"{self._where()} answered the seed with {reply[:2]!r}")
        self.spawns += 1

    def _mark_broken(self):
        self._broken = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # ----------------------------------------------------------------- wire
    def _send(self, raw: bytes):
        with self._send_lock:
            # local capture: a concurrent _mark_broken (the receive side
            # holds no send lock) may clear self._sock between check and use
            sock = self._sock
            if self._broken or sock is None:
                raise WorkerUnavailable(f"{self._where()} connection is down")
            try:
                self.tx_bytes += send_frame(sock, raw, KIND_COMMAND)
            except OSError as e:
                self._mark_broken()
                raise WorkerUnavailable(
                    f"send to {self._where()} failed: {e}") from e

    def _recv(self, timeout: float) -> bytes:
        sock = self._sock                  # local capture, as in _send
        if self._broken or sock is None:
            raise WorkerUnavailable(f"{self._where()} connection is down")
        try:
            sock.settimeout(max(timeout, 1e-3))
            kind, payload, _ = recv_frame(sock)
        except TimeoutError:
            raise WorkerTimeout(
                f"{self._where()} missed the {timeout:.1f}s reply "
                f"deadline") from None
        except (ConnectionError, OSError, FrameProtocolError) as e:
            self._mark_broken()
            raise WorkerUnavailable(
                f"recv from {self._where()} failed: "
                f"{type(e).__name__}: {e}") from e
        if kind != KIND_REPLY:
            self._mark_broken()
            raise WorkerUnavailable(
                f"{self._where()} sent a command frame where a reply was "
                f"expected")
        self.rx_bytes += HEADER_SIZE + len(payload)
        return payload

    # ------------------------------------------------------------- interface
    def put(self, raw: bytes):
        try:
            self._send(raw)
        except WorkerUnavailable:
            pass        # journaled; the next replying command recovers

    def rpc(self, raw: bytes, timeout: float) -> bytes:
        self._send(raw)
        return self._recv(timeout)

    def rpc_recv(self, timeout: float) -> bytes:
        return self._recv(timeout)

    def restart(self, seed_blob: bytes):
        """Reconnect and re-seed; the server process is managed elsewhere,
        and one restarted on the same address is picked up."""
        self._mark_broken()
        self._start(seed_blob)

    def alive(self) -> bool:
        return not self._broken

    def kill(self):
        """Drop the connection (crash injection): the server survives,
        only this session ends."""
        self._mark_broken()

    def discard(self):
        self._mark_broken()

    def stop(self, timeout: float):
        """End the session: the server replies and goes back to accepting
        the next parent; it is not shut down."""
        try:
            reply = unpackb_np(self.rpc(packb(["stop"]), timeout))
            if reply[0] != "stopped":
                raise WorkerUnavailable(
                    f"{self._where()} answered stop with {reply[0]!r}")
        except WorkerUnavailable:
            pass
        finally:
            self._mark_broken()
