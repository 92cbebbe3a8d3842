"""Standalone shard server: one federation worker, folding on its device.

Runs ``repro_torch.core.server_proc.ShardWorker`` behind a TCP listener
speaking wire v4 (``repro_torch.core.transport``; the normative spec is
``docs/WIRE_PROTOCOL.md``).  A parent ``ProcessShardedModelStore`` with
``server_hosts=["host:port", ...]`` connects to one of these per entry,
and so does a JAX parent (``repro``'s store): the frames are the same
bytes.

Usage:

    PYTHONPATH=src python -m repro_torch.launch.shard_server --port 9701
    PYTHONPATH=src python -m repro_torch.launch.shard_server --port 0 \\
        --device cuda          # ephemeral port, folds on the card

The device is a command-line choice of the server, never part of the seed
blob: the parent's blob is the same for a CPU and a CUDA server.  A CUDA
server loads the kernel library before it listens; asked for CUDA where
there is none, it exits with an error.  On startup it prints one line:

    SHARD_SERVER_LISTENING host=127.0.0.1 port=9701

Each connection is classified by its first command:

* ``fetch`` / ``ping`` opens a read session: any number run at once,
  serving conditional fetches off the worker's published snapshots;
* anything else opens the command session, one at a time (a server-wide
  lock), beginning with ``seed``, which rebuilds the worker from the
  parent's mirrors.  The parent's ``stop`` (or a dropped connection) ends
  the session; ``shutdown`` ends the server.
"""

from __future__ import annotations

import argparse
import socket
import sys
import threading

from repro_torch.checkpoint.msgpack_ckpt import packb, unpackb_np
from repro_torch.core.server_proc import REPLY_OPS, ShardWorker, load_kernels
from repro_torch.core.transport import (
    KIND_REPLY,
    FrameProtocolError,
    recv_frame,
    send_frame,
)
from repro_torch.obs.record import trace_scope
from repro_torch.utils.device import resolve_device

#: ops whose first appearance on a fresh connection opens a concurrent
#: read session instead of the exclusive command session
READ_OPS = frozenset({"fetch", "ping"})

#: how long a would-be command session waits for the exclusive lock
_COMMAND_LOCK_TIMEOUT_S = 600.0


class _ServerState:
    """Shared between the accept loop and every session thread."""

    def __init__(self, device):
        self.device = device
        self.worker: ShardWorker | None = None
        self.command_lock = threading.Lock()
        self.stop = threading.Event()


def _recv_or_report(conn: socket.socket):
    """One frame, or ``None`` after answering a malformed or mismatched
    frame with an error (a desynced stream cannot be trusted)."""
    try:
        return recv_frame(conn)
    except FrameProtocolError as e:
        try:
            send_frame(conn, packb(["error", "frame", str(e)]), KIND_REPLY)
        except OSError:
            pass
        return None
    except (ConnectionError, OSError):
        return None


def serve_session(state: _ServerState, conn: socket.socket,
                  first=None) -> bool:
    """One command session: seed handshake, then the dispatch loop.
    Returns False if the parent asked the server to exit (``shutdown``),
    True to keep listening."""
    while True:
        if first is not None:
            raw, trace_ctx, first = first[1], first[2], None
        else:
            got = _recv_or_report(conn)
            if got is None:
                return True                  # parent went away; next session
            raw, trace_ctx = got[1], got[2]
        worker = state.worker
        msg = (worker.decode(raw) if worker is not None
               else unpackb_np(raw))
        op = msg[0]
        if op == "seed":
            # (re)build the worker from the parent's mirrors; replays that
            # follow are deduplicated by its held-seq set.  Read sessions
            # pick the new worker up on their next command.
            try:
                state.worker = ShardWorker(int(msg[1]), msg[2], state.device)
                reply = ["seeded", state.worker.idx]
            except Exception as e:
                reply = ["error", "seed", f"{type(e).__name__}: {e}"]
            send_frame(conn, packb(reply), KIND_REPLY)
            continue
        if op == "shutdown":
            send_frame(conn, packb(["stopped", -1]), KIND_REPLY)
            return False
        if worker is None:
            send_frame(conn, packb(
                ["error", op, "session not seeded: the first command of a "
                              "connection must be 'seed'"]), KIND_REPLY)
            continue
        if op == "stop":
            send_frame(conn, packb(["stopped", worker.idx]), KIND_REPLY)
            return True
        try:
            # the frame's trace context, restored around the dispatch: spans
            # the worker records join the originating submit's chain
            with trace_scope(trace_ctx):
                reply = worker.handle(msg)
        except Exception as e:
            reply = ["error", op, f"{type(e).__name__}: {e}"]
            if op not in REPLY_OPS:          # deferred, as in worker_main
                worker.pending_errors.append(
                    f"{op}: {type(e).__name__}: {e}")
        if op in REPLY_OPS:
            send_frame(conn, packb(reply), KIND_REPLY)


def serve_read_session(state: _ServerState, conn: socket.socket,
                       first) -> None:
    """One read-only session: conditional fetches and pings, served
    concurrently with the command session and each other off the
    published snapshots (never through ``ShardWorker.handle``)."""
    while True:
        if first is not None:
            raw, trace_ctx, first = first[1], first[2], None
        else:
            got = _recv_or_report(conn)
            if got is None:
                return
            raw, trace_ctx = got[1], got[2]
        msg = unpackb_np(raw)
        op = msg[0]
        worker = state.worker
        try:
            if op not in READ_OPS:
                reply = ["error", op,
                         "read session: only fetch/ping are allowed here "
                         "(open a new connection starting with 'seed' for "
                         "a command session)"]
            elif worker is None:
                reply = ["error", op, "server not seeded yet"]
            elif op == "fetch":
                with trace_scope(trace_ctx):
                    reply = worker.fetch(msg[1],
                                         msg[2] if len(msg) > 2 else None)
            else:                            # ping
                reply = ["pong", worker.idx, sorted(worker.records)]
        except Exception as e:
            reply = ["error", op, f"{type(e).__name__}: {e}"]
        try:
            send_frame(conn, packb(reply), KIND_REPLY)
        except OSError:
            return


def _session_thread(state: _ServerState, srv: socket.socket,
                    conn: socket.socket) -> None:
    try:
        with conn:
            first = _recv_or_report(conn)
            if first is None:
                return
            if unpackb_np(first[1])[0] in READ_OPS:
                serve_read_session(state, conn, first)
                return
            if not state.command_lock.acquire(
                    timeout=_COMMAND_LOCK_TIMEOUT_S):
                send_frame(conn, packb(
                    ["error", "session",
                     "another command session is active"]), KIND_REPLY)
                return
            try:
                keep_going = serve_session(state, conn, first)
            finally:
                state.command_lock.release()
            if not keep_going:
                state.stop.set()
                # close() alone leaves accept() blocked in the serving
                # thread (Linux); shutdown() wakes it
                try:
                    srv.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                srv.close()
    except (ConnectionError, OSError):
        pass


def serve(host: str, port: int, announce=print, device="cuda") -> None:
    """Listen on ``host:port`` (0: an ephemeral port) and serve until a
    ``shutdown`` command; the worker folds on ``device``.  ``announce`` is
    called once with the listening line (and ``flush=True``)."""
    device = resolve_device(device)
    load_kernels(device)
    state = _ServerState(device)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(128)
    bound = srv.getsockname()
    announce(f"SHARD_SERVER_LISTENING host={bound[0]} port={bound[1]}",
             flush=True)
    try:
        while not state.stop.is_set():
            try:
                conn, _peer = srv.accept()
            except OSError:
                break                        # listener closed by shutdown
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=_session_thread,
                             args=(state, srv, conn), daemon=True).start()
    finally:
        try:
            srv.close()
        except OSError:
            pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="FedCCL standalone shard server, PyTorch port (wire v4; "
                    "see docs/WIRE_PROTOCOL.md and docs/OPERATIONS.md)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (default loopback; use 0.0.0.0 to "
                         "serve other hosts)")
    ap.add_argument("--port", type=int, default=9701,
                    help="bind port; 0 picks an ephemeral port (announced "
                         "on stdout)")
    ap.add_argument("--device", default="cuda",
                    help="where the worker folds: cuda (default; the "
                         "fedavg_agg kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    serve(args.host, args.port, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
