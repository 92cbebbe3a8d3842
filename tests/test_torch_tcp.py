"""The port's TCP server tier against the JAX package's: wire v4 frames
against the golden bytes of ``tests/test_wire_protocol.py``, mixed fleets
over loopback in both directions (a JAX parent driving torch shard
servers, a torch parent driving JAX ones), worker-served fetches, a read
replica behind an ordered barrier, a redirect storm after a migration, a
reconnect with journal replay, the threaded runtime with the read tier,
and a server that exits on ``shutdown``.

Frames must equal the golden bytes exactly.  Folds across packages and
transports: atol 1e-5, the reference's tolerance for its store
equivalence (``tests/test_store_equivalence.py``); metas and the fold
schedule's stats exact.  Fetched params equal the store's own read byte
for byte.

The loopback servers (``loopback`` fixture) are two port servers on the
CPU and two of the reference's, started once for this file with one
torch thread each; every test that talks to them holds a deadline of its
own (``deadline``) besides the transport's timeouts.
"""

import signal
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import store as jstore
from repro.core import transport as jtransport
from repro_torch.checkpoint.msgpack_ckpt import packb, unpackb_np
from repro_torch.core import aggregation as agg
from repro_torch.core import store as tstore
from repro_torch.core import transport
from repro_torch.core.fedccl import ClusterSpaceConfig, FedCCL, FedCCLConfig
from repro_torch.core.fetch import FetchClient
from repro_torch.core.protocol import ClientSpec
from repro_torch.core.transport import (
    HEADER_SIZE,
    KIND_COMMAND,
    KIND_REPLY,
    FrameProtocolError,
    FrameVersionError,
    pack_frame,
    parse_header,
    parse_host,
    recv_frame,
    send_frame,
)
from repro_torch.launch import shard_server

from test_torch_federation import scalar_train_fn, specs_for

ATOL = 1e-5
GLOBAL = tstore.GLOBAL_KEY
NOFAST = agg.AggregationConfig(sequential_fast_path=False)
SPACE = dict(eps=100.0, min_samples=2, metric="haversine")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hdr(version: int, kind: int, length: int, trace: int = 0) -> bytes:
    """The spec's header by hand, as ``tests/test_wire_protocol.py``
    writes it."""
    return (b"FC" + bytes([version, kind]) + length.to_bytes(4, "big")
            + trace.to_bytes(8, "big"))


@pytest.fixture
def deadline():
    """Fail a test that talks to server processes after 120 s instead of
    letting it hang the run."""
    def expire(signum, frame):
        raise TimeoutError("the test's 120 s deadline passed")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def loopback():
    """Two port shard servers (``--device cpu``) and two of the
    reference's, on loopback ephemeral ports, for this file's tests; each
    new store connection re-seeds its server.  Yields (torch hosts, JAX
    hosts)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with transport.LoopbackShardServers(2, device="cpu",
                                            startup_timeout=90.0) as ts, \
                jtransport.LoopbackShardServers(2, startup_timeout=90.0) \
                as js:
            yield ts.hosts, js.hosts


def np_tree(rng):
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


def torch_tree(t):
    return {k: torch.from_numpy(v.copy()) for k, v in t.items()}


def jax_tree(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def model_lks(keys):
    return [("global", None)] + [("cluster", k) for k in keys]


# ------------------------------------------------------------------ frames
@pytest.mark.parametrize("payload,kind,trace", [
    (b"hello", KIND_COMMAND, 0), (b"", KIND_REPLY, 0),
    (b"\x00" * 300, KIND_COMMAND, (1 << 64) - 1),
    (packb(["fetch", "c0", [5, 1, 2]]), KIND_COMMAND, 0),
    (packb(["pong", 1, ["c0", "c1"]]), KIND_REPLY, 42)])
def test_frames_equal_the_golden_bytes(payload, kind, trace):
    frame = pack_frame(payload, kind, trace)
    assert frame == _hdr(4, kind, len(payload), trace) + payload
    assert frame == jtransport.pack_frame(payload, kind, trace)
    assert len(frame) - len(payload) == HEADER_SIZE == 16
    assert parse_header(frame[:16]) == (kind, len(payload), trace)
    assert transport.WIRE_VERSION == jtransport.WIRE_VERSION == 4
    assert transport.FRAME_MAGIC == jtransport.FRAME_MAGIC == b"FC"


@pytest.mark.parametrize("header,error,match", [
    (b"XX" + _hdr(4, 0, 1)[2:], FrameProtocolError, "not a FedCCL frame"),
    (_hdr(3, 0, 1), FrameVersionError, "wire version 3"),
    (_hdr(5, 0, 1), FrameVersionError, "wire version 5"),
    (_hdr(4, 7, 1), FrameProtocolError, "unknown frame kind 0x07"),
    (_hdr(4, 0, (1 << 31) + 1), FrameProtocolError, "exceeds sanity")],
    ids=["magic", "v3", "v5", "kind", "oversize"])
def test_malformed_headers_are_refused(header, error, match):
    with pytest.raises(error, match=match):
        parse_header(header)
    with pytest.raises(getattr(jtransport, error.__name__), match=match):
        jtransport.parse_header(header)


def test_send_recv_frame_over_socketpair():
    a, b = socket.socketpair()
    with a, b:
        assert send_frame(a, b"abc", KIND_REPLY, 7) == 19
        assert recv_frame(b) == (KIND_REPLY, b"abc", 7)
        a.sendall(_hdr(3, 0, 0))                     # a v3 peer
        with pytest.raises(FrameVersionError):
            recv_frame(b)
        a.close()
        with pytest.raises(ConnectionError):
            recv_frame(b)


@pytest.mark.parametrize("spec,want", [
    ("127.0.0.1:9701", ("127.0.0.1", 9701)), ("host:1", ("host", 1)),
    (" [::1]:9000 ", ("::1", 9000))])
def test_parse_host_matches_reference(spec, want):
    assert parse_host(spec) == jtransport.parse_host(spec) == want
    for bad in ("nohost", ":9", "host:"):
        with pytest.raises(ValueError):
            parse_host(bad)


# -------------------------------------------------------------- mixed fleet
def run_schedule(store, events, port):
    tree, meta, delta = ((torch_tree, agg.ModelMeta, agg.UpdateDelta) if port
                         else (jax_tree, jagg.ModelMeta, jagg.UpdateDelta))
    for key, t, s in events:
        p = tree(t)
        store.handle_model_update("cluster", key, p, meta(s, 1, 1),
                                  delta(s, 1, 1))
        store.handle_model_update("global", None, p, meta(s, 1, 1),
                                  delta(s, 1, 1))
    store.drain_all()


@pytest.mark.parametrize("parent", ["jax", "torch"])
def test_mixed_fleet_folds_equal(parent, loopback, deadline):
    """A JAX parent drives the port's servers, and a torch parent the
    reference's, each beside the same parent on its own package's
    servers: folds equal within 1e-5, metas equal, and every stat equal,
    the bytes on the wire included."""
    torch_hosts, jax_hosts = loopback
    rng = np.random.default_rng(5 if parent == "jax" else 6)
    init = np_tree(rng)
    keys = ["c0", "c1", "c2"]
    events = [(keys[i % 3], np_tree(rng), int(rng.integers(1, 50)))
              for i in range(24)]
    kw = dict(batch_aggregation=True, max_coalesce=5)
    if parent == "jax":
        mixed, same = (jstore.ProcessShardedModelStore(
            jax_tree(init), keys, server_hosts=hosts, **kw)
            for hosts in (torch_hosts, jax_hosts))
    else:
        mixed, same = (tstore.ProcessShardedModelStore(
            torch_tree(init), keys, server_hosts=hosts, device="cpu", **kw)
            for hosts in (jax_hosts, torch_hosts))
    try:
        for store in (mixed, same):
            run_schedule(store, events, parent == "torch")
        for lk in model_lks(keys):
            assert mixed.meta(*lk) == same.meta(*lk), lk
            got, want = mixed.params(*lk), same.params(*lk)
            for leaf in want:
                np.testing.assert_allclose(np.asarray(got[leaf]),
                                           np.asarray(want[leaf]), atol=ATOL)
        stats = mixed.agg_stats()
        assert stats == same.agg_stats()
        assert stats["transport"] == "tcp" and stats["respawns"] == 0
        assert stats["updates"] == 48 and stats["global_drains"] == 1
    finally:
        mixed.close()
        same.close()


# ----------------------------------------------------------------- reads
def tcp_store(hosts, keys, rng, **kw):
    return tstore.ProcessShardedModelStore(
        torch_tree(np_tree(rng)), keys, agg_cfg=NOFAST, server_hosts=hosts,
        batch_aggregation=True, device="cpu", **kw)


def assert_fetch_matches_store(fc, store, lks):
    for lk in lks:
        p1, m1 = fc.fetch(*lk)
        p2, m2 = store.request_model(*lk)
        assert m1 == m2, lk
        assert packb(p1) == packb(p2), lk


def submit_round(store, keys, rng, rnd):
    for key in keys:
        store.handle_model_update("cluster", key, torch_tree(np_tree(rng)),
                                  agg.ModelMeta(5, 1, rnd),
                                  agg.UpdateDelta(5, 1, 1))
    store.handle_model_update("global", None, torch_tree(np_tree(rng)),
                              agg.ModelMeta(5, 1, rnd),
                              agg.UpdateDelta(5, 1, 1))
    store.drain_all()


def test_worker_served_fetch_byte_identical(loopback, deadline):
    """Fetches served by the port servers' read sessions equal the
    parent's reads byte for byte; repeats are not-modified acks, a moved
    version comes as a delta or in full, the global model stays
    parent-served, and nothing falls back."""
    rng = np.random.default_rng(23)
    keys = [f"c{i}" for i in range(4)]
    lks = model_lks(keys)
    with tcp_store(loopback[0], keys, rng) as store:
        submit_round(store, keys, rng, 1)
        with FetchClient(store, device="cpu") as fc:
            assert fc.use_workers
            assert_fetch_matches_store(fc, store, lks)
            assert fc.counts["full"] == len(lks)
            assert_fetch_matches_store(fc, store, lks)
            assert fc.counts["not_modified"] == len(lks)
            submit_round(store, keys, rng, 2)
            assert_fetch_matches_store(fc, store, lks)
            assert fc.counts["full"] + fc.counts["delta"] + \
                fc.counts["not_modified"] == 3 * len(lks)
            assert fc.counts["fallback"] == 0
            assert fc.tx_bytes > 0 and fc.rx_bytes > 0


def test_replica_served_fetch_after_an_ordered_barrier(loopback, deadline):
    """``owner|replica``: the parent pushes each folded mirror to the
    replica as a fire-and-forget command on the replica's command session,
    so a fetch on another connection can overtake the push (the race of
    the reference's replica test, ROADMAP.md §3).  A replying command on
    that same session returns only after the pushes before it: after it,
    the replica serves exactly the store's params, and so does the owner
    (round-robin).  A dropped replica session counts a dropped push and is
    reconnected and re-seeded."""
    rng = np.random.default_rng(41)
    owner, replica = loopback[0]
    with tcp_store([f"{owner}|{replica}"], ["c0", "c1"], rng) as store:
        assert store.fetch_endpoints() == [[parse_host(replica),
                                            parse_host(owner)]]
        sh = store._proc_shards[0]

        def barrier():
            for h in sh.replicas:
                assert unpackb_np(h.rpc(packb(["ping"]), 30.0))[0] == "pong"

        for rnd in (1, 2):
            submit_round(store, ["c0", "c1"], rng, rnd)
        assert store.agg_stats()["replica_pushes"] >= 2
        barrier()
        lks = [("cluster", "c0"), ("cluster", "c1")]
        with FetchClient(store, conditional=False, device="cpu") as fc:
            for _ in range(2):                   # replica, then owner
                assert_fetch_matches_store(fc, store, lks)
            assert fc.counts["full"] == 4 and fc.counts["fallback"] == 0
            assert len(fc._conns) == 2           # both endpoints served
            sh.replicas[0].kill()                # drop the replica session
            submit_round(store, ["c0", "c1"], rng, 3)
            stats = store.agg_stats()
            assert stats["replica_drops"] >= 1   # counted, not fatal
            barrier()                            # reconnected and re-seeded
            assert_fetch_matches_store(fc, store, lks)
            assert fc.counts["fallback"] == 0


def test_redirect_storm_refreshes_the_endpoints_once(loopback, deadline):
    """A cluster migrates, then 12 threads fetch it 4 times each: every
    fetch serves the new owner's bytes, the endpoint map is rebuilt once,
    and nothing falls back to the parent."""
    rng = np.random.default_rng(4)
    with tcp_store(loopback[0], ["c0", "c1"], rng, max_coalesce=5) as store:
        store.handle_model_update("cluster", "c0", torch_tree(np_tree(rng)),
                                  agg.ModelMeta(5, 1, 1),
                                  agg.UpdateDelta(5, 1, 1))
        assert store.drain("cluster", "c0") == 1
        with FetchClient(store, device="cpu") as fc:
            _, m0 = fc.fetch("cluster", "c0")
            assert m0.round == 1 and fc.counts["endpoint_refreshes"] == 0
            store.migrate_cluster("c0", 1 - store.shard_of("c0"))
            want = packb(store.request_model("cluster", "c0")[0])
            errors = []
            start = threading.Barrier(12)

            def fetcher():
                start.wait(30.0)
                try:
                    for _ in range(4):
                        params, meta = fc.fetch("cluster", "c0")
                        assert meta.round == 1 and packb(params) == want
                except Exception as e:          # surfaced below
                    errors.append(e)

            threads = [threading.Thread(target=fetcher) for _ in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
                assert not t.is_alive()
            assert not errors
            assert fc.counts["endpoint_refreshes"] == 1
            assert fc.counts["fallback"] == 0 and fc.counts["redirects"] == 0


def test_connection_loss_reconnects_and_replays_the_journal(loopback,
                                                            deadline):
    """A dropped command session: the next drain reconnects, re-seeds and
    replays the journal; nothing is lost or counted twice."""
    rng = np.random.default_rng(12)
    keys = ["c0", "c1"]
    with tcp_store(loopback[0], keys, rng, max_coalesce=4) as store:
        for rnd in range(1, 4):
            for key in keys:
                store.handle_model_update(
                    "cluster", key, torch_tree(np_tree(rng)),
                    agg.ModelMeta(5, 1, rnd), agg.UpdateDelta(5, 1, 1))
        before = {k: store.effective_round("cluster", k) for k in keys}
        for sh in store._proc_shards:
            sh.handle.kill()
        assert store.drain_all() == 6
        stats = store.agg_stats()
        assert stats["respawns"] == 2 and stats["updates"] == 6
        assert store.worker_spawns() == [2, 2]
        for key in keys:
            assert store.meta("cluster", key).round == before[key] == 3


def test_threaded_runtime_with_the_read_tier(loopback, deadline):
    """``FedCCL(server_hosts=..., fetch_from_workers=True)`` under the
    threaded runtime: one process pump, no lost update, and ``model_for``
    served by the shard servers without a fallback."""
    fed = FedCCL(FedCCLConfig(spaces=(ClusterSpaceConfig("loc", **SPACE),),
                              ewc_lambda=0.05, seed=5, runtime="threaded",
                              server_hosts=tuple(loopback[0]),
                              fetch_from_workers=True,
                              batch_aggregation=True, max_coalesce=3),
                 {"w": torch.zeros(())}, scalar_train_fn, device="cpu")
    fed.setup(specs_for(ClientSpec, 5))
    try:
        stats = fed.run(rounds=2)
        assert [t.name for t in fed._runtime.drain_workers] == \
            ["process-pump"]
        want = sum(2 * (1 + len(c.cluster_keys)) for c in fed.clients)
        assert stats["updates"] == stats["enqueued"] == want
        assert stats["transport"] == "tcp" and stats["respawns"] == 0
        assert stats["drain_timeouts"] == 0
        for c in fed.clients:
            params, level = fed.model_for(c.spec.client_id)
            key = level.split(":", 1)[1]
            assert packb(params) == packb(fed.store.params("cluster", key))
        assert fed.fetcher.counts["fallback"] == 0
        assert fed.fetcher.counts["full"] + \
            fed.fetcher.counts["not_modified"] == len(fed.clients)
    finally:
        fed.shutdown()


def test_server_exits_on_shutdown():
    """``shutdown`` ends ``serve``: the accept loop wakes and returns (the
    reference's server acknowledges it and keeps blocking in accept,
    ROADMAP.md §3)."""
    ready = threading.Event()
    port = []

    def announce(line, flush=True):
        port.append(int(line.rsplit("port=", 1)[1]))
        ready.set()
    t = threading.Thread(target=shard_server.serve,
                         args=("127.0.0.1", 0, announce, "cpu"), daemon=True)
    t.start()
    assert ready.wait(30.0)
    with socket.create_connection(("127.0.0.1", port[0]), 10.0) as c:
        c.settimeout(10.0)
        send_frame(c, packb(["ping"]))           # a read session first
        assert unpackb_np(recv_frame(c)[1])[:2] == ["error", "ping"]
    with socket.create_connection(("127.0.0.1", port[0]), 10.0) as c:
        c.settimeout(10.0)
        send_frame(c, packb(["shutdown"]))
        assert unpackb_np(recv_frame(c)[1]) == ["stopped", -1]
    t.join(10.0)
    assert not t.is_alive()
