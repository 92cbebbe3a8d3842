"""The port's process server tier against the JAX package's: the wire
helpers and seed blobs, ``ShardWorker`` command by command, the
``ProcessShardedModelStore`` (journal, respawn and replay, deferred
submit-path errors, the lazy-mirror read barrier, migration, secure rounds
inside the worker), one run on spawned worker processes, and
``FedCCL(server_processes=2)`` under both runtimes, the solar run included.

Inputs are made with numpy from a seed and handed to both packages.
Seed blobs and the bytes of replies without floats must be equal exactly;
metas, ``agg_stats`` (wire bytes included) and the fold schedule exact;
folded parameters within atol 1e-5, the reference's own tolerance for its
store equivalence (``tests/test_store_equivalence.py``); the solar run's
Table II within 1e-3 pp, as the other solar parity tests.

Spawned children run on the CPU here with one torch thread each
(``OMP_NUM_THREADS=1``), and each test that spawns holds a deadline of
its own (``deadline``), besides the store's reply timeouts.
"""

import functools
import pathlib
import signal
import sys
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training.fed_solar as jax_fed_solar
import repro_torch.training.fed_solar as torch_fed_solar
from repro.checkpoint.msgpack_ckpt import packb as jpackb
from repro.checkpoint.msgpack_ckpt import unpackb_np as junpackb
from repro.core import aggregation as jagg
from repro.core import server_proc as jserver
from repro.core import store as jstore
from repro.core.fedccl import ClusterSpaceConfig as JaxSpace
from repro.core.fedccl import FedCCL as JaxFedCCL
from repro.core.fedccl import FedCCLConfig as JaxFedCCLConfig
from repro.core.protocol import ClientSpec as JaxClientSpec
from repro.privacy.secure_agg import PairwiseMasker as JaxMasker
from repro_torch.checkpoint.msgpack_ckpt import packb
from repro_torch.core import aggregation as agg
from repro_torch.core import server_proc
from repro_torch.core import store as tstore
from repro_torch.core.fedccl import ClusterSpaceConfig, FedCCL, FedCCLConfig
from repro_torch.core.protocol import ClientSpec
from repro_torch.core.runtime_threaded import AsyncThreadedRuntime
from repro_torch.privacy.secure_agg import PairwiseMasker
from repro_torch.utils.tree import unflatten_params

from test_torch_federation import scalar_train_fn, specs_for

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from scripts import torch_parity  # noqa: E402
from scripts.torch_parity import SMALL, solar_parity  # noqa: E402

ATOL = 1e-5
GLOBAL = tstore.GLOBAL_KEY
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


@pytest.fixture
def deadline():
    """Fail a test that spawns processes after 150 s instead of letting
    it hang the run (each wait inside also has its own timeout)."""
    def expire(signum, frame):
        raise TimeoutError("the test's 150 s deadline passed")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(150)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def one_thread_children(monkeypatch):
    """Spawned torch children inherit the environment: one intra-op thread
    each, so a few of them do not oversubscribe the runner."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def np_tree(rng):
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


def torch_tree(t):
    return {k: torch.from_numpy(v.copy()) for k, v in t.items()}


def jax_tree(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def meta_tuple(m):
    return (m.samples_learned, m.epochs_learned, m.round)


def model_lks(keys):
    return [("global", None)] + [("cluster", k) for k in keys]


def assert_stores_match(port, ref, keys, atol=ATOL):
    for lk in model_lks(keys):
        assert meta_tuple(port.meta(*lk)) == meta_tuple(ref.meta(*lk)), lk
        got, want = port.params(*lk), ref.params(*lk)
        for leaf in want:
            np.testing.assert_allclose(got[leaf].numpy(),
                                       np.asarray(want[leaf]), atol=atol,
                                       err_msg=f"{lk} leaf {leaf}")


def assert_same_message(got, want, path="reply"):
    """A decoded port message (tensors) against the reference's (numpy):
    equal structure and scalars, arrays (and the arrays inside packed
    snapshots that differ) within ATOL."""
    if isinstance(want, (np.ndarray, jax.Array)):
        assert isinstance(got, torch.Tensor), path
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=path)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same_message(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_message(g, w, f"{path}[{i}]")
    elif isinstance(want, bytes) and got != want:
        # a packed snapshot of folded params: f32 sums in another order
        # may differ in the last bit, so compare what it decodes to
        assert_same_message(server_proc.unpackb(got, "cpu"), junpackb(want),
                            f"{path} (decoded)")
    else:
        assert got == want, (path, got, want)


# --------------------------------------------------------------- the wire
def test_wire_helpers_and_reply_ops_match_reference():
    assert server_proc.REPLY_OPS == jserver.REPLY_OPS
    m, d = agg.ModelMeta(7, 2, 3), agg.UpdateDelta(5, 1, 1)
    assert server_proc.meta_to_wire(m) == \
        jserver.meta_to_wire(jagg.ModelMeta(7, 2, 3)) == [7, 2, 3]
    assert server_proc.delta_to_wire(d) == [5, 1, 1]
    assert server_proc.meta_from_wire([7, 2, 3]) == m
    assert server_proc.delta_from_wire([5, 1, 1]) == d


@pytest.mark.parametrize("case", ["plain", "masker_lazy", "migrated"])
def test_seed_blob_bytes_match_reference(case):
    """A torch parent's seed blob equals a default JAX parent's
    (``use_pallas`` False) byte for byte; the device is not in it."""
    rng = np.random.default_rng(3)
    trees = [np_tree(rng) for _ in range(2)]
    metas = [(5, 1, 1), (0, 0, 0)]
    kw = {"plain": {}, "masker_lazy": dict(mirror_sync_every=4),
          "migrated": dict(epoch=3, migrated={"c7": [1, 2], "c9": [0, 3]})}[
        case]
    masker = PairwiseMasker(seed=9, mask_scale=1.5) \
        if case == "masker_lazy" else None
    jmasker = JaxMasker(seed=9, mask_scale=1.5) \
        if case == "masker_lazy" else None
    got = server_proc.make_seed_blob(
        [(f"c{i}", torch_tree(t), agg.ModelMeta(*m))
         for i, (t, m) in enumerate(zip(trees, metas))],
        6, agg.AggregationConfig(), masker, **kw)
    want = jserver.make_seed_blob(
        [(f"c{i}", jax_tree(t), jagg.ModelMeta(*m))
         for i, (t, m) in enumerate(zip(trees, metas))],
        6, jagg.AggregationConfig(), jmasker, **kw)
    assert got == want


def worker_pair(blob):
    return (server_proc.ShardWorker(0, blob, "cpu"),
            jserver.ShardWorker(0, blob))


def drive(pair, msg):
    """The same command bytes through both workers; returns the decoded
    replies (port, reference)."""
    raw = jpackb(msg)
    assert packb(msg) == raw
    port, ref = pair
    return port.handle(port.decode(raw)), ref.handle(junpackb(raw))


def test_shard_worker_matches_reference_command_by_command():
    """Submits (a replay duplicate, a poison batch item), drains with lazy
    sync, the sync barrier, the global slice's gmeta and greduce,
    conditional fetches, a replica push, tombstones and parking, export
    and install, ping and obsdump: every reply equal, floats within
    1e-5, and the bytes of the float-free ones equal."""
    rng = np.random.default_rng(21)
    base = np_tree(rng)
    blob = jserver.make_seed_blob(
        [("c0", jax_tree(base), jagg.ModelMeta(5, 1, 1)),
         ("c1", jax_tree(base), jagg.ModelMeta())], 3,
        jagg.AggregationConfig(), None, 2, epoch=1,
        migrated={"cX": [1, 1]})
    pair = worker_pair(blob)

    def tree():
        return np_tree(rng)

    def sub(seq, key, s=10, rnd=1):
        return ["sub", seq, key, tree(), [s, 1, rnd], [s, 1, 1], 1]

    script = [
        ["ensure", "c2", tree(), 1], sub(0, "c0"), sub(1, "c0", 20, 2),
        sub(0, "c0"),                                   # replay duplicate
        sub(2, "c1"), ["gsub", 3, tree(), [7, 1, 1], [7, 1, 1]],
        ["gsub", 4, tree(), [9, 1, 1], [9, 1, 1]],
        ["batch", [jpackb(sub(5, "c2")),
                   jpackb(["sub", 6, "c2", tree(), [1, 1], [1, 1, 1], 1])]],
        ["ping"],                   # surfaces the poison item's error
        ["ping"], ["drain", "c0"], ["drain_shard"], ["sync"], ["gmeta"],
        ["greduce", [[3, 0.25], [4, 0.5]]], ["gmeta"],
        ["fetch", "c0", None], ["fetch", "c0", [35, 3, 4]],
        ["mirror", "c9", tree(), [1, 1, 1]], ["fetch", "c9", None],
        sub(7, "cX"), ["drain", "cX"], ["fetch", "cX", None],
        ["mig_redirects"], ["mig_export", "c1", 2, 1], sub(8, "c1"),
        ["fetch", "c1", None], ["sdrain", "c1", 0, ["a"]],
        ["mig_redirects"], ["obsdump"],
    ]
    float_free = {"ping", "gmeta", "mig_redirects", "obsdump", "sync"}
    state = None
    for msg in script:
        got, want = drive(pair, msg)
        assert_same_message(got, want, f"{msg[0]} reply")
        if want is not None and msg[0] in float_free and msg[0] != "sync":
            assert packb(got) == jpackb(want), msg[0]
        if msg[0] == "mig_export":
            state = (got, want)
    assert pair[0].held == pair[1].held
    assert pair[0].pending_errors == pair[1].pending_errors == []
    # install the exported cluster on a fresh pair: same reply, and the
    # parked and shipped submits fold to the same model
    dst = worker_pair(jserver.make_seed_blob([], 3, jagg.AggregationConfig(),
                                             None, 1, epoch=2))
    port_state, ref_state = state[0][2], state[1][2]
    raw_ref = jpackb(["mig_install", "c1", 2, ref_state])
    assert packb(["mig_install", "c1", 2, port_state]) == raw_ref
    straggler = jpackb(sub(9, "c1"))
    for worker, decode in ((dst[0], dst[0].decode), (dst[1], junpackb)):
        worker.handle(decode(straggler))                # parks: not served
    got = dst[0].handle(dst[0].decode(raw_ref))
    want = dst[1].handle(junpackb(raw_ref))
    assert_same_message(got, want, "mig_install reply")
    got, want = drive(dst, ["drain", "c1"])
    assert_same_message(got, want, "drain after install")


# ----------------------------------------------------- the in-process store
def make_schedule(rng, models, n_updates, fresh_frac=0.2):
    counts = {m: 0 for m in models}
    events = []
    for _ in range(n_updates):
        m = models[int(rng.integers(len(models)))]
        s = int(rng.integers(1, 300))
        rnd = counts[m] + 1 if rng.random() < fresh_frac else 1
        events.append((m, np_tree(rng), (s, 1, rnd), (s, 1, 1)))
        counts[m] += 1
    return events


def submit(store, ev, port):
    m, p, um, d = ev
    tree, meta, delta = ((torch_tree, agg.ModelMeta, agg.UpdateDelta) if port
                         else (jax_tree, jagg.ModelMeta, jagg.UpdateDelta))
    lk = ("global", None) if m == GLOBAL else ("cluster", m)
    store.handle_model_update(*lk, tree(p), meta(*um), delta(*d))
    return lk


def replay(store, events, port, drain_rng):
    for ev in events:
        lk = submit(store, ev, port)
        if drain_rng.random() < 0.3:
            if drain_rng.random() < 0.5:
                store.drain(*lk)
            else:
                store.drain_all()
    store.drain_all()


def store_pair(init, keys, **kw):
    fast = kw.pop("fast_path", True)
    port = tstore.ProcessShardedModelStore(
        torch_tree(init), keys, agg.AggregationConfig(sequential_fast_path=fast),
        inprocess=True, device="cpu", **kw)
    ref = jstore.ProcessShardedModelStore(
        jax_tree(init), keys, jagg.AggregationConfig(sequential_fast_path=fast),
        inprocess=True, **kw)
    return port, ref


@pytest.mark.parametrize("n_shards,fast_path,sync_every", [
    (1, True, 1), (3, True, 1), (3, False, 1), (2, True, 4), (4, False, 4)])
def test_inprocess_store_matches_jax_schedule(n_shards, fast_path,
                                              sync_every):
    rng = np.random.default_rng(100 * n_shards + 10 * fast_path + sync_every)
    init = np_tree(rng)
    keys = [f"loc:{i}" for i in range(5)]
    events = make_schedule(rng, [GLOBAL] + keys, n_updates=60)
    port, ref = store_pair(init, keys, n_shards=n_shards, fast_path=fast_path,
                           batch_aggregation=True, max_coalesce=7,
                           mirror_sync_every=sync_every)
    replay(port, events, True, np.random.default_rng(2))
    replay(ref, events, False, np.random.default_rng(2))
    assert port.sync_mirrors() == ref.sync_mirrors()
    assert_stores_match(port, ref, keys)
    assert port.agg_stats() == ref.agg_stats()       # wire bytes included
    stats = port.agg_stats()
    assert stats["updates"] == len(events) and stats["transport"] == \
        "inprocess"
    for lk in model_lks(keys):
        assert port.pending_depth(*lk) == 0
        assert port.effective_round(*lk) == port.meta(*lk).round
    port.close()
    ref.close()


def test_unbatched_submits_fold_at_once_like_jax():
    rng = np.random.default_rng(8)
    init = np_tree(rng)
    keys = ["c0", "c1"]
    events = make_schedule(rng, [GLOBAL] + keys, n_updates=20)
    port, ref = store_pair(init, keys, n_shards=2, batch_aggregation=False)
    for ev in events:
        submit(port, ev, True)
        submit(ref, ev, False)
        for lk in model_lks(keys):
            assert port.pending_depth(*lk) == ref.pending_depth(*lk) == 0
    assert_stores_match(port, ref, keys)
    assert port.agg_stats() == ref.agg_stats()


def test_kill_respawn_replays_journal_like_jax():
    """The emulation's killed workers lose their queues; the journal
    replays them on respawn, in both packages alike."""
    rng = np.random.default_rng(3)
    init = np_tree(rng)
    keys = ["c0", "c1"]
    port, ref = store_pair(init, keys, n_shards=2, batch_aggregation=True,
                           max_coalesce=4)
    for _ in range(8):
        t = np_tree(rng)
        for key in keys + [None]:
            ev = (GLOBAL if key is None else key, t, (5, 1, 1), (5, 1, 1))
            submit(port, ev, True)
            submit(ref, ev, False)
    before = {lk: port.effective_round(*lk) for lk in model_lks(keys)}
    for store in (port, ref):
        store._debug_kill_worker(0)
        store._debug_kill_worker(1)
        assert store.drain_all() == 24      # nothing lost with the queues
    stats = port.agg_stats()
    assert stats == ref.agg_stats()
    assert stats["respawns"] == 2 and stats["updates"] == 24
    assert port.worker_spawns() == [2, 2]
    for lk, er in before.items():
        assert port.effective_round(*lk) == port.meta(*lk).round == er
        assert port.pending_depth(*lk) == 0
    assert_stores_match(port, ref, keys)


def test_submit_path_errors_deferred_to_next_drain():
    """A fire-and-forget message that fails in the worker is not
    swallowed: it becomes the error reply of the next drain, and its
    batchmate still lands, as in the reference."""
    rng = np.random.default_rng(4)
    init = np_tree(rng)
    for store, tree, meta, delta in (
            (tstore.ProcessShardedModelStore(torch_tree(init), ["c0"],
                                             n_shards=1, inprocess=True,
                                             device="cpu"),
             torch_tree, agg.ModelMeta, agg.UpdateDelta),
            (jstore.ProcessShardedModelStore(jax_tree(init), ["c0"],
                                             n_shards=1, inprocess=True),
             jax_tree, jagg.ModelMeta, jagg.UpdateDelta)):
        sh = store._proc_shards[0]
        with sh.journal_lock:                  # a corrupt wire message
            store._outbox_put(sh, jpackb(
                ["sub", 99, "c0", init, [1, 1], [1, 1, 1], 0]))
        store.handle_model_update("cluster", "c0", tree(init),
                                  meta(5, 1, 1), delta(5, 1, 1))
        with pytest.raises(RuntimeError, match="deferred submit-path errors"):
            store.drain("cluster", "c0")
        assert store.drain("cluster", "c0") == 1
        assert store.meta("cluster", "c0").round == 1


def test_lazy_sync_read_barrier_no_stale_reads():
    """A read that starts after a drain returned observes that drain's
    fold, although most acks carry no params (``mirror_sync_every=5``):
    readers hammer ``meta()`` while the writer timestamps each drain."""
    rng = np.random.default_rng(11)
    store = tstore.ProcessShardedModelStore(
        torch_tree(np_tree(rng)), ["c0"], n_shards=1, batch_aggregation=True,
        mirror_sync_every=5, inprocess=True, device="cpu")
    stop = threading.Event()
    samples, errors, marks = [], [], []

    def reader():
        try:
            while not stop.is_set():
                t0 = time.monotonic_ns()
                samples.append((t0, store.meta("cluster", "c0").round))
                time.sleep(0)           # let the writer have the lock
        except Exception as e:          # surfaced below
            errors.append(e)

    readers = [threading.Thread(target=reader) for _ in range(2)]
    for t in readers:
        t.start()
    try:
        for i in range(40):
            store.handle_model_update("cluster", "c0",
                                      torch_tree(np_tree(rng)),
                                      agg.ModelMeta(5, 1, 1),
                                      agg.UpdateDelta(5, 1, 1))
            assert store.drain("cluster", "c0") == 1
            marks.append((time.monotonic_ns(), i + 1))
    finally:
        stop.set()
        for t in readers:
            t.join(30.0)
            assert not t.is_alive()
    assert not errors
    assert store.meta("cluster", "c0").round == 40
    assert store.agg_stats()["mirror_syncs"] > 0
    store.close()
    assert len(samples) > 10
    for t0, seen in samples:
        floor = 0
        for tm, r in marks:
            if tm <= t0:
                floor = r
            else:
                break
        assert seen >= floor, (seen, floor)


def test_migration_ships_pending_and_folds_once_like_jax():
    """A cluster migrated with updates still queued: the shipped queue
    folds once on the new owner, later submits route there, the epoch
    moves, and both packages agree in every model and stat."""
    rng = np.random.default_rng(17)
    init = np_tree(rng)
    keys = ["c0", "c1"]
    port, ref = store_pair(init, keys, n_shards=2, batch_aggregation=True,
                           max_coalesce=4)

    def push(key, n):
        for _ in range(n):
            ev = (key, np_tree(rng), (5, 1, 1), (5, 1, 1))
            submit(port, ev, True)
            submit(ref, ev, False)

    push("c0", 6)
    push("c1", 3)
    src = port.shard_of("c0")
    assert src == ref.shard_of("c0")
    assert port.migrate_cluster("c0", 1 - src) == \
        ref.migrate_cluster("c0", 1 - src) == 1
    push("c0", 2)
    assert port.pending_depth("cluster", "c0") == 8
    assert port.drain_all() == ref.drain_all() == 11
    assert port.agg_stats() == ref.agg_stats()
    assert port.agg_stats()["respawns"] == 0
    assert port.migrate_cluster("c0", src) == 2
    push("c0", 1)
    ref.migrate_cluster("c0", src)
    assert port.drain("cluster", "c0") == ref.drain("cluster", "c0") == 1
    assert_stores_match(port, ref, keys)


def test_submit_racing_a_fence_counts_one_enqueue():
    """A submit whose route read saw the old owner and whose journal lock
    saw the new one reroutes; it is one enqueue, on the new owner's
    shard.  (The reference counts it on both: ``enqueued`` 2 for one
    submit; ROADMAP.md §3.)"""
    store = tstore.ProcessShardedModelStore(
        {"w": torch.zeros(3)}, ["c0"], n_shards=2, inprocess=True,
        batch_aggregation=True, device="cpu")
    src = store.shard_of("c0")
    real, calls = store.shard_of, []

    def racing(key):
        calls.append(key)
        if key == "c0" and len(calls) == 1:
            store.ring.assign("c0", 1 - src)     # the fence lands here
            return src
        return real(key)
    store.shard_of = racing
    store.handle_model_update("cluster", "c0", {"w": torch.ones(3)},
                              agg.ModelMeta(5, 1, 1),
                              agg.UpdateDelta(5, 1, 1))
    stats = store.agg_stats()
    assert stats["enqueued"] == 1
    assert stats["shard_enqueued"][1 - src] == 1
    assert store.pending_depth("cluster", "c0") == 1


def test_migration_under_load_loses_nothing():
    """Four submitter threads against the process pump while a cluster
    migrates back and forth: every update folds exactly once."""
    rng = np.random.default_rng(29)
    keys = [f"c{i}" for i in range(4)]
    store = tstore.ProcessShardedModelStore(
        torch_tree(np_tree(rng)), keys, n_shards=2, batch_aggregation=True,
        max_coalesce=5, inprocess=True, device="cpu")
    n_threads, per = 4, 25
    sys.setswitchinterval(1e-5)
    try:
        rt = AsyncThreadedRuntime([], store, drain_poll=1e-4,
                                  join_timeout=20.0)
        stop = threading.Event()
        rt._start_drain_workers(stop)
        assert [t.name for t in rt.drain_workers] == ["process-pump"]

        def submitter(t):
            trng = np.random.default_rng(1000 + t)
            for i in range(per):
                tree = torch_tree(np_tree(trng))
                store.handle_model_update("cluster", keys[i % 4], tree,
                                          agg.ModelMeta(3, 1, 1),
                                          agg.UpdateDelta(3, 1, 1))
                store.handle_model_update("global", None, tree,
                                          agg.ModelMeta(3, 1, 1),
                                          agg.UpdateDelta(3, 1, 1))

        subs = [threading.Thread(target=submitter, args=(t,))
                for t in range(n_threads)]
        for t in subs:
            t.start()
        for _ in range(6):
            store.migrate_cluster("c0", 1 - store.shard_of("c0"))
            time.sleep(0.002)
        for t in subs:
            t.join(30.0)
            assert not t.is_alive()
        rt._join_drain_workers(stop)
        assert not rt.errors
    finally:
        sys.setswitchinterval(0.005)
    total = n_threads * per * 2
    stats = store.agg_stats()
    assert stats["updates"] == stats["enqueued"] == total
    assert stats["cluster_migrations"] == 6 and stats["respawns"] == 0
    assert store.meta("global").round == total // 2
    assert sum(store.meta("cluster", k).round for k in keys) == total // 2
    for lk in model_lks(keys):
        assert store.pending_depth(*lk) == 0


@pytest.mark.parametrize("dropout", [False, True])
def test_secure_rounds_fold_inside_the_worker_like_jax(dropout):
    """Masked cluster rounds fold inside the owning worker (the parent
    journals them and never folds them); a dropped member is recovered
    from the worker's own masker; the global round folds in the parent.
    Equal to the JAX package's process store."""
    rng = np.random.default_rng(13)
    init = np_tree(rng)
    template = torch_tree(init)
    mk, jmk = PairwiseMasker(seed=9, mask_scale=1.5), \
        JaxMasker(seed=9, mask_scale=1.5)
    port = tstore.ProcessShardedModelStore(
        template, ["c0", "c1"], n_shards=2, inprocess=True, masker=mk,
        device="cpu")
    ref = jstore.ProcessShardedModelStore(
        jax_tree(init), ["c0", "c1"], n_shards=2, inprocess=True, masker=jmk)
    ids = ["m0", "m1", "m2"]
    sent = ids[:2] if dropout else ids
    for level, key in (("cluster", "c0"), ("global", None)):
        mkey = port.model_key(level, key)
        for cid in sent:
            d = np.random.default_rng(zlib.crc32(f"{cid}/{mkey}".encode())) \
                .standard_normal(17).astype(np.float32)
            masked = unflatten_params(mk.mask_delta_flat(
                torch.from_numpy(d), cid, ids, 0, mkey, weight=10.0),
                template)
            jmasked = {k: jnp.asarray(v.numpy()) for k, v in masked.items()}
            port.submit_secure(level, key, cid, 0, masked,
                               agg.UpdateDelta(10, 1, 1))
            ref.submit_secure(level, key, cid, 0, jmasked,
                              jagg.UpdateDelta(10, 1, 1))
    sh = port._proc_shards[port.shard_of("c0")]
    assert sum(e.kind == "secure" for e in sh.journal.values()) == len(sent)
    for store in (port, ref):
        for level, key in (("cluster", "c0"), ("global", None)):
            assert store.drain_secure(level, key, 0, ids) == len(sent)
    stats = port.agg_stats()
    assert stats == ref.agg_stats()
    assert stats["secure_rounds"] == 2
    assert stats["secure_recoveries"] == (2 if dropout else 0)
    assert not sh.journal                     # acked by the sdrained reply
    assert_stores_match(port, ref, ["c0", "c1"], atol=1e-4)


# ---------------------------------------------------------- spawned workers
def test_spawned_workers_match_the_emulation_on_the_cpu(
        deadline, one_thread_children):
    """Two spawned worker processes on the CPU against the in-process
    emulation and the JAX package's emulation on one schedule: the same
    models, stats and wire bytes; the workers announce ready (cold start
    recorded) and stop with the store."""
    rng = np.random.default_rng(31)
    init = np_tree(rng)
    keys = [f"c{i}" for i in range(3)]
    events = make_schedule(rng, [GLOBAL] + keys, n_updates=30)
    with tstore.ProcessShardedModelStore(
            torch_tree(init), keys, n_shards=2, batch_aggregation=True,
            max_coalesce=5, device="cpu", drain_timeout_s=60.0) as spawned:
        handles = [sh.handle for sh in spawned._proc_shards]
        assert all(h.cold_start_s is not None and h.cold_start_s > 0
                   for h in handles)
        port, ref = store_pair(init, keys, n_shards=2,
                               batch_aggregation=True, max_coalesce=5)
        for store, is_port in ((spawned, True), (port, True), (ref, False)):
            replay(store, events, is_port, np.random.default_rng(4))
        assert_stores_match(spawned, ref, keys)
        got, want = spawned.agg_stats(), ref.agg_stats()
        assert got["processes"] == 2 and got["transport"] == "process"
        assert {k: v for k, v in got.items()
                if k not in ("processes", "transport")} == \
            {k: v for k, v in want.items()
             if k not in ("processes", "transport")}
        assert port.agg_stats() == want
    for h in handles:
        h.proc.join(10.0)
        assert not h.proc.is_alive()


def test_workers_refuse_a_missing_card():
    """A worker asked for CUDA where there is none raises; it does not
    carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    blob = server_proc.make_seed_blob([], 4, agg.AggregationConfig(), None)
    for make in (lambda: server_proc.ShardWorker(0, blob, "cuda"),
                 lambda: server_proc.ProcessWorkerHandle(0, blob, "cuda"),
                 lambda: tstore.ProcessShardedModelStore(
                     {"w": torch.zeros(2)}, n_shards=1, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ------------------------------------------------------------- the facade
def facade_pair(seed=5, **kw):
    fed = FedCCL(FedCCLConfig(spaces=(ClusterSpaceConfig("loc", **SPACE),),
                              ewc_lambda=0.05, seed=seed, **kw),
                 {"w": torch.zeros(())}, scalar_train_fn, device="cpu")
    jfed = JaxFedCCL(JaxFedCCLConfig(spaces=(JaxSpace("loc", **SPACE),),
                                     ewc_lambda=0.05, seed=seed, **kw),
                     {"w": jnp.zeros(())}, scalar_train_fn)
    assert fed.setup(specs_for(ClientSpec, seed)) == \
        jfed.setup(specs_for(JaxClientSpec, seed))
    return fed, jfed


@pytest.mark.parametrize("batched", [False, True])
def test_fedccl_process_sim_matches_jax(batched):
    fed, jfed = facade_pair(server_processes=2, batch_aggregation=batched,
                            max_coalesce=3)
    assert fed.store.transport_kind() == "inprocess"
    stats, jstats = fed.run(rounds=3), jfed.run(rounds=3)
    assert stats == jstats
    assert stats["processes"] == 0 and stats["respawns"] == 0
    # every stat but the wire bytes: the reference's mirrors of this 0-d
    # model decode as 0-d numpy arrays, and numpy arithmetic on them gives
    # the client numpy scalars, which its codec sends as float64 values
    # instead of f32 arrays; the port keeps 0-d f32 tensors
    wire = ("wire_tx_bytes", "wire_rx_bytes")
    got, want = fed.store.agg_stats(), jfed.store.agg_stats()
    assert {k: v for k, v in got.items() if k not in wire} == \
        {k: v for k, v in want.items() if k not in wire}
    for lk in model_lks(fed.store.keys()):
        assert meta_tuple(fed.store.meta(*lk)) == \
            meta_tuple(jfed.store.meta(*lk))
        np.testing.assert_allclose(fed.store.params(*lk)["w"].numpy(),
                                   np.asarray(jfed.store.params(*lk)["w"]),
                                   atol=ATOL)
    fed.shutdown()
    jfed.shutdown()


def test_fedccl_process_threaded_runs_spawned_workers(deadline,
                                                      one_thread_children):
    """The threaded runtime with ``server_processes=2``: spawned workers,
    one process pump, no lost update, clean shutdown."""
    fed = FedCCL(FedCCLConfig(spaces=(ClusterSpaceConfig("loc", **SPACE),),
                              ewc_lambda=0.05, seed=5, runtime="threaded",
                              server_processes=2, batch_aggregation=True,
                              max_coalesce=3, fetch_from_workers=True),
                 {"w": torch.zeros(())}, scalar_train_fn, device="cpu")
    fed.setup(specs_for(ClientSpec, 5))
    try:
        assert fed.store.transport_kind() == "process"
        stats = fed.run(rounds=3)
        assert [t.name for t in fed._runtime.drain_workers] == \
            ["process-pump"]
        want = sum(3 * (1 + len(c.cluster_keys)) for c in fed.clients)
        assert stats["updates"] == stats["enqueued"] == want
        assert stats["drain_timeouts"] == 0 and stats["respawns"] == 0
        assert fed.store.meta("global").round == 3 * len(fed.clients)
        params, level = fed.model_for(fed.clients[0].spec.client_id)
        assert fed.fetcher.counts["fallback"] == 0    # parent-served
        assert level.startswith("cluster")
    finally:
        fed.shutdown()
    for sh in fed.store._proc_shards:
        assert not sh.handle.proc.is_alive()


# ----------------------------------------------------------- the solar run
def test_solar_process_sim_matches_jax(monkeypatch):
    """The solar run at hidden 16 on the in-process emulation of 2 workers
    in both packages: clusters and stats (process fields and wire bytes
    included) exact, Table II within 1e-3 pp."""
    for mod in (jax_fed_solar, torch_fed_solar):
        monkeypatch.setattr(mod, "FedCCLConfig", functools.partial(
            mod.FedCCLConfig, server_processes=2, batch_aggregation=True,
            max_coalesce=8))
    ref, got, gap = solar_parity(**SMALL)
    assert got["clusters"] == ref["clusters"]
    assert got["async_stats"] == ref["async_stats"]
    assert got["async_stats"]["shards"] == 2
    assert got["async_stats"]["processes"] == 0
    assert gap <= 1e-3


def test_solar_process_threaded_matches_jax(monkeypatch, deadline,
                                            one_thread_children):
    """The solar run at hidden 16 (9 days, 1 epoch) under the threaded
    runtime on 2 spawned workers in both packages, with secure aggregation and DP clipping
    (noise 0), whose barrier rounds make the schedule deterministic:
    clusters and stats exact but for the wire bytes (how many submits
    share a batch message depends on the threads), Table II within 1e-3
    pp."""
    feds = []
    for mod in (jax_fed_solar, torch_fed_solar):
        monkeypatch.setattr(mod, "FedCCLConfig", functools.partial(
            mod.FedCCLConfig, server_processes=2, runtime="threaded"))
        real = mod.FedCCL

        def keep(*a, _real=real, **kw):
            fed = _real(*a, **kw)
            feds.append(fed)
            return fed
        monkeypatch.setattr(mod, "FedCCL", keep)
    # the port's run_fedccl_solar passes its own runtime argument
    monkeypatch.setattr(torch_fed_solar, "run_fedccl_solar", functools.partial(
        torch_fed_solar.run_fedccl_solar, runtime="threaded"))
    monkeypatch.setattr(torch_parity, "torch_run",
                        torch_fed_solar.run_fedccl_solar)
    # SMALL cut to 9 days of 1 epoch: the threaded CPU run stays ~20 s
    cfg = dict(SMALL, n_days=9, epochs=1, dp_clip=5.0,
               dp_noise_multiplier=0.0, secure_agg=True)
    try:
        ref, got, gap = solar_parity(**cfg)
    finally:
        for fed in feds:
            fed.shutdown()
    wire = ("wire_tx_bytes", "wire_rx_bytes")
    assert got["clusters"] == ref["clusters"]
    assert {k: v for k, v in got["async_stats"].items() if k not in wire} \
        == {k: v for k, v in ref["async_stats"].items() if k not in wire}
    assert got["async_stats"]["processes"] == 2
    assert got["async_stats"]["respawns"] == 0
    assert got["async_stats"]["secure_rounds"] > 0
    assert gap <= 1e-3
