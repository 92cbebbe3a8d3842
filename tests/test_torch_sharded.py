"""The port's thread-sharded server tier against the JAX package: the ring
(``HashRing``, ``stable_shard``), the two-level fold
(``chunked_convex_reduce``, ``two_level_coalesced_aggregate``), the
``ShardedModelStore``, the per-shard drain workers of the threaded runtime
and ``FedCCL(server_shards=K)``.

Inputs are made with numpy from a seed and handed to both packages.  Ring
placement, plans, metadata and counters must be equal exactly; folded
parameters within atol 1e-5, the reference's own tolerance for the sharded
fold (``tests/test_store_equivalence.py``).  The schedules are ports of the
reference's equivalence harness; the scalar fleet is
``tests/test_torch_federation.py``'s.
"""

import functools
import pathlib
import sys
import threading
import time
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training.fed_solar as jax_fed_solar
import repro_torch.training.fed_solar as torch_fed_solar
from repro.core import aggregation as jagg
from repro.core import store as jstore
from repro.core.fedccl import ClusterSpaceConfig as JaxSpace
from repro.core.fedccl import FedCCL as JaxFedCCL
from repro.core.fedccl import FedCCLConfig as JaxFedCCLConfig
from repro.core.protocol import ClientSpec as JaxClientSpec
from repro.privacy.secure_agg import PairwiseMasker as JaxMasker
from repro_torch.core import aggregation as agg
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

from scripts.torch_parity import SMALL, solar_parity  # noqa: E402

ATOL = 1e-5
GLOBAL = tstore.GLOBAL_KEY
NOFAST = dict(sequential_fast_path=False)
RING_KEYS = [f"cluster:{i}" for i in range(1000)] + \
    [f"loc:{i}" for i in range(500)] + [f"ori:{i}" for i in range(500)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_tree(rng):
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


def torch_tree(t):
    return {k: torch.from_numpy(v.copy()) for k, v in t.items()}


def jax_tree(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def assert_close(got, want, atol=ATOL, msg=""):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol, err_msg=f"{msg} leaf {k!r}")


def meta_tuple(m):
    return (m.samples_learned, m.epochs_learned, m.round)


# ------------------------------------------------------------------ ring
@pytest.mark.parametrize("vnodes", [1, 16, 64])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
def test_hash_ring_matches_reference(k, vnodes):
    ring, jring = tstore.HashRing(k, vnodes), jstore.HashRing(k, vnodes)
    assert ring._hashes == jring._hashes and ring._points == jring._points
    for key in RING_KEYS:
        assert ring.owner(key) == jring.owner(key), key
        assert ring.shard_of(key) == jring.shard_of(key), key
        assert tstore.stable_shard(key, k) == jstore.stable_shard(key, k)
    # the global key is pinned to shard 0 and never migrates
    assert ring.shard_of(GLOBAL) == ring.owner(GLOBAL) == 0
    assert tstore.stable_shard(GLOBAL, k) == 0
    for r in (ring, jring):
        with pytest.raises(ValueError):
            r.assign(GLOBAL, 0)
        with pytest.raises(ValueError):
            r.assign("cluster:0", k)
    # override epochs: monotone, gap-free, identical in both packages
    rng = np.random.default_rng(100 * k + vnodes)
    for i in range(12):
        key = RING_KEYS[int(rng.integers(len(RING_KEYS)))]
        dst = int(rng.integers(k))
        assert ring.assign(key, dst) == jring.assign(key, dst) == i + 1
        assert ring.shard_of(key) == dst
    assert ring.overrides() == jring.overrides()
    assert ring.epoch == jring.epoch == 12
    for key in RING_KEYS:
        assert ring.shard_of(key) == jring.shard_of(key), key
        assert ring.owner(key) == jring.owner(key), key


# -------------------------------------------------------- two-level fold
def random_batches(rng, n_updates, n_shards, fresh_frac=0.3, zero_frac=0.15):
    """(per-shard batches as numpy triples, seqs): metas with stale and
    fast-path-fresh rounds and zero-sample resets, round-robin over shards
    by arrival seq."""
    batches = [[] for _ in range(n_shards)]
    seqs = [[] for _ in range(n_shards)]
    for seq in range(n_updates):
        zero = rng.random() < zero_frac
        s = 0 if zero else int(rng.integers(1, 300))
        rnd = seq + 1 if rng.random() < fresh_frac else int(rng.integers(0, 3))
        k = seq % n_shards
        batches[k].append((np_tree(rng), (s, 1, rnd), (s, 1, 1)))
        seqs[k].append(seq)
    return batches, seqs


def as_port(batches):
    return [[(torch_tree(p), agg.ModelMeta(*m), agg.UpdateDelta(*d))
             for p, m, d in b] for b in batches]


def as_jax(batches):
    return [[(jax_tree(p), jagg.ModelMeta(*m), jagg.UpdateDelta(*d))
             for p, m, d in b] for b in batches]


@pytest.mark.parametrize("fast_path", [True, False])
@pytest.mark.parametrize("max_width", [0, 1, 2, 3, 8])
def test_two_level_fold_matches_jax(max_width, fast_path):
    cfg = agg.AggregationConfig(sequential_fast_path=fast_path)
    jcfg = jagg.AggregationConfig(sequential_fast_path=fast_path)
    rng = np.random.default_rng(10 * max_width + fast_path)
    cases = [(0, 1), (1, 1), (2, 2), (24, 4)] + [
        (int(rng.integers(0, 25)), int(rng.integers(1, 5))) for _ in range(6)]
    for n, k in cases:
        base = np_tree(rng)
        base_meta = (int(rng.integers(0, 200)), 1, int(rng.integers(0, 3)))
        batches, seqs = random_batches(rng, n, k)
        for with_seqs in (True, False):
            kw = dict(seqs=seqs if with_seqs else None, max_width=max_width)
            got = agg.two_level_coalesced_aggregate(
                torch_tree(base), agg.ModelMeta(*base_meta),
                as_port(batches), cfg, **kw)
            want = jagg.two_level_coalesced_aggregate(
                jax_tree(base), jagg.ModelMeta(*base_meta),
                as_jax(batches), jcfg, **kw)
            what = f"n {n}, shards {k}, seqs {with_seqs}"
            assert meta_tuple(got.meta) == meta_tuple(want.meta), what
            assert (got.n_folded, got.n_param_sets, got.n_fast_path,
                    got.n_partials) == (want.n_folded, want.n_param_sets,
                                        want.n_fast_path, want.n_partials), what
            assert_close(got.params, want.params, msg=what)
            # the plan over the fold order is the flat fold's, exactly
            order = sorted((s, m, d) for b, sq in zip(batches, seqs)
                           for (_, m, d), s in zip(b, sq)) if with_seqs \
                else [(None, m, d) for b in batches for _, m, d in b]
            plan = agg.plan_coalesce(
                agg.ModelMeta(*base_meta),
                [(agg.ModelMeta(*m), agg.UpdateDelta(*d))
                 for _, m, d in order], cfg)
            assert meta_tuple(plan.meta) == meta_tuple(got.meta)


@pytest.mark.parametrize("max_width", [0, 1, 2, 3, 8])
def test_chunked_convex_reduce_matches_jax(max_width):
    rng = np.random.default_rng(max_width)
    for n in (0, 1, 2, 5, 9, 17):
        trees = [np_tree(rng) for _ in range(n)]
        masses = [float(m) for m in rng.random(n)]
        if n > 3:
            masses[1] = masses[2] = 0.0     # a chunk of zero mass drops out
        got = agg.chunked_convex_reduce(
            [(torch_tree(t), m) for t, m in zip(trees, masses)], max_width)
        want = jagg.chunked_convex_reduce(
            [(jax_tree(t), m) for t, m in zip(trees, masses)], max_width)
        assert [m for _, m in got] == [m for _, m in want]
        for (p, _), (q, _) in zip(got, want, strict=True):
            assert_close(p, q, msg=f"n {n}")


# ----------------------------------------------------- store schedules
def make_schedule(rng, models, n_updates, fresh_frac=0.2):
    """The reference harness's arrival stream, as numpy: (model, tree,
    meta, delta) with stale snapshots and fast-path-fresh updates."""
    counts = {m: 0 for m in models}
    events = []
    for _ in range(n_updates):
        m = models[int(rng.integers(len(models)))]
        s = int(rng.integers(1, 300))
        rnd = counts[m] + 1 if rng.random() < fresh_frac else 1
        events.append((m, np_tree(rng), (s, 1, rnd), (s, 1, 1)))
        counts[m] += 1
    return events


def replay_one(store, ev, port):
    """Submit one (model, tree, meta, delta) event; returns (level, key)."""
    m, p, um, d = ev
    tree, meta, delta = ((torch_tree, agg.ModelMeta, agg.UpdateDelta) if port
                         else (jax_tree, jagg.ModelMeta, jagg.UpdateDelta))
    level, key = ("global", None) if m == GLOBAL else ("cluster", m)
    store.handle_model_update(level, key, tree(p), meta(*um), delta(*d))
    return level, key


def replay(store, events, port, drain_rng=None, drain_prob=0.3,
           migrate_at=None, migrations=()):
    """Feed the stream into a store, draining at random points, with
    ``migrate_cluster`` calls before event ``migrate_at``."""
    for idx, ev in enumerate(events):
        if idx == migrate_at:
            for key, dst in migrations:
                store.migrate_cluster(key, dst)
        level, key = replay_one(store, ev, port)
        if drain_rng is not None and drain_rng.random() < drain_prob:
            if drain_rng.random() < 0.5:
                store.drain(level, key)
            else:
                store.drain_all()
    store.drain_all()


def model_lks(keys):
    return [("global", None)] + [("cluster", k) for k in keys]


@pytest.mark.parametrize("fast_path", [True, False])
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_sharded_store_matches_jax_schedule(n_shards, fast_path):
    rng = np.random.default_rng(100 * n_shards + fast_path)
    init = np_tree(rng)
    keys = [f"loc:{i}" for i in range(5)]
    events = make_schedule(rng, [GLOBAL] + keys, n_updates=60)
    kw = dict(batch_aggregation=True, max_coalesce=7)
    cfg = dict(sequential_fast_path=fast_path)
    sharded = tstore.ShardedModelStore(
        torch_tree(init), keys, agg.AggregationConfig(**cfg),
        n_shards=n_shards, **kw)
    flat = tstore.ModelStore(torch_tree(init), keys,
                             agg.AggregationConfig(**cfg), **kw)
    jsharded = jstore.ShardedModelStore(
        jax_tree(init), keys, jagg.AggregationConfig(**cfg),
        n_shards=n_shards, **kw)
    replay(sharded, events, True, np.random.default_rng(2))
    replay(flat, events, True, np.random.default_rng(1))
    replay(jsharded, events, False, np.random.default_rng(2))
    for lk in model_lks(keys):
        want = meta_tuple(jsharded.meta(*lk))
        assert meta_tuple(sharded.meta(*lk)) == want, lk
        assert meta_tuple(flat.meta(*lk)) == want, lk
        assert_close(sharded.params(*lk), jsharded.params(*lk), msg=str(lk))
        assert_close(flat.params(*lk), jsharded.params(*lk), msg=str(lk))
    assert sharded.agg_stats() == jsharded.agg_stats()
    fs, ss = flat.agg_stats(), sharded.agg_stats()
    for k in ("updates", "enqueued", "lock_waits", "fast_path_frac"):
        assert fs[k] == ss[k], k
    assert ss["updates"] == len(events) and ss["global_drains"] >= 1
    assert sharded.pending_depth("global") == 0


def test_effective_round_parity_with_jax():
    rng = np.random.default_rng(7)
    init = np_tree(rng)
    keys = ["c0", "c1", "c2"]
    events = make_schedule(rng, [GLOBAL] + keys, n_updates=30)
    stores = [(tstore.ShardedModelStore(torch_tree(init), keys, n_shards=3,
                                        batch_aggregation=True), True),
              (tstore.ModelStore(torch_tree(init), keys,
                                 batch_aggregation=True), True),
              (jstore.ShardedModelStore(jax_tree(init), keys, n_shards=3,
                                        batch_aggregation=True), False)]
    for ev in events:
        for store, port in stores:
            replay_one(store, ev, port)
        for lk in model_lks(keys):
            rounds = {store.effective_round(*lk) for store, _ in stores}
            assert len(rounds) == 1, (lk, rounds)
    for store, _ in stores:
        store.drain_all()
    for lk in model_lks(keys):
        assert len({s.effective_round(*lk) for s, _ in stores}) == 1
        assert len({s.meta(*lk).round for s, _ in stores}) == 1




@pytest.mark.parametrize("sharded", [False, True])
def test_failed_drain_requeues_batch_and_retires_inflight(sharded):
    """A fold that raises (a malformed update) puts the batch back at the
    queue head and retires its in-flight rounds, as the reference's does."""
    rng = np.random.default_rng(41)
    init, good = np_tree(rng), np_tree(rng)
    poison = {"a": np.zeros((9, 9), np.float32), "b": np.zeros(2, np.float32)}
    if sharded:
        store = tstore.ShardedModelStore(torch_tree(init), ["c0"],
                                         n_shards=2, batch_aggregation=True)
        jst = jstore.ShardedModelStore(jax_tree(init), ["c0"], n_shards=2,
                                       batch_aggregation=True)
    else:
        store = tstore.ModelStore(torch_tree(init), ["c0"],
                                  batch_aggregation=True)
        jst = jstore.ModelStore(jax_tree(init), ["c0"],
                                batch_aggregation=True)
    for lk in (("cluster", "c0"), ("global", None)):
        for s, port in ((store, True), (jst, False)):
            for tree in (good, poison):
                replay_one(s, (GLOBAL if lk[1] is None else "c0", tree,
                               (10, 1, 5), (10, 1, 1)), port)
        before = store.effective_round(*lk)
        assert before == jst.effective_round(*lk) == 2
        with pytest.raises(RuntimeError):
            store.drain(*lk)
        with pytest.raises(TypeError):
            jst.drain(*lk)
        for s in (store, jst):
            assert s.pending_depth(*lk) == 2          # batch restored
            assert s.effective_round(*lk) == before   # no phantom rounds
            assert s.meta(*lk).round == 0             # nothing half-applied


@pytest.mark.parametrize("level", ["global", "cluster"])
@pytest.mark.parametrize("sharded", [False, True])
def test_submit_many_equals_single_enqueues(sharded, level):
    rng = np.random.default_rng(3)
    init = np_tree(rng)
    key = None if level == "global" else "c1"
    ups = [(np_tree(rng), (s, 1, 1), (s, 1, 1))
           for s in rng.integers(1, 99, size=11).tolist()]

    def store():
        if sharded:
            return tstore.ShardedModelStore(torch_tree(init), ["c0", "c1"],
                                            n_shards=3, batch_aggregation=True,
                                            max_coalesce=4)
        return tstore.ModelStore(torch_tree(init), ["c0", "c1"],
                                 batch_aggregation=True, max_coalesce=4)

    def port(u):
        p, m, d = u
        return torch_tree(p), agg.ModelMeta(*m), agg.UpdateDelta(*d)

    many, single = store(), store()
    assert many.submit_many(level, key, [port(u) for u in ups[:6]]) > 0
    assert many.submit_many(level, key, (port(u) for u in ups[6:])) > 0
    assert many.submit_many(level, key, []) == 0
    for u in ups:
        single.enqueue_update(level, key, *port(u))
    assert many.pending_depth(level, key) == single.pending_depth(level, key)
    assert many.effective_round(level, key) == 11
    many.drain_all()
    single.drain_all()
    assert many.agg_stats() == single.agg_stats()
    assert many.meta(level, key) == single.meta(level, key)
    for k in init:
        assert torch.equal(many.params(level, key)[k],
                           single.params(level, key)[k])
    # against the reference's submit_many
    jst = (jstore.ShardedModelStore(jax_tree(init), ["c0", "c1"], n_shards=3,
                                    batch_aggregation=True, max_coalesce=4)
           if sharded else
           jstore.ModelStore(jax_tree(init), ["c0", "c1"],
                             batch_aggregation=True, max_coalesce=4))
    jst.submit_many(level, key, [(jax_tree(p), jagg.ModelMeta(*m),
                                  jagg.UpdateDelta(*d)) for p, m, d in ups])
    jst.drain_all()
    assert meta_tuple(many.meta(level, key)) == meta_tuple(jst.meta(level, key))
    assert many.agg_stats() == jst.agg_stats()
    assert_close(many.params(level, key), jst.params(level, key))
    # the direct path: N sequential updates
    direct = tstore.ShardedModelStore(torch_tree(init), ["c0", "c1"]) \
        if sharded else tstore.ModelStore(torch_tree(init), ["c0", "c1"])
    assert direct.submit_many(level, key, [port(u) for u in ups]) == 0
    assert direct.n_updates == 11 and direct.meta(level, key).round == 11


def test_migration_mid_schedule_leaves_the_fold_equal():
    """A mid-stream ``migrate_cluster`` gives bit-equal weights, metadata,
    staleness reference and submit counts to the same schedule without
    it, and the reference's migrated run within atol."""
    rng = np.random.default_rng(23)
    init = np_tree(rng)
    keys = [f"c{i}" for i in range(6)]
    events = make_schedule(rng, [GLOBAL] + keys, n_updates=80)
    mkey = max(keys, key=lambda k: sum(1 for m, *_ in events if m == k))

    def run(port, migrate):
        mod, tree, cfg = ((tstore, torch_tree, agg.AggregationConfig)
                          if port else
                          (jstore, jax_tree, jagg.AggregationConfig))
        store = mod.ShardedModelStore(tree(init), keys, cfg(**NOFAST),
                                      n_shards=4, batch_aggregation=True,
                                      max_coalesce=5)
        if migrate:
            dst = (store.shard_of(mkey) + 1) % 4
            assert store.ownership_epoch() == 0
            replay(store, events, port, np.random.default_rng(99),
                   migrate_at=len(events) // 2, migrations=[(mkey, dst)])
            assert store.shard_of(mkey) == dst and store.ownership_epoch() == 1
        else:
            replay(store, events, port, np.random.default_rng(99))
        assert store.pending_depth("cluster", mkey) == 0
        return store

    base, moved, jmoved = run(True, False), run(True, True), run(False, True)
    for lk in model_lks(keys):
        assert moved.meta(*lk) == base.meta(*lk), lk
        assert moved.effective_round(*lk) == base.effective_round(*lk), lk
        for k in init:
            assert torch.equal(moved.params(*lk)[k], base.params(*lk)[k])
        assert meta_tuple(moved.meta(*lk)) == meta_tuple(jmoved.meta(*lk))
        assert_close(moved.params(*lk), jmoved.params(*lk), msg=str(lk))
    bs, ms = base.agg_stats(), moved.agg_stats()
    for stat in ("updates", "enqueued", "fast_path_frac"):
        assert bs[stat] == ms[stat], stat
    assert bs["cluster_migrations"] == 0
    assert ms["cluster_migrations"] == 1 and ms["ownership_epoch"] == 1
    assert ms == jmoved.agg_stats()
    flat = tstore.ModelStore(torch_tree(init), keys)
    with pytest.raises(RuntimeError):
        flat.migrate_cluster(keys[0], 1)
    with pytest.raises(KeyError):
        moved.migrate_cluster("nowhere", 1)


def test_secure_rounds_stay_isolated_per_shard():
    """A dropout in one shard's secure round leaves the other shard's
    model bit-equal to a clean run, and the dropped round recovers to the
    unmasked fold of its survivors; the reference agrees on both."""
    rng = np.random.default_rng(13)
    init = np_tree(rng)
    probe = tstore.ShardedModelStore(torch_tree(init), n_shards=2)
    cands = [f"c{i}" for i in range(16)]
    key_a = cands[0]
    key_b = next(k for k in cands if probe.shard_of(k) != probe.shard_of(key_a))
    keys, ids = [key_a, key_b], [f"m{j}" for j in range(3)]
    n = sum(v.size for v in init.values())

    def drive(port, with_dropout, mask_scale):
        mk = (PairwiseMasker if port else JaxMasker)(seed=2,
                                                     mask_scale=mask_scale)
        mod, tree = (tstore, torch_tree) if port else (jstore, jax_tree)
        delta = agg.UpdateDelta if port else jagg.UpdateDelta
        store = mod.ShardedModelStore(tree(init), keys, n_shards=2, masker=mk)
        assert store.shard_of(key_a) != store.shard_of(key_b)
        for key in keys:
            mkey = store.model_key("cluster", key)
            subs = ids[:-1] if (with_dropout and key == key_a) else ids
            for cid in subs:
                d = np.random.default_rng(
                    zlib.crc32(f"{cid}/{key}".encode())).standard_normal(n)
                d = d.astype(np.float32)
                if port:
                    masked = unflatten_params(mk.mask_delta_flat(
                        torch.from_numpy(d), cid, ids, 0, mkey, weight=10.0),
                        store.params("cluster", key))
                else:
                    from repro.utils.tree import unflatten_params as junflat
                    masked = junflat(mk.mask_delta_flat(
                        jnp.asarray(d), cid, ids, 0, mkey, weight=10.0), init)
                store.submit_secure("cluster", key, cid, 0, masked,
                                    delta(10, 1, 1))
            store.drain_secure("cluster", key, 0, ids)
        return store

    for port in (True, False):
        dropped, clean = drive(port, True, 2.0), drive(port, False, 2.0)
        unmasked = drive(port, True, 0.0)
        assert dropped.n_secure_recoveries == 1
        assert dropped.agg_stats()["secure_rounds"] == 2
        for k in init:
            np.testing.assert_array_equal(
                np.asarray(dropped.params("cluster", key_b)[k]),
                np.asarray(clean.params("cluster", key_b)[k]))
        if port:
            got = {k: v for k, v in dropped.params("cluster", key_a).items()}
            assert_close(got, unmasked.params("cluster", key_a), atol=1e-4)
            port_dropped = dropped
        else:
            for key in keys:
                assert_close(port_dropped.params("cluster", key),
                             dropped.params("cluster", key), atol=1e-4)


# ------------------------------------------------------------- the facade
SPACE = dict(eps=100.0, min_samples=2, metric="haversine")


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
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_fedccl_sharded_sim_matches_jax(shards, batched):
    kw = dict(server_shards=shards, batch_aggregation=batched,
              max_coalesce=3, rebalance_policy="load",
              rebalance_hot_ratio=1.0)
    fed, jfed = facade_pair(**kw)
    assert isinstance(fed.store, tstore.ShardedModelStore)
    stats, jstats = fed.run(rounds=3), jfed.run(rounds=3)
    assert stats == jstats
    assert stats["shards"] == shards
    assert (sum(stats["shard_enqueued"]) > 0) == batched
    for lk in model_lks(fed.store.keys()):
        assert meta_tuple(fed.store.meta(*lk)) == \
            meta_tuple(jfed.store.meta(*lk))
        np.testing.assert_allclose(fed.store.params(*lk)["w"].numpy(),
                                   np.asarray(jfed.store.params(*lk)["w"]),
                                   atol=ATOL)
    # "load" rebalancing makes the reference's migration, then a run on
    # the new placement folds as the reference's does
    moves, jmoves = fed.rebalance(), jfed.rebalance()
    assert moves == jmoves
    if batched and shards == 3:       # this schedule loads one shard most
        assert len(moves) == 1
    assert fed.store.agg_stats() == jfed.store.agg_stats()
    assert fed.run(rounds=1) == jfed.run(rounds=1)
    fed.shutdown()
    jfed.shutdown()
    for lk in model_lks(fed.store.keys()):
        np.testing.assert_allclose(fed.store.params(*lk)["w"].numpy(),
                                   np.asarray(jfed.store.params(*lk)["w"]),
                                   atol=ATOL)


def test_fedccl_migrate_cluster_and_rebalance_policies():
    fed, jfed = facade_pair(server_shards=2)
    key = fed.store.keys()[0]
    dst = 1 - fed.store.shard_of(key)
    assert fed.migrate_cluster(key, dst) == jfed.migrate_cluster(key, dst) == 1
    assert fed.store.shard_of(key) == dst
    assert fed.rebalance() == jfed.rebalance() == []      # policy None
    flat, _ = facade_pair()
    with pytest.raises(RuntimeError):
        flat.migrate_cluster(key, 0)
    bad, _ = facade_pair(server_shards=2, rebalance_policy="hot")
    with pytest.raises(ValueError, match="rebalance_policy"):
        bad.rebalance()


# ------------------------------------------------------ threaded runtime
def test_threaded_sharded_run_no_lost_updates_and_clean_shutdown():
    fed = FedCCL(FedCCLConfig(spaces=(ClusterSpaceConfig("loc", **SPACE),),
                              ewc_lambda=0.05, seed=5, runtime="threaded",
                              server_shards=2, batch_aggregation=True,
                              max_coalesce=3),
                 {"w": torch.zeros(())}, scalar_train_fn, device="cpu")
    fed.setup(specs_for(ClientSpec, 5))
    rounds = 3
    stats = fed.run(rounds=rounds)
    names = sorted(t.name for t in fed._runtime.drain_workers)
    assert names == ["drain-global", "drain-shard-0", "drain-shard-1"]
    assert all(not t.is_alive() for t in fed._runtime.drain_workers)
    n_clients = len(fed.clients)
    want = sum(rounds * (1 + len(c.cluster_keys)) for c in fed.clients)
    assert stats["updates"] == stats["enqueued"] == want
    assert stats["drain_timeouts"] == 0 and stats["global_drains"] >= 1
    assert fed.store.meta("global").round == rounds * n_clients
    assert fed.store.meta("global").samples_learned == \
        rounds * sum(c.spec.dataset[1] for c in fed.clients)
    for lk in model_lks(fed.store.keys()):
        assert fed.store.pending_depth(*lk) == 0
    fed.shutdown()


def test_threaded_sharded_stress_no_lost_updates():
    """8 submitter threads against 4 shard pumps and the global pump, with
    a reader holding effective_round monotone and agg_stats consistent."""
    rng = np.random.default_rng(23)
    init = np_tree(rng)
    keys = [f"s{i}" for i in range(8)]
    store = tstore.ShardedModelStore(
        torch_tree(init), keys, agg.AggregationConfig(**NOFAST), n_shards=4,
        batch_aggregation=True, max_coalesce=6)
    n_threads, per_thread = 8, 30
    stop_reader = threading.Event()
    violations = []

    def submitter(t):
        trng = np.random.default_rng(1000 + t)
        for _ in range(per_thread):
            s = int(trng.integers(1, 100))
            tree = torch_tree(np_tree(trng))
            key = keys[int(trng.integers(len(keys)))]
            store.handle_model_update("cluster", key, tree,
                                      agg.ModelMeta(s, 1, 1),
                                      agg.UpdateDelta(s, 1, 1))
            store.handle_model_update("global", None, tree,
                                      agg.ModelMeta(s, 1, 1),
                                      agg.UpdateDelta(s, 1, 1))

    def reader():
        last = {}
        while not stop_reader.is_set():
            for lk in model_lks(keys):
                r = store.effective_round(*lk)
                if r < last.get(lk, 0):
                    violations.append((lk, last[lk], r))
                last[lk] = r
            stats = store.agg_stats()
            if stats["updates"] > stats["enqueued"] or \
                    not 0.0 <= stats["fast_path_frac"] <= 1.0:
                violations.append(stats)

    rt = AsyncThreadedRuntime([], store, drain_poll=1e-4, join_timeout=20.0)
    stop = threading.Event()
    rt._start_drain_workers(stop)
    assert len(rt.drain_workers) == 5
    watcher = threading.Thread(target=reader)
    watcher.start()
    subs = [threading.Thread(target=submitter, args=(t,))
            for t in range(n_threads)]
    t0 = time.perf_counter()
    for t in subs:
        t.start()
    for t in subs:
        t.join(30.0)
        assert not t.is_alive(), "submitter deadlocked"
    rt._join_drain_workers(stop)
    stop_reader.set()
    watcher.join(10.0)
    assert not watcher.is_alive() and not rt.errors and not violations
    assert time.perf_counter() - t0 < 60.0
    total = n_threads * per_thread * 2
    assert store.n_enqueued == store.n_updates == total
    assert store.pending_depth("global") == 0
    assert store.meta("global").round + sum(
        store.meta("cluster", k).round for k in keys) == total


# ------------------------------------------------------- the solar run
def test_solar_sharded_sim_matches_jax(monkeypatch):
    """The solar run at hidden 16 with its store sharded 2 ways in both
    packages: clusters, stats (shard fields included) and Table II within
    1e-3 pp."""
    for mod in (jax_fed_solar, torch_fed_solar):
        monkeypatch.setattr(mod, "FedCCLConfig", functools.partial(
            mod.FedCCLConfig, server_shards=2, batch_aggregation=True,
            max_coalesce=8))
    ref, got, gap = solar_parity(**SMALL)
    assert got["clusters"] == ref["clusters"]
    assert got["async_stats"] == ref["async_stats"]
    assert got["async_stats"]["shards"] == 2
    assert gap <= 1e-3


def test_round_robin_seq_is_monotone_per_shard():
    store = tstore.ShardedModelStore({"w": torch.zeros(())}, n_shards=3,
                                     batch_aggregation=True)
    for s in range(10):
        store.enqueue_update("global", None, {"w": torch.tensor(float(s))},
                             agg.ModelMeta(1, 1, 5), agg.UpdateDelta(1, 1, 1))
    seqs = [[s for s, _ in sh.global_pending] for sh in store._shards]
    assert seqs == [[0, 3, 6, 9], [1, 4, 7], [2, 5, 8]]
    assert store.agg_stats()["shard_enqueued"] == [4, 3, 3]
    assert store.drain_global() == 10 and store.pending_depth("global") == 0
