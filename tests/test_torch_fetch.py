"""The port's read tier (``repro_torch.core.fetch``) against the JAX
package's (``repro.core.fetch``): the delta codec, the wire cache,
``serve_fetch``, the stores' ``fetch_wire`` and the parent-served
``FetchClient``, and the endpoint-refresh dedup.

Inputs are made with numpy from a seed and handed to both packages.  Wire
bytes (packed snapshots, deltas, fetch replies, frames) must be equal
exactly; a client's fetched params must equal the store's own read byte
for byte (``packb`` of both).  Folded parameters across packages: atol
1e-5, the reference's tolerance for its own fold equivalence
(``tests/test_store_equivalence.py``).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.msgpack_ckpt import packb as jpackb
from repro.core import fetch as jfetch
from repro.core import store as jstore
from repro.core import transport as jtransport
from repro.core.aggregation import ModelMeta as JMeta
from repro_torch.checkpoint.msgpack_ckpt import packb
from repro_torch.core import fetch
from repro_torch.core import store as tstore
from repro_torch.core import transport
from repro_torch.core.aggregation import AggregationConfig, ModelMeta, UpdateDelta

GLOBAL = tstore.GLOBAL_KEY
NOFAST = AggregationConfig(sequential_fast_path=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_tree(rng, n=300):
    # sorted keys: the order JAX's tree functions give a folded tree
    return {"b": rng.standard_normal(16).astype(np.float32),
            "w": rng.standard_normal(n).astype(np.float32)}


def torch_tree(t):
    return {k: torch.from_numpy(v.copy()) for k, v in t.items()}


def jax_tree(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


# ---------------------------------------------------------------- codec
@pytest.mark.parametrize("seed,scale", [(7, 1e-3), (8, 1e-6), (9, 1.0)])
def test_delta_bytes_match_reference(seed, scale):
    """The port's packed pair equals the reference's, its delta bytes
    equal ``repro.core.fetch.encode_delta``'s, and ``apply_delta``
    reproduces the new encoding exactly."""
    rng = np.random.default_rng(seed)
    p0 = np_tree(rng)
    p1 = {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in p0.items()}
    base, new = packb(torch_tree(p0)), packb(torch_tree(p1))
    assert base == jpackb(jax_tree(p0)) and new == jpackb(jax_tree(p1))
    delta = fetch.encode_delta(base, new)
    assert delta == jfetch.encode_delta(base, new)
    assert fetch.apply_delta(base, delta) == new
    assert jfetch.apply_delta(base, delta) == new
    # another structure (another encoded length): no delta
    short = packb({"w": torch.from_numpy(p0["w"])})
    assert fetch.encode_delta(base, short) is None
    # a delta applied over the wrong base fails instead of decoding
    with pytest.raises(ValueError, match="does not match"):
        fetch.apply_delta(base[:-1], delta)


def test_fetch_constants_and_frame_match_reference():
    assert (fetch.FETCH_FULL, fetch.FETCH_NOT_MODIFIED, fetch.FETCH_DELTA) \
        == (jfetch.FETCH_FULL, jfetch.FETCH_NOT_MODIFIED,
            jfetch.FETCH_DELTA) == (0, 1, 2)
    assert fetch.DELTA_HISTORY == jfetch.DELTA_HISTORY
    assert fetch._DELTA_MAX_RATIO == jfetch._DELTA_MAX_RATIO
    for held in (None, [5, 1, 2]):
        payload = packb(["fetch", "c0", held])
        assert payload == jpackb(["fetch", "c0", held])
        assert transport.pack_frame(payload) == \
            jtransport.pack_frame(payload)


@pytest.mark.parametrize("case", ["full", "not_modified", "delta",
                                  "over_ratio", "unknown_held"])
def test_serve_fetch_matches_reference(case):
    """Same kind and payload bytes as the reference's ``serve_fetch`` for
    every result: a full first fetch, a not-modified ack, a delta over a
    cached version, a full reply where the delta would not beat the
    ratio (a new tree of random bits), and a held version nobody cached."""
    rng = np.random.default_rng(11)
    p0 = np_tree(rng)
    near = {k: v + np.float32(1e-4) for k, v in p0.items()}
    far = np_tree(rng)
    cache, jcache = fetch.WireCache(), jfetch.WireCache()

    def both(key, params, meta_w, held):
        got = fetch.serve_fetch(cache, key, torch_tree(params), meta_w, held)
        want = jfetch.serve_fetch(jcache, key, jax_tree(params), meta_w,
                                  held)
        assert got == want
        return got

    v0, v1 = [10, 1, 1], [20, 2, 2]
    kind, payload = both("c0", p0, v0, None)
    assert kind == fetch.FETCH_FULL and payload == packb(torch_tree(p0))
    if case == "full":
        return
    if case == "not_modified":
        assert both("c0", p0, v0, v0) == (fetch.FETCH_NOT_MODIFIED, None)
        return
    if case == "unknown_held":
        kind, payload = both("c0", near, v1, [3, 3, 3])
        assert kind == fetch.FETCH_FULL
        return
    kind, payload = both("c0", near if case == "delta" else far, v1, v0)
    if case == "delta":
        assert kind == fetch.FETCH_DELTA
        assert fetch.apply_delta(packb(torch_tree(p0)), payload) == \
            packb(torch_tree(near))
    else:
        assert kind == fetch.FETCH_FULL
        assert payload == packb(torch_tree(far))


def test_wire_cache_serializes_once_per_version_and_keeps_history(
        monkeypatch):
    calls = []
    real = fetch.packb

    def counted(obj):
        calls.append(1)
        return real(obj)
    monkeypatch.setattr(fetch, "packb", counted)
    cache = fetch.WireCache(history=2)
    rng = np.random.default_rng(3)
    trees = [torch_tree(np_tree(rng)) for _ in range(4)]
    a = cache.packed_for("k", (1, 1, 1), trees[0])
    assert cache.packed_for("k", [1, 1, 1], trees[0]) is a
    assert len(calls) == 1
    for i, t in enumerate(trees[1:], start=2):
        cache.packed_for("k", (i, i, i), t)
    assert len(calls) == 4
    assert cache.base_for("k", (4, 4, 4)) == packb(trees[3])
    assert cache.base_for("k", (3, 3, 3)) == packb(trees[2])
    assert cache.base_for("k", (2, 2, 2)) == packb(trees[1])
    assert cache.base_for("k", (1, 1, 1)) is None     # out of history
    assert cache.base_for("other", (4, 4, 4)) is None


# ------------------------------------------------------------ the stores
def make_store(kind, init, **kw):
    kw = dict(dict(agg_cfg=NOFAST, batch_aggregation=True, max_coalesce=5),
              **kw)
    keys = ["c0", "c1", "c2"]
    if kind == "flat":
        return tstore.ModelStore(init, keys, **kw)
    if kind == "sharded":
        return tstore.ShardedModelStore(init, keys, n_shards=2, **kw)
    return tstore.ProcessShardedModelStore(init, keys, n_shards=2,
                                           inprocess=True, device="cpu", **kw)


def replay(store, rng, n, models):
    for _ in range(n):
        m = models[int(rng.integers(len(models)))]
        s = int(rng.integers(1, 50))
        lk = ("global", None) if m == GLOBAL else ("cluster", m)
        store.handle_model_update(*lk, torch_tree(np_tree(rng)),
                                  ModelMeta(s, 1, 1), UpdateDelta(s, 1, 1))
    store.drain_all()


def assert_fetch_matches_store(fc, store, lks):
    """Every model through the fetch client equals the store's own read,
    byte for byte."""
    for lk in lks:
        p1, m1 = fc.fetch(*lk)
        p2, m2 = store.request_model(*lk)
        assert m1 == m2, lk
        assert packb(p1) == packb(p2), lk


@pytest.mark.parametrize("kind", ["flat", "sharded", "process"])
def test_fetch_client_parent_served_byte_identical(kind):
    """Parent-served conditional fetches: byte-identical to
    ``request_model`` at first, not-modified on repeat, byte-identical
    again after further folds (served as a delta or in full)."""
    rng = np.random.default_rng(67)
    store = make_store(kind, torch_tree(np_tree(rng)))
    models = [GLOBAL, "c0", "c1", "c2"]
    lks = [("global", None)] + [("cluster", k) for k in models[1:]]
    replay(store, rng, 20, models)
    fc = fetch.FetchClient(store, device="cpu")
    assert not fc.use_workers                  # no TCP endpoints here
    assert_fetch_matches_store(fc, store, lks)
    assert fc.counts["full"] == len(lks)
    assert_fetch_matches_store(fc, store, lks)
    assert fc.counts["not_modified"] == len(lks)
    replay(store, rng, 12, models)
    assert_fetch_matches_store(fc, store, lks)
    assert fc.counts["full"] + fc.counts["delta"] + \
        fc.counts["not_modified"] == 3 * len(lks)
    assert fc.counts["fallback"] == 0
    fc.close()
    if hasattr(store, "close"):
        store.close()


def test_fetch_wire_replies_match_reference_store():
    """The same schedule through the port's and the JAX package's flat
    stores: ``fetch_wire`` gives equal kinds and metas, and payloads equal
    byte for byte wherever the folds are (otherwise within the fold
    tolerance: the decoded params agree within 1e-5)."""
    rng = np.random.default_rng(5)
    init = np_tree(rng)
    keys = ["c0", "c1"]
    port = tstore.ModelStore(torch_tree(init), keys, NOFAST,
                             batch_aggregation=True)
    ref = jstore.ModelStore(jax_tree(init), keys,
                            jstore.AggregationConfig(
                                sequential_fast_path=False),
                            batch_aggregation=True)
    held = {}
    for step in range(3):
        for key in keys:
            t = np_tree(rng)
            s = int(rng.integers(1, 50))
            port.handle_model_update("cluster", key, torch_tree(t),
                                     ModelMeta(s, 1, 1), UpdateDelta(s, 1, 1))
            ref.handle_model_update("cluster", key, jax_tree(t),
                                    JMeta(s, 1, 1),
                                    jstore.UpdateDelta(s, 1, 1))
        port.drain_all()
        ref.drain_all()
        for key in keys + [None]:
            level = "global" if key is None else "cluster"
            h = held.get(key)
            got = port.fetch_wire(level, key, held=h)
            want = ref.fetch_wire(level, key, held=h)
            assert got[0] == want[0] and got[2] == want[2], (step, key)
            if got[0] == fetch.FETCH_FULL:
                a = fetch.unpackb(got[1], "cpu")
                b = fetch.unpackb(want[1], "cpu")
                for leaf in a:
                    np.testing.assert_allclose(a[leaf].numpy(),
                                               b[leaf].numpy(), atol=1e-5)
            held[key] = got[2]
    # an unchanged model answers not-modified in both packages
    assert port.fetch_wire("global", held=held[None])[0] == \
        ref.fetch_wire("global", held=held[None])[0] == \
        fetch.FETCH_NOT_MODIFIED


def test_fetch_client_respects_lazy_sync_read_barrier():
    """``mirror_sync_every > 1``: the parent-served path reads through
    ``request_model``, so a fetch after meta-only acks sees every fold."""
    rng = np.random.default_rng(71)
    store = tstore.ProcessShardedModelStore(
        torch_tree(np_tree(rng)), ["c0"], agg_cfg=NOFAST, n_shards=1,
        batch_aggregation=True, inprocess=True, mirror_sync_every=6,
        device="cpu")
    fc = fetch.FetchClient(store, device="cpu")
    for _ in range(4):
        store.handle_model_update("cluster", "c0", torch_tree(np_tree(rng)),
                                  ModelMeta(5, 1, 1), UpdateDelta(5, 1, 1))
        store.drain("cluster", "c0")           # meta-only acks
    assert store._records["c0"].snapshot()[1].round < 4   # raw mirror lags
    _, meta = fc.fetch("cluster", "c0")
    assert meta.round == 4                     # the barrier synced first
    assert_fetch_matches_store(fc, store, [("cluster", "c0")])
    store.close()


def test_fetch_client_unknown_key_raises_via_parent():
    store = tstore.ModelStore(torch_tree(np_tree(np.random.default_rng(1))),
                              ["c0"])
    fc = fetch.FetchClient(store, device="cpu")
    with pytest.raises(KeyError):
        fc.fetch("cluster", "nope")


def test_fetch_client_needs_a_device_or_a_card():
    store = tstore.ModelStore({"w": torch.zeros(2)})
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fetch.FetchClient(store)


# ------------------------------------------------ endpoint-refresh dedup
class FakeStore:
    """Just enough surface for the fetch client's wiring (no sockets)."""

    def __init__(self):
        self.epoch = 0
        self.endpoint_reads = 0
        self._lock = threading.Lock()

    def ownership_epoch(self):
        return self.epoch

    def fetch_endpoints(self):
        with self._lock:
            self.endpoint_reads += 1
        return {0: [("127.0.0.1", 1)]}

    def model_key(self, level, cluster_key=None):
        return "g" if level == "global" else f"c:{cluster_key}"


def test_refresh_dedup_under_concurrency():
    """16 threads observing the same stale epoch make exactly one refresh;
    a refresh without an observed epoch always runs."""
    store = FakeStore()
    fc = fetch.FetchClient(store, device="cpu")
    assert fc.use_workers and fc.counts["endpoint_refreshes"] == 0
    store.epoch = 1
    results = []
    barrier = threading.Barrier(16)

    def storm():
        barrier.wait(30.0)
        results.append(fc.refresh_endpoints(observed_epoch=0))

    threads = [threading.Thread(target=storm) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
        assert not t.is_alive()
    assert sum(results) == 1
    assert fc.counts["endpoint_refreshes"] == 1
    assert fc.refresh_endpoints(observed_epoch=0) is False
    assert fc.refresh_endpoints() is True
    assert fc.counts["endpoint_refreshes"] == 2


def test_refresh_skips_when_epoch_already_current():
    store = FakeStore()
    fc = fetch.FetchClient(store, device="cpu")
    reads0 = store.endpoint_reads
    store.epoch = 3
    assert fc.refresh_endpoints(observed_epoch=0) is True
    assert fc.refresh_endpoints(observed_epoch=0) is False
    assert store.endpoint_reads == reads0 + 1
