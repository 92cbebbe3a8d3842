"""Algorithm 2, the single-lock ``ModelStore`` and the ``FedCCL`` facade of
the port against the JAX package.

Scalar arithmetic (``ModelMeta``, ``plan_coalesce`` weights, ``_pad_pow2``)
must match exactly; folded tensors within atol 1e-6.  The store schedules
reuse the scalar ``train_fn`` of ``tests/test_protocol_store.py``.  The
immutability test holds the port to what JAX's immutable arrays gave the
reference for free: training and folding never change a tensor that a
client, the store or the shared initial parameters still hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.fedccl import ClusterSpaceConfig as JaxSpace
from repro.core.fedccl import FedCCL as JaxFedCCL
from repro.core.fedccl import FedCCLConfig as JaxFedCCLConfig
from repro.core.protocol import ClientSpec as JaxClientSpec
from repro_torch.core import aggregation as agg
from repro_torch.core.fedccl import ClusterSpaceConfig, FedCCL, FedCCLConfig
from repro_torch.core.fetch import FetchClient
from repro_torch.core.protocol import ClientSpec
from repro_torch.core.store import (
    ModelStore,
    ProcessShardedModelStore,
    ShardedModelStore,
)
from repro_torch.core.transport import WorkerUnavailable
from repro_torch.data.solar import generate_fleet
from repro_torch.data.windows import make_windows, split_windows
from repro_torch.obs.record import Telemetry
from repro_torch.models.lstm import SolarForecaster
from repro_torch.privacy.dp import DPConfig, DPPrivatizer
from repro_torch.privacy.secure_agg import PairwiseMasker
from repro_torch.configs.solar_lstm import SolarLSTMConfig
from repro_torch.training.fed_solar import make_solar_fns, make_train_fn
from repro_torch.utils.tree import params_from_numpy, tree_leaves, tree_map


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
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"v": rng.standard_normal(7).astype(np.float32)}}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_trees_close(got, want, atol=1e-6):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def random_meta_deltas(rng, n):
    out = []
    for _ in range(n):
        m = agg.ModelMeta(int(rng.integers(0, 300)), int(rng.integers(0, 9)),
                          int(rng.integers(0, 6)))
        d = agg.UpdateDelta(int(rng.integers(0, 300)), int(rng.integers(1, 4)),
                            1)
        out.append((m, d))
    return out


def as_jax_meta(m):
    return jagg.ModelMeta(m.samples_learned, m.epochs_learned, m.round)


def as_jax_delta(d):
    return jagg.UpdateDelta(d.samples_learned, d.epochs_learned, d.rounds)


# ------------------------------------------------------- exact scalar half
@pytest.mark.parametrize("seed", range(6))
def test_plan_coalesce_and_meta_exact(seed):
    rng = np.random.default_rng(seed)
    base = agg.ModelMeta(int(rng.integers(0, 200)), 2, int(rng.integers(0, 4)))
    md = random_meta_deltas(rng, int(rng.integers(1, 20)))
    plan = agg.plan_coalesce(base, md)
    jplan = jagg.plan_coalesce(as_jax_meta(base),
                               [(as_jax_meta(m), as_jax_delta(d))
                                for m, d in md])
    assert plan.weights == jplan.weights          # bit-identical floats
    assert plan.n_fast_path == jplan.n_fast_path
    assert (plan.meta.samples_learned, plan.meta.epochs_learned,
            plan.meta.round) == (jplan.meta.samples_learned,
                                 jplan.meta.epochs_learned, jplan.meta.round)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17])
def test_pad_pow2_exact(n):
    sets, ws = agg._pad_pow2(list(range(n)), [0.5] * n)
    jsets, jws = jagg._pad_pow2(list(range(n)), [0.5] * n)
    assert sets == jsets and ws == jws


# ------------------------------------------------------- tensor folds
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("updated_round", [1, 3])
def test_aggregate_models_matches_jax(use_pallas, updated_round, rng):
    base, upd = np_tree(rng), np_tree(rng)
    bm, um = agg.ModelMeta(120, 3, 2), agg.ModelMeta(40, 1, updated_round)
    delta = agg.UpdateDelta(40, 1, 1)
    out, meta = agg.aggregate_models(params_from_numpy(base, "cpu"), bm,
                                     params_from_numpy(upd, "cpu"), um, delta)
    jout, jmeta = jagg.aggregate_models(
        to_jax(base), as_jax_meta(bm), to_jax(upd), as_jax_meta(um),
        as_jax_delta(delta), jagg.AggregationConfig(use_pallas=use_pallas))
    assert_trees_close(out, jout)
    assert meta == agg.ModelMeta(jmeta.samples_learned, jmeta.epochs_learned,
                                 jmeta.round)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("counts", [[10], [10, 30, 60], [5, 0, 5, 9, 1],
                                    [0, 0, 0]])
def test_multi_aggregate_matches_jax(use_pallas, counts, rng):
    trees = [np_tree(rng) for _ in counts]
    out = agg.multi_aggregate([params_from_numpy(t, "cpu") for t in trees],
                              counts)
    jout = jagg.multi_aggregate([to_jax(t) for t in trees], counts,
                                jagg.AggregationConfig(use_pallas=use_pallas))
    assert_trees_close(out, jout)


@pytest.mark.parametrize("seed", range(4))
def test_coalesced_aggregate_matches_jax(seed):
    rng = np.random.default_rng(seed)
    base = np_tree(rng)
    bm = agg.ModelMeta(100, 2, 3)
    md = random_meta_deltas(rng, int(rng.integers(2, 12)))
    ups = [np_tree(rng) for _ in md]
    res = agg.coalesced_aggregate(
        params_from_numpy(base, "cpu"), bm,
        [(params_from_numpy(p, "cpu"), m, d)
         for p, (m, d) in zip(ups, md, strict=True)])
    jres = jagg.coalesced_aggregate(
        to_jax(base), as_jax_meta(bm),
        [(to_jax(p), as_jax_meta(m), as_jax_delta(d))
         for p, (m, d) in zip(ups, md, strict=True)])
    assert_trees_close(res.params, jres.params)
    assert (res.n_folded, res.n_param_sets, res.n_fast_path) == \
        (jres.n_folded, jres.n_param_sets, jres.n_fast_path)


# ------------------------------------------------------- store schedules
def scalar_train_fn(params, dataset, rng, anchor):
    """Works on torch tensors and JAX arrays alike."""
    target, n = dataset
    w = params["w"]
    for _ in range(3):
        g = w - target
        if anchor is not None:
            g = g + anchor.lam * (w - anchor.anchor["w"])
        w = w - 0.3 * g
    return {"w": w}, n, 3


def specs_for(spec_cls, seed, n_per_group=3):
    rng = np.random.default_rng(seed)
    specs = []
    for tag, lat, lon, target in (("a", 48.2, 16.4, 1.0),
                                  ("b", 52.5, 13.4, -1.0)):
        for i in range(n_per_group):
            specs.append(spec_cls(
                f"{tag}{i}", {"loc": np.array([lat + rng.normal(0, .2),
                                               lon + rng.normal(0, .2)])},
                (target, 100 + 10 * i), speed=rng.uniform(.5, 2)))
    return specs


@pytest.mark.parametrize("batched", [False, True])
def test_store_schedule_matches_jax(batched):
    kw = dict(ewc_lambda=0.05, seed=5, batch_aggregation=batched,
              max_coalesce=3)
    fed = FedCCL(FedCCLConfig(spaces=(ClusterSpaceConfig(
        "loc", eps=100.0, min_samples=2, metric="haversine"),), **kw),
        {"w": torch.zeros(())}, scalar_train_fn, device="cpu")
    jfed = JaxFedCCL(JaxFedCCLConfig(spaces=(JaxSpace(
        "loc", eps=100.0, min_samples=2, metric="haversine"),), **kw),
        {"w": jnp.zeros(())}, scalar_train_fn)
    assign = fed.setup(specs_for(ClientSpec, 5))
    jassign = jfed.setup(specs_for(JaxClientSpec, 5))
    assert assign == jassign
    stats, jstats = fed.run(rounds=4), jfed.run(rounds=4)
    assert stats == jstats
    assert fed.store.agg_stats() == jfed.store.agg_stats()
    assert sorted(fed.store.keys()) == sorted(jfed.store.keys())
    for level, key in [("global", None)] + [("cluster", k)
                                            for k in fed.store.keys()]:
        m, jm = fed.store.meta(level, key), jfed.store.meta(level, key)
        assert (m.samples_learned, m.epochs_learned, m.round) == \
            (jm.samples_learned, jm.epochs_learned, jm.round)
        np.testing.assert_allclose(float(fed.store.params(level, key)["w"]),
                                   float(jfed.store.params(level, key)["w"]),
                                   atol=1e-6)
    for c, jc in zip(fed.clients, jfed.clients, strict=True):
        np.testing.assert_allclose(float(c.local_params["w"]),
                                   float(jc.local_params["w"]), atol=1e-6)
        for level in ("auto", "local", "global", "cluster"):
            (p, tag), (jp, jtag) = (fed.model_for(c.spec.client_id, level),
                                    jfed.model_for(c.spec.client_id, level))
            assert tag == jtag
            np.testing.assert_allclose(float(p["w"]), float(jp["w"]),
                                       atol=1e-6)
    # Predict & Evolve: a new site joins next to the "b" group
    spec = dict(client_id="new",
                static_features={"loc": np.array([52.55, 13.45])},
                dataset=(-1.0, 50))
    (keys, p), (jkeys, jp) = (fed.join(ClientSpec(**spec)),
                              jfed.join(JaxClientSpec(**spec)))
    assert keys == jkeys and keys
    np.testing.assert_allclose(float(p["w"]), float(jp["w"]), atol=1e-6)


def test_store_inline_and_batched_fold_the_same():
    stores = [ModelStore({"w": torch.zeros(4)}, cluster_keys=["c0"],
                         batch_aggregation=b, max_coalesce=8)
              for b in (False, True)]
    for i in range(6):
        for st in stores:
            st.handle_model_update(
                "cluster", "c0", {"w": torch.full((4,), float(i + 1))},
                agg.ModelMeta(10 * (i + 1), 1, 1 + i // 2),
                agg.UpdateDelta(10 * (i + 1), 1, 1))
    assert stores[1].drain_all() == 6
    torch.testing.assert_close(stores[0].params("cluster", "c0")["w"],
                               stores[1].params("cluster", "c0")["w"],
                               rtol=0, atol=1e-6)
    assert stores[0].meta("cluster", "c0") == stores[1].meta("cluster", "c0")


# ------------------------------------------------------- facade surface
@pytest.mark.parametrize("privacy", [
    {}, {"dp_clip": 0.5, "dp_noise_multiplier": 1.2},
    {"dp_clip": 0.5, "dp_noise_multiplier": 1.2, "secure_agg": True}],
    ids=["off", "dp", "dp-secure"])
def test_privacy_report_has_the_reference_shape(privacy):
    """The report before and after a run; its epsilons depend only on the
    noise multiplier and the release count, not on the noise drawn."""
    kw = dict(spaces=(), seed=3, **privacy)
    fed = FedCCL(FedCCLConfig(**kw), {"w": torch.zeros(())}, scalar_train_fn,
                 device="cpu")
    jfed = JaxFedCCL(JaxFedCCLConfig(**kw), {"w": jnp.zeros(())},
                     scalar_train_fn)
    assert fed.privacy_report() == jfed.privacy_report()
    fed.setup(specs_for(ClientSpec, 3, n_per_group=1))
    jfed.setup(specs_for(JaxClientSpec, 3, n_per_group=1))
    fed.run(rounds=2)
    jfed.run(rounds=2)
    assert fed.privacy_report() == jfed.privacy_report()
    if privacy:
        assert fed.privacy_report()["per_client"]


@pytest.mark.parametrize("option", [
    {"server_processes": 2}, {"server_hosts": ("localhost:1",)},
    {"fetch_from_workers": True}, {"telemetry": True}])
def test_later_slices_raise(option):
    """Every option of the later slices is ported: the process, TCP and
    read tiers build their store and fetch client (a shard server nobody
    listens for raises the transport's error, after the connect deadline's
    10 s of retries), and telemetry builds its sink and no longer raises
    ``NotImplementedError``."""
    if "telemetry" in option:
        fed = FedCCL(FedCCLConfig(**option), {"w": torch.zeros(2)}, None,
                     device="cpu")
        assert isinstance(fed.store.telemetry, Telemetry)
        assert fed.metrics_report("json")["sites"] == ["parent"]
        fed.shutdown()
        return
    if "server_hosts" in option:
        with pytest.raises(WorkerUnavailable, match="localhost:1"):
            FedCCL(FedCCLConfig(**option), {"w": torch.zeros(2)}, None,
                   device="cpu")
        return
    fed = FedCCL(FedCCLConfig(**option), {"w": torch.zeros(2)}, None,
                 device="cpu")
    if "server_processes" in option:
        assert isinstance(fed.store, ProcessShardedModelStore)
        assert fed.store.transport_kind() == "inprocess"   # the sim's
        assert fed.store.n_shards == 2
    else:
        assert isinstance(fed.fetcher, FetchClient)
        assert not fed.fetcher.use_workers      # no TCP servers: parent
    fed.shutdown()


# ------------------------------------------------------- immutability
def test_training_and_folds_leave_shared_tensors_unchanged():
    """JAX arrays are immutable, and the reference leans on that: every
    client starts from the same ``init_params`` object, the store keeps a
    client's own tree on the fast path, and ``make_anchor`` does not copy.
    The port must never update a parameter tensor in place."""
    fleet = generate_fleet(n_sites=2, n_days=9, seed=0)
    windows = [split_windows(make_windows(d), train_frac=0.8)[0]
               for _, d in fleet]
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=4))
    init = fc.init(torch.Generator().manual_seed(0), "cpu")
    sgd_step, _ = make_solar_fns(fc, lr=0.05)
    fed = FedCCL(FedCCLConfig(spaces=(), ewc_lambda=0.05), init,
                 make_train_fn(sgd_step, epochs=1, batch_size=4),
                 device="cpu")
    fed.setup([ClientSpec(s.site_id, s.static_features, w)
               for (s, _), w in zip(fleet, windows, strict=True)])
    a, b = fed.clients

    def frozen(tree):
        return tree_map(lambda x: x.detach().clone(), tree)

    def same(tree, copy):
        return all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(tree), tree_leaves(copy), strict=True))

    init_copy = frozen(init)
    a.train_local()                              # no anchor yet
    a.train_local()                              # anchored on its own params
    assert a.local_params is not init and same(init, init_copy)
    # FedCCL shares the init tensors themselves with every client
    assert all(x is y for x, y in zip(tree_leaves(b.local_params),
                                      tree_leaves(init), strict=True))
    assert same(b.local_params, init_copy)

    snap, meta = a.fetch(fed.store, "global")
    snap_copy = frozen(snap)
    upd_a = a.train_update(snap, meta)           # anchored on the snapshot
    upd_b = b.train_update(snap, meta)
    upd_a_copy = frozen(upd_a[0])
    a.submit(fed.store, "global", None, *upd_a)  # fast path: stores a's tree
    assert fed.store.params("global") is upd_a[0]
    b.submit(fed.store, "global", None, *upd_b)  # weighted fold
    assert fed.store.n_updates == 2 and fed.store.n_fast_path == 1
    folded = fed.store.params("global")
    assert folded is not upd_a[0] and not same(folded, upd_a_copy)
    assert same(snap, snap_copy)                 # the fetched snapshot
    assert same(upd_a[0], upd_a_copy)            # a's tree the fold read
    assert same(init, init_copy)                 # the shared init
    assert same(b.local_params, init_copy)       # the other client's params

    # a privatized update and a masked submission leave the fetched tensors
    # (and everything else shared) as they were
    a.privatizer = DPPrivatizer(DPConfig(clip=0.1, noise_multiplier=0.5),
                                a.spec.client_id, seed=1)
    snap, meta = a.fetch(fed.store, "global")
    snap_copy = frozen(snap)
    priv = a.train_update(snap, meta)[0]
    assert not same(priv, snap_copy) and same(snap, snap_copy)
    secure = ModelStore(init, masker=PairwiseMasker(seed=1, mask_scale=2.0))
    ids = [a.spec.client_id, b.spec.client_id]
    for c in (a, b):
        c.secure_round_update(secure, "global", None, ids, 0)
    assert same(init, init_copy)                 # the fetched snapshot
    assert secure.drain_secure("global", None, 0, ids) == 2
    assert secure.params("global") is not init
    assert same(init, init_copy) and same(b.local_params, init_copy)

    # the two-level fold of the sharded store: a lone fast-path survivor is
    # the client's own tree, a fold over both shards builds a new one, and
    # neither changes a tensor it read
    sharded = ShardedModelStore(init, n_shards=2, batch_aggregation=True)
    snap, meta = a.fetch(sharded, "global")
    snap_copy = frozen(snap)
    ups = [a.train_update(snap, meta), b.train_update(snap, meta)]
    a.submit(sharded, "global", None, *ups[0])
    assert sharded.drain_global() == 1
    assert sharded.params("global") is ups[0][0]
    ups.append(a.train_update(snap, meta))
    copies = [frozen(u[0]) for u in ups]
    for u in ups[1:]:
        b.submit(sharded, "global", None, *u)
    assert sharded.drain_global() == 2
    assert sharded.agg_stats()["global_partials"] == 2
    folded = sharded.params("global")
    assert all(folded is not u[0] for u in ups)
    assert all(same(u[0], c) for u, c in zip(ups, copies, strict=True))
    assert same(snap, snap_copy) and same(init, init_copy)
