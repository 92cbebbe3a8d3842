"""The privacy path of the port against the JAX package: the dp_clip_noise
kernel's plain version, ``DPPrivatizer``, ``PairwiseMasker``,
``RDPAccountant``, ``secure_coalesced_aggregate``, the store's secure
rounds, the sim runtime's secure schedule and the solar run end to end.

Tolerances: the clip + noise release atol 1e-5 (the reference tests' own);
pairwise masks, reconstructions and accountant reports exactly equal (they
are numpy draws and Python floats in the same order); masked deltas within
f32 rounding (rtol/atol 1e-6); folds atol 1e-5; Table II / §IV.E 1e-3 pp
without noise and NOISY_PP with it (see there).

DP noise: the port draws it from a CPU ``torch.Generator``, the reference
from JAX's PRNG, so the two differ by design.  Tests that compare the
packages with noise on replace ``DPPrivatizer._noise`` with JAX's own draw
(``jax_noise``); the others set the noise multiplier to 0.
"""

import math
import sys
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # bare CI env: seeded-random fallback shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs.solar_lstm import SolarLSTMConfig as JaxSolarConfig
from repro.core import aggregation as jagg
from repro.core.fedccl import ClusterSpaceConfig as JaxSpace
from repro.core.fedccl import FedCCL as JaxFedCCL
from repro.core.fedccl import FedCCLConfig as JaxFedCCLConfig
from repro.core.protocol import ClientSpec as JaxClientSpec
from repro.core.store import ModelStore as JaxModelStore
from repro.kernels.dp_clip_noise.ops import privatize_flat as jax_privatize_flat
from repro.kernels.dp_clip_noise.ref import dp_clip_noise_ref as jax_dp_ref
from repro.models.lstm import SolarForecaster as JaxForecaster
from repro.privacy.accountant import RDPAccountant as JaxAccountant
from repro.privacy.accountant import gaussian_rdp as jax_gaussian_rdp
from repro.privacy.accountant import rdp_to_epsilon as jax_rdp_to_epsilon
from repro.privacy.dp import DPConfig as JaxDPConfig
from repro.privacy.dp import DPPrivatizer as JaxDPPrivatizer
from repro.privacy.secure_agg import PairwiseMasker as JaxMasker
from repro.training.fed_solar import make_solar_fns as jax_solar_fns
from repro.training.fed_solar import make_train_fn as jax_train_fn
from repro_torch.configs.solar_lstm import SolarLSTMConfig
from repro_torch.core import aggregation as agg
from repro_torch.core.fedccl import ClusterSpaceConfig, FedCCL, FedCCLConfig
from repro_torch.core.protocol import ClientSpec
from repro_torch.core.store import ModelStore
from repro_torch.data.solar import generate_fleet
from repro_torch.data.windows import make_windows, split_windows
from repro_torch.kernels.dp_clip_noise.ops import privatize_flat
from repro_torch.kernels.dp_clip_noise.ref import dp_clip_noise_ref
from repro_torch.models.lstm import SolarForecaster
from repro_torch.privacy import accountant as port_accountant
from repro_torch.privacy.accountant import RDPAccountant
from repro_torch.privacy.dp import DPConfig, DPPrivatizer, noise_seed
from repro_torch.privacy.secure_agg import PairwiseMasker
from repro_torch.training.fed_solar import make_solar_fns, make_train_fn
from repro_torch.utils.tree import (
    flatten_params,
    params_from_numpy,
    tree_leaves,
    tree_map,
)

from test_torch_federation import scalar_train_fn, specs_for

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from scripts.torch_parity import SMALL, solar_parity  # noqa: E402

ATOL = 1e-5
TABLE_PP = 1e-3
# With noise multiplier 0.3 at clip 5 the folded noise has a std near 1 on
# every weight of a cluster model with few members; the 672-step LSTM
# recurrence of such a model amplifies f32 summation-order differences
# between the packages (~1e-6) into Table II gaps, in that model's column
# only.  Over 22 values of PYTHONHASHSEED (the fleet's weather depends on
# ``hash(site_id)`` in data/solar.py, in both packages) the gap ranged from
# 1.9e-6 to 7.1e-2 pp, every other column within 3e-5 pp.
NOISY_PP = 0.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def jax_noise(self, t):
    """The reference's draw for the privatizer's current release
    (``repro/privacy/dp.py``), as a CPU tensor."""
    key = jax.random.fold_in(jax.random.key(self.seed), self._step)
    return t32(np.array(jax.random.normal(key, (t,), jnp.float32)))


@pytest.fixture
def with_jax_noise(monkeypatch):
    monkeypatch.setattr(DPPrivatizer, "_noise", jax_noise)


def np_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"v": rng.standard_normal(7).astype(np.float32)}}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_trees_close(got, want, atol=ATOL):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol)


# ------------------------------------------------------------ dp_clip_noise
def delta_case(rng, t, case):
    """A delta whose norm binds the clip, one well inside it, zeros, or
    one with a NaN (which makes every output NaN)."""
    if case == "zero":
        return np.zeros(t, np.float32)
    d = rng.standard_normal(t).astype(np.float32)
    norm = float(np.linalg.norm(d))
    target = 3.0 if case == "binding" else 0.25      # clip is 1.0
    d = (d * np.float32(target / norm)).astype(np.float32)
    if case == "nan":
        d[t // 2] = np.nan
    return d


@pytest.mark.parametrize("m", [0.0, 1.3])
@pytest.mark.parametrize("case", ["binding", "inside", "zero", "nan"])
@pytest.mark.parametrize("t", [5, 8192, 65_539])
def test_dp_plain_matches_jax_kernel(t, case, m):
    rng = np.random.default_rng(t + len(case))
    d = delta_case(rng, t, case)
    noise = rng.standard_normal(t).astype(np.float32)
    got = privatize_flat(t32(d), t32(noise), 1.0, m).numpy()
    want = np.asarray(jax_privatize_flat(jnp.asarray(d), jnp.asarray(noise),
                                         1.0, m, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        dp_clip_noise_ref(t32(d), t32(noise), 1.0, m).numpy(),
        np.asarray(jax_dp_ref(jnp.asarray(d), jnp.asarray(noise), 1.0, m)),
        rtol=0, atol=ATOL)
    if case == "zero":       # scale = min(1, clip / 1e-12) = 1
        np.testing.assert_array_equal(got, noise * np.float32(m))
    if m == 0.0 and case == "inside":
        np.testing.assert_array_equal(got, d)
    if case == "nan":
        assert np.isnan(got).all() and np.isnan(want).all()


def test_dp_empty_delta():
    assert privatize_flat(torch.zeros(0), torch.zeros(0), 1.0, 1.0).shape \
        == (0,)


@settings(max_examples=15, deadline=None)
@given(t=st.integers(3, 5000), clip=st.floats(0.05, 3.0))
def test_clipped_delta_norm_bounded_property(t, clip):
    """Privacy invariant: the clipped delta's global norm never exceeds
    ``dp_clip`` (noise_multiplier=0 isolates the clip)."""
    rng = np.random.default_rng(t * 7 + int(clip * 100))
    d = t32(rng.standard_normal(t) * rng.uniform(0.01, 10))
    out = privatize_flat(d, torch.zeros_like(d), clip, 0.0)
    assert float(torch.linalg.norm(out)) <= clip * (1 + 1e-5)


# ------------------------------------------------------------- DPPrivatizer
@pytest.mark.parametrize("m", [0.0, 0.3, 1.3])
def test_privatizer_matches_jax_with_jax_noise(m, with_jax_noise, rng):
    cfg = dict(clip=0.7, noise_multiplier=m)
    acc, jacc = RDPAccountant(), JaxAccountant()
    priv = DPPrivatizer(DPConfig(**cfg), "c0", seed=11, accountant=acc)
    jpriv = JaxDPPrivatizer(JaxDPConfig(**cfg), "c0", seed=11,
                            accountant=jacc)
    for key in ("__global__", "loc:0", "__global__"):
        base, new = np_tree(rng), np_tree(rng)
        got = priv.privatize(params_from_numpy(base, "cpu"),
                             params_from_numpy(new, "cpu"), key)
        want = jpriv.privatize(to_jax(base), to_jax(new), key)
        assert_trees_close(got, want)
        d = rng.standard_normal(300).astype(np.float32)
        np.testing.assert_allclose(
            priv.privatize_delta(t32(d), key).numpy(),
            np.asarray(jpriv.privatize_delta(jnp.asarray(d), key)),
            rtol=0, atol=ATOL)
    assert acc.client_report() == jacc.client_report()
    assert acc.model_report() == jacc.model_report()


def test_privatizer_noise_deterministic_per_seed(rng):
    base = params_from_numpy(np_tree(rng), "cpu")
    new = params_from_numpy(np_tree(rng), "cpu")
    cfg = DPConfig(clip=1.0, noise_multiplier=1.0)
    a = DPPrivatizer(cfg, "c0", seed=5).privatize(base, new)
    b = DPPrivatizer(cfg, "c0", seed=5).privatize(base, new)
    c = DPPrivatizer(cfg, "c0", seed=6).privatize(base, new)
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a), tree_leaves(b), strict=True))
    assert not torch.allclose(a["w"], c["w"])
    # successive releases of one privatizer draw fresh noise
    p = DPPrivatizer(cfg, "c0", seed=5)
    n0, n1 = p._noise(64), (setattr(p, "_step", 1), p._noise(64))[1]
    assert not torch.equal(n0, n1)
    assert len({noise_seed(s, k) for s in range(4) for k in range(4)}) == 16


def test_privatizer_clips_to_global_norm(rng):
    base = params_from_numpy(np_tree(rng), "cpu")
    new = tree_map(lambda v: v + 5 * torch.randn(v.shape,
                                                 generator=torch.Generator()
                                                 .manual_seed(3)), base)
    priv = DPPrivatizer(DPConfig(clip=0.7, noise_multiplier=0.0), "c0")
    out = priv.privatize(base, new)
    norm = float(torch.linalg.norm(flatten_params(out) - flatten_params(base)))
    assert norm <= 0.7 + 1e-5
    with pytest.raises(ValueError, match="positive"):
        DPPrivatizer(DPConfig(clip=0.0), "c0")


# ----------------------------------------------------------- PairwiseMasker
IDS = ["site003", "a", "b7", "zz"]


@pytest.mark.parametrize("scale", [0.0, 1.0, 2.5])
@pytest.mark.parametrize("round_id,key", [(0, "__global__"), (3, "loc:1"),
                                          (17, "ori:0")])
def test_masks_bit_equal_to_jax(scale, round_id, key):
    m, jm = PairwiseMasker(seed=7, mask_scale=scale), \
        JaxMasker(seed=7, mask_scale=scale)
    for cid in IDS:
        got = m.mask_flat(cid, IDS, round_id, key, 301)
        want = jm.mask_flat(cid, IDS, round_id, key, 301)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    got = m.reconstruct_flat(301, ["zz", "a"], ["b7", "site003"], round_id,
                             key)
    want = jm.reconstruct_flat(301, ["zz", "a"], ["b7", "site003"], round_id,
                               key)
    np.testing.assert_array_equal(got, want)


def test_masked_deltas_match_jax(rng):
    m, jm = PairwiseMasker(seed=2, mask_scale=1.5), \
        JaxMasker(seed=2, mask_scale=1.5)
    base, new = np_tree(rng), np_tree(rng)
    for cid in IDS:
        d = rng.standard_normal(37).astype(np.float32)
        np.testing.assert_allclose(
            m.mask_delta_flat(t32(d), cid, IDS, 4, "k", 130).numpy(),
            np.asarray(jm.mask_delta_flat(jnp.asarray(d), cid, IDS, 4, "k",
                                          130)), rtol=1e-6, atol=1e-6)
        got = m.mask_update(params_from_numpy(base, "cpu"),
                            params_from_numpy(new, "cpu"), cid, IDS, 4, "k",
                            55)
        want = jm.mask_update(to_jax(base), to_jax(new), cid, IDS, 4, "k", 55)
        assert list(got) == list(base)
        assert_trees_close(got, want, atol=1e-5)
    tmpl = params_from_numpy(base, "cpu")
    got = m.reconstruct(tmpl, ["a"], ["b7", "zz"], 4, "k")
    want = jm.reconstruct(to_jax(base), ["a"], ["b7", "zz"], 4, "k")
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------- RDPAccountant
@pytest.mark.parametrize("sigma", [0.0, 0.3, 1.1, 5.0])
@pytest.mark.parametrize("steps", [1, 3, 17])
def test_accountant_reports_equal_jax(sigma, steps):
    acc, jacc = RDPAccountant(target_delta=1e-5), \
        JaxAccountant(target_delta=1e-5)
    for i in range(steps):
        for a in (acc, jacc):
            a.record("c0", "__global__", sigma)
            a.record(f"c{1 + i % 3}", f"loc:{i % 2}", sigma)
    assert acc.client_report() == jacc.client_report()
    assert acc.model_report() == jacc.model_report()
    assert acc.client_report(1e-3) == jacc.client_report(1e-3)
    if sigma == 0.0:
        assert acc.client_epsilon("c0") == math.inf
    for a in port_accountant.DEFAULT_ORDERS:
        assert port_accountant.gaussian_rdp(sigma, a) == \
            jax_gaussian_rdp(sigma, a)
    rdp = [port_accountant.gaussian_rdp(max(sigma, 0.1), a) * steps
           for a in port_accountant.DEFAULT_ORDERS]
    assert port_accountant.rdp_to_epsilon(
        rdp, port_accountant.DEFAULT_ORDERS, 1e-5) == jax_rdp_to_epsilon(
        rdp, port_accountant.DEFAULT_ORDERS, 1e-5)


def test_rdp_to_epsilon_rejects_bad_delta():
    with pytest.raises(ValueError, match="delta"):
        port_accountant.rdp_to_epsilon([1.0], [2.0], 0.0)


# ------------------------------------------------ secure_coalesced_aggregate
def masked_round(rng, ids, masker, jmasker, samples):
    base = np_tree(rng)
    ups, jups, plain = [], [], []
    for cid, s in zip(ids, samples, strict=True):
        new = np_tree(rng)
        d = agg.UpdateDelta(s, 1, 1)
        jd = jagg.UpdateDelta(s, 1, 1)
        ups.append((masker.mask_update(params_from_numpy(base, "cpu"),
                                       params_from_numpy(new, "cpu"), cid,
                                       ids, 2, "k", s), d))
        jups.append((jmasker.mask_update(to_jax(base), to_jax(new), cid, ids,
                                         2, "k", s), jd))
        plain.append((tree_map(lambda x, y: (y - x) * float(s),
                               params_from_numpy(base, "cpu"),
                               params_from_numpy(new, "cpu")), d))
    return base, ups, jups, plain


@pytest.mark.parametrize("dropped", [False, True])
@pytest.mark.parametrize("zero_mass", [False, True])
def test_secure_aggregate_matches_jax(dropped, zero_mass, rng):
    ids = ["a", "b", "c", "d", "e"]
    samples = [0] * 5 if zero_mass else [int(s) for s in
                                         rng.integers(10, 300, 5)]
    masker, jmasker = PairwiseMasker(3, 2.0), JaxMasker(3, 2.0)
    base, ups, jups, plain = masked_round(rng, ids, masker, jmasker, samples)
    keep = 3 if dropped else 5
    corr = jcorr = None
    if dropped:
        corr = masker.reconstruct(params_from_numpy(base, "cpu"), ids[keep:],
                                  ids[:keep], 2, "k")
        jcorr = jmasker.reconstruct(to_jax(base), ids[keep:], ids[:keep], 2,
                                    "k")
    meta = agg.ModelMeta(100, 1, 4)
    res = agg.secure_coalesced_aggregate(params_from_numpy(base, "cpu"), meta,
                                         ups[:keep], correction=corr)
    jres = jagg.secure_coalesced_aggregate(
        to_jax(base), jagg.ModelMeta(100, 1, 4), jups[:keep],
        jagg.AggregationConfig(use_pallas=True), jcorr)
    assert_trees_close(res.params, jres.params)
    assert (res.n_folded, res.n_param_sets, res.n_fast_path) == \
        (jres.n_folded, jres.n_param_sets, jres.n_fast_path)
    assert (res.meta.samples_learned, res.meta.epochs_learned,
            res.meta.round) == (jres.meta.samples_learned,
                                jres.meta.epochs_learned, jres.meta.round)
    # the masks cancel: the same fold of the unmasked weighted deltas
    unmasked = agg.secure_coalesced_aggregate(
        params_from_numpy(base, "cpu"), meta, plain[:keep])
    for g, w in zip(tree_leaves(res.params), tree_leaves(unmasked.params),
                    strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    if zero_mass:
        assert res.n_param_sets == 1 and res.params["w"].numpy().tolist() \
            == base["w"].tolist()


# --------------------------------------------------------------- the store
def test_store_secure_round_with_dropout_matches_jax(rng):
    masker, jmasker = PairwiseMasker(1, 1.0), JaxMasker(1, 1.0)
    init = np_tree(rng)
    store = ModelStore(params_from_numpy(init, "cpu"), cluster_keys=["k"],
                       masker=masker)
    jstore = JaxModelStore(to_jax(init), cluster_keys=["k"], masker=jmasker)
    ids = ["a", "b", "c"]
    for r, level, key in ((0, "global", None), (1, "cluster", "k")):
        mkey = store.model_key(level, key)
        for cid in ids[:2]:          # c drops out of both rounds
            new = np_tree(rng)
            d = agg.UpdateDelta(40 + len(cid), 2, 1)
            jd = jagg.UpdateDelta(40 + len(cid), 2, 1)
            store.submit_secure(level, key, cid, r, masker.mask_update(
                store.params(level, key), params_from_numpy(new, "cpu"), cid,
                ids, r, mkey, d.samples_learned), d)
            jstore.submit_secure(level, key, cid, r, jmasker.mask_update(
                jstore.params(level, key), to_jax(new), cid, ids, r, mkey,
                jd.samples_learned), jd)
        assert store.drain_secure(level, key, r, ids) == 2
        assert jstore.drain_secure(level, key, r, ids) == 2
        assert store.drain_secure(level, key, r, ids) == 0     # round gone
        assert_trees_close(store.params(level, key),
                           jstore.params(level, key))
        m, jm = store.meta(level, key), jstore.meta(level, key)
        assert (m.samples_learned, m.epochs_learned, m.round) == \
            (jm.samples_learned, jm.epochs_learned, jm.round)
    assert store.n_secure_rounds == jstore.n_secure_rounds == 2
    assert store.n_secure_recoveries == jstore.n_secure_recoveries == 2
    stats, jstats = store.agg_stats(), jstore.agg_stats()
    assert stats == jstats
    assert stats["secure_rounds"] == 2 and stats["secure_recoveries"] == 2


def test_drain_secure_restores_the_round_on_error(rng):
    init = params_from_numpy(np_tree(rng), "cpu")
    store = ModelStore(init, masker=PairwiseMasker(0, 1.0))
    good = tree_map(torch.zeros_like, init)
    bad = {"w": torch.zeros(3), "b": {"v": torch.zeros(7)}}   # wrong shape
    store.submit_secure("global", None, "a", 0, good, agg.UpdateDelta(5))
    store.submit_secure("global", None, "b", 0, bad, agg.UpdateDelta(5))
    with pytest.raises(RuntimeError):
        store.drain_secure("global", None, 0, ["a", "b"])
    rec = store._record(store.model_key("global"))
    assert [u.client_id for u in rec.secure_pending[0]] == ["a", "b"]
    assert store.n_secure_rounds == 0 and store.params("global") is init


def test_drain_secure_missing_masker_raises(rng):
    init = params_from_numpy(np_tree(rng), "cpu")
    store = ModelStore(init)
    store.submit_secure("global", None, "a", 0, init, agg.UpdateDelta(10))
    with pytest.raises(RuntimeError, match="seed reconstruction"):
        store.drain_secure("global", None, 0, ["a", "b"])
    rec = store._record(store.model_key("global"))
    assert len(rec.secure_pending[0]) == 1      # restored for a retry
    assert "secure_rounds" not in store.agg_stats()


# ------------------------------------------------------- the sim runtime
def scalar_feds(**kw):
    kw = dict(ewc_lambda=0.05, seed=5, **kw)
    space = dict(eps=100.0, min_samples=2, metric="haversine")
    fed = FedCCL(FedCCLConfig(spaces=(ClusterSpaceConfig("loc", **space),),
                              **kw), {"w": torch.zeros(())}, scalar_train_fn,
                 device="cpu")
    jfed = JaxFedCCL(JaxFedCCLConfig(spaces=(JaxSpace("loc", **space),),
                                     **kw), {"w": jnp.zeros(())},
                     scalar_train_fn)
    assert fed.setup(specs_for(ClientSpec, 5)) == \
        jfed.setup(specs_for(JaxClientSpec, 5))
    return fed, jfed


def assert_feds_agree(fed, jfed, atol):
    assert sorted(fed.store.keys()) == sorted(jfed.store.keys())
    for level, key in [("global", None)] + [("cluster", k)
                                            for k in fed.store.keys()]:
        m, jm = fed.store.meta(level, key), jfed.store.meta(level, key)
        assert (m.samples_learned, m.epochs_learned, m.round) == \
            (jm.samples_learned, jm.epochs_learned, jm.round)
        for g, w in zip(tree_leaves(fed.store.params(level, key)),
                        jax.tree.leaves(jfed.store.params(level, key)),
                        strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=atol)


@pytest.mark.parametrize("privacy", [
    dict(dp_clip=0.5, dp_noise_multiplier=0.0),
    dict(dp_clip=0.5, dp_noise_multiplier=0.8),
    dict(secure_agg=True, dropout_prob=0.4),
    dict(secure_agg=True, dropout_prob=0.4, dp_clip=0.5,
         dp_noise_multiplier=0.8, secure_mask_scale=3.0),
    dict(dp_clip=2.0, dp_noise_multiplier=0.05, batch_aggregation=True,
         max_coalesce=4)],
    ids=["dp-m0", "dp", "secure-dropout", "secure-dropout-dp", "dp-batched"])
def test_scalar_schedule_matches_jax(privacy, with_jax_noise):
    fed, jfed = scalar_feds(**privacy)
    stats, jstats = fed.run(rounds=4), jfed.run(rounds=4)
    assert stats == jstats
    assert fed.privacy_report() == jfed.privacy_report()
    assert fed.store.agg_stats() == jfed.store.agg_stats()
    if privacy.get("secure_agg"):
        assert stats["secure_recoveries"] > 0
        assert fed.store.secure_round_offset == 4
    assert_feds_agree(fed, jfed, atol=ATOL)


def test_secure_round_ids_never_repeat_across_runs():
    fed, _ = scalar_feds(secure_agg=True)
    fed.run(rounds=2)
    assert fed.store.secure_round_offset == 2
    fed.run(rounds=1)
    assert fed.store.secure_round_offset == 3
    assert fed.store.meta("global").round == 6 * 3


def solar_feds(**privacy):
    """A 4-site solar fleet at hidden 4 in both packages, from the same
    JAX-initialised weights."""
    fleet = generate_fleet(n_sites=4, n_days=9, seed=0)
    windows = {s.site_id: split_windows(make_windows(d), train_frac=0.8)[0]
               for s, d in fleet}
    jfc = JaxForecaster(JaxSolarConfig(hidden_size=4))
    init = jax.tree.map(np.asarray, jfc.init(jax.random.key(0)))
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=4))
    spaces = dict(eps=120.0, min_samples=2, metric="haversine")
    kw = dict(ewc_lambda=0.05, seed=3, **privacy)
    fed = FedCCL(FedCCLConfig(spaces=(ClusterSpaceConfig("loc", **spaces),),
                              **kw), params_from_numpy(init, "cpu"),
                 make_train_fn(make_solar_fns(fc, lr=1e-2)[0], epochs=1,
                               batch_size=8), device="cpu")
    jfed = JaxFedCCL(JaxFedCCLConfig(spaces=(JaxSpace("loc", **spaces),),
                                     **kw), to_jax(init),
                     jax_train_fn(jax_solar_fns(jfc, lr=1e-2)[0], epochs=1,
                                  batch_size=8))
    rng = np.random.default_rng(0)
    speeds = [float(rng.uniform(0.5, 2.0)) for _ in fleet]
    assert fed.setup([ClientSpec(s.site_id, s.static_features,
                                 windows[s.site_id], speed=v)
                      for (s, _), v in zip(fleet, speeds, strict=True)]) == \
        jfed.setup([JaxClientSpec(s.site_id, s.static_features,
                                  windows[s.site_id], speed=v)
                    for (s, _), v in zip(fleet, speeds, strict=True)])
    return fed, jfed


def test_solar_secure_dropout_schedule_matches_jax():
    fed, jfed = solar_feds(secure_agg=True, dropout_prob=0.4, dp_clip=1.0,
                           dp_noise_multiplier=0.0)
    stats, jstats = fed.run(rounds=3), jfed.run(rounds=3)
    assert stats == jstats
    assert stats["secure_recoveries"] > 0
    assert fed.privacy_report() == jfed.privacy_report()
    assert_feds_agree(fed, jfed, atol=ATOL)


# --------------------------------------------------------------- end to end
def table_gap(ref, got):
    """Largest Table II / §IV.E gap in pp; NaN must sit in the same
    places."""
    gap = 0.0
    for tab in ("table2", "independent"):
        assert got[tab].keys() == ref[tab].keys()
        for col in ref[tab]:
            assert got[tab][col].keys() == ref[tab][col].keys()
            for k, v in ref[tab][col].items():
                assert math.isnan(got[tab][col][k]) == math.isnan(v), \
                    (tab, col, k)
                if not math.isnan(v):
                    gap = max(gap, abs(got[tab][col][k] - v))
    return gap


@pytest.mark.parametrize("clip,m,secure,pp", [
    (5.0, 0.0, True, TABLE_PP), (5.0, 0.3, True, NOISY_PP),
    (0.1, 0.3, False, TABLE_PP)], ids=["secure-m0", "secure", "dp"])
def test_solar_privacy_run_matches_jax_end_to_end(clip, m, secure, pp,
                                                  monkeypatch):
    """Without secure aggregation every update carries its own noise (std
    ``m * clip`` per weight, not averaged), and at clip 5 the federated
    models are chaotic: the port against itself with the noise moved by
    one ulp drifts by pp (``tools/torch_privacy_probe.py --witness``).
    Clip 0.1 keeps that run's noise small and its clip binding."""
    if m:
        monkeypatch.setattr(DPPrivatizer, "_noise", jax_noise)
    ref, got, _ = solar_parity(**SMALL, dp_clip=clip, dp_noise_multiplier=m,
                               secure_agg=secure)
    assert got["clusters"] == ref["clusters"]
    assert got["async_stats"] == ref["async_stats"]
    assert got["privacy"] == ref["privacy"]
    assert got["config"] == ref["config"]
    assert got["async_stats"].get("secure_rounds", 0) > 0 or not secure
    assert table_gap(ref, got) <= pp
