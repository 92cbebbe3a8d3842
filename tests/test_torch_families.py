"""The port's MoE, MLA (with MTP), RG-LRU hybrid, audio and VLM families
against the JAX package, on the CPU.

Both packages run ``reduced_for_smoke`` of deepseek-moe-16b,
deepseek-v3-671b, recurrentgemma-9b, hubert-xlarge and internvl2-76b in
float32; the port loads the JAX-initialised parameters through the weights
bridge (``params_from_numpy``), and every input comes from a seeded numpy
generator.  On the CPU the port's attention runs the ``local_attn``
kernel's plain version (MLA's on K/V expanded from the latent); the JAX
side runs its jnp paths.

Tolerances, stated once:
- forward logits, decode logits against JAX's: atol LOGITS_ATOL 5e-5
  (``tests/test_kernels.py``'s f32 bound);
- loss and each metric (``ce``, ``moe_loss``, ``mtp_ce``): LOSS_TOL 1e-5;
- gradients: every leaf within GRAD_RTOL 1e-5 x max(1, max|g_jax|) (f32
  sums in another order);
- decode against the forward: DECODE_ATOL 2e-4, the reference's own
  (``tests/test_decode_parity.py``); MLA absorb against naive: 1e-4, the
  reference's own;
- the MoE router's selected experts and keep mask: equal;
- the RG-LRU scan against a step-by-step recurrence: 1e-5;
- greedy tokens, ragged against independent decoding: equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_for_smoke as jax_reduced
from repro.models import attention as jax_attention
from repro.models import moe as jax_moe
from repro.models import rglru as jax_rglru
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.sharding.logical import init_from_schema as jax_init_from_schema
from repro.training.losses import loss_for_batch as jax_loss_for_batch
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.data.lm_synth import audio_batch, lm_batch, vlm_batch
from repro_torch.models import attention, moe, rglru
from repro_torch.models.blocks import attention_blocks
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ServeEngine
from repro_torch.sharding.logical import init_from_schema
from repro_torch.training.losses import loss_for_batch
from repro_torch.utils.tree import (
    params_from_numpy,
    params_to_numpy,
    tree_leaves,
    tree_map,
)

FAMILIES = ["deepseek-moe-16b", "deepseek-v3-671b", "recurrentgemma-9b",
            "hubert-xlarge", "internvl2-76b"]
# tests/test_decode_parity.py's DECODE_ARCHS
DECODE_ARCHS = ["deepseek-7b", "gemma-2b", "glm4-9b", "granite-8b",
                "deepseek-moe-16b", "deepseek-v3-671b", "mamba2-370m",
                "recurrentgemma-9b", "internvl2-76b"]
LOGITS_ATOL = 5e-5
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-5
DECODE_ATOL = 2e-4
ABSORB_ATOL = 1e-4
B, S, N_PATCH = 2, 12, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_pair(arch, edit=lambda cfg: cfg, seed=0):
    """(JAX model, JAX params, port model, port params) of ``arch`` at
    smoke size, ``edit`` applied to both packages' configs.  One numpy tree
    of weights (drawn by the port's initializer, which keeps the
    reference's shapes, dtypes and scales) goes to both packages: to JAX
    as arrays, to the port through ``params_from_numpy``; its structure is
    held to what JAX's own ``init`` would build."""
    jcfg = edit(jax_reduced(jax_get_config(arch)))
    cfg = edit(reduced_for_smoke(get_config(arch)))
    assert repr(cfg) == repr(jcfg)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    weights = params_to_numpy(model.init(torch.Generator().manual_seed(seed),
                                         "cpu"))
    want = jax.eval_shape(jmodel.init, jax.random.key(seed))
    got = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       weights)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert jax.tree.leaves(got) == jax.tree.leaves(want)
    return (jmodel, jax.tree.map(jnp.asarray, weights), model,
            params_from_numpy(weights, "cpu"))


def five_layers(cfg):
    """recurrentgemma-9b at 5 layers: one scanned (rec, rec, local_attn)
    group and an unrolled (rec, rec) remainder, as the full config's 38
    layers are laid out; the other families as ``reduced_for_smoke``."""
    return cfg.replace(n_layers=5) if cfg.rglru is not None else cfg


@functools.lru_cache(maxsize=None)
def cached_pair(arch):
    """``load_pair(arch, five_layers)``, made once for the module."""
    return load_pair(arch, five_layers)


@functools.lru_cache(maxsize=None)
def jax_forward(arch):
    """JAX's forward of ``cached_pair(arch)``, compiled once."""
    jmodel = cached_pair(arch)[0]
    return jax.jit(lambda p, kw: jmodel.forward(p, **kw))


@pytest.fixture(params=FAMILIES)
def pair(request):
    return (request.param, *cached_pair(request.param))


def family_batch(cfg, seed=1) -> dict:
    """A numpy batch of the family's own kind (tokens, frames, patches)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return audio_batch(rng, B, S, cfg.frontend.embed_dim, cfg.vocab_size)
    if cfg.family == "vlm":
        return vlm_batch(rng, B, N_PATCH + S, N_PATCH, cfg.frontend.embed_dim,
                         cfg.vocab_size)
    return lm_batch(rng, B, S, cfg.vocab_size)


def forward_kwargs(cfg, batch) -> dict:
    if cfg.family == "audio":
        return {"embeds": batch["embeds"], "mask": batch["mask"]}
    if cfg.family == "vlm":
        return {"tokens": batch["tokens"], "embeds": batch["patches"]}
    return {"tokens": batch["tokens"]}


def jax_tree(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ------------------------------------------------------------ the families
def test_tree_lines_up_with_jax(pair):
    """Leaf for leaf, the unrolled segments' per-block params included: the
    port's tree against JAX's own ``init`` (shapes, dtypes, JAX's order)."""
    arch, jmodel, jparams, model, params = pair
    jleaves = jax.tree_util.tree_leaves_with_path(
        jax.eval_shape(jmodel.init, jax.random.key(0)))
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves)
    for (path, j), t, s in zip(jleaves, leaves,
                               tree_leaves(model.param_shapes()), strict=True):
        assert tuple(t.shape) == j.shape == tuple(s.shape), path
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, path


def test_forward_matches_jax(pair):
    arch, jmodel, jparams, model, params = pair
    cfg = model.cfg
    batch = family_batch(cfg)
    kw = forward_kwargs(cfg, batch)
    ref, jaux = jax_forward(arch)(jparams, jax_tree(kw))
    with torch.no_grad():
        out, aux = model.forward(params, **kw)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGITS_ATOL)
    assert abs(float(aux["moe_loss"]) - float(jaux["moe_loss"])) <= LOSS_TOL
    assert (float(aux["moe_loss"]) > 0) == cfg.is_moe


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch):
    """(loss, metrics, gradients) of JAX's ``loss_for_batch`` on
    ``family_batch(seed=5)``, compiled once."""
    jmodel, jparams, model, _ = cached_pair(arch)
    jb = jax_tree(family_batch(model.cfg, seed=5))
    (loss, met), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_for_batch(jmodel, jmodel.cfg, p, jb),
        has_aux=True))(jparams)
    return loss, met, grads


def test_loss_and_metrics_match_jax(pair):
    arch, jmodel, jparams, model, params = pair
    cfg = model.cfg
    jloss, jmet, _ = jax_loss_and_grads(arch)
    with torch.no_grad():
        loss, met = loss_for_batch(model, cfg, params,
                                   family_batch(cfg, seed=5))
    want = {"ce"} | ({"moe_loss"} if cfg.family not in ("audio", "vlm")
                     else set()) | ({"mtp_ce"} if cfg.mtp_depth else set())
    assert set(met) == set(jmet) == want
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    for k in met:
        assert abs(float(met[k]) - float(jmet[k])) <= LOSS_TOL, k


def test_gradients_match_jax(pair):
    arch, jmodel, jparams, model, params = pair
    jloss, _, jgrads = jax_loss_and_grads(arch)
    live = tree_map(lambda x: x.detach().requires_grad_(), params)
    loss, _ = loss_for_batch(model, model.cfg, live,
                             family_batch(model.cfg, seed=5))
    # DeepSeek-V3's router_bias only selects experts: JAX gives it zeros
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                materialize_grads=True)
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL
    for g, (path, w) in zip(grads, jax.tree_util.tree_leaves_with_path(jgrads),
                            strict=True):
        w = np.asarray(w)
        lim = GRAD_RTOL * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g.numpy() - w).max()) <= lim, path


def test_every_attention_block_reaches_the_kernel(pair, monkeypatch):
    """One call of the kernel's wrapper a walked attention block (and one
    for the MTP block), the count the card's launch check expects."""
    arch, jmodel, jparams, model, params = pair
    cfg = model.cfg
    calls = []
    real = attention.local_flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["causal"],
                      kw["window"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "local_flash_attention", spy)
    with torch.no_grad():
        loss_for_batch(model, cfg, params, family_batch(cfg))
    assert len(calls) == attention_blocks(cfg) + cfg.mtp_depth
    assert all(causal == (not cfg.encoder_only) for *_, causal, _ in calls)
    if cfg.mla is not None:            # q and k at the qk head dim
        assert {c[0][-1] for c in calls} == {cfg.mla.qk_head_dim}
    if cfg.rglru is not None:          # 5 layers: one local_attn block
        assert [c[3] for c in calls] == [cfg.rglru.attn_window]


# ----------------------------------------- tests/test_decode_parity.py:20
def decode_errors(model, params, toks, full, jfull, **kw):
    b, T = toks.shape
    caches = model.init_caches(b, T, torch.float32, "cpu")
    errs, jerrs = [], []
    with torch.no_grad():
        for t in range(T):
            lg, caches = model.decode_step(
                params, caches, torch.as_tensor(toks[:, t:t + 1]), t, **kw)
            errs.append((lg[:, 0] - full[:, t]).abs().max().item())
            if jfull is not None:
                jerrs.append(float(np.abs(lg[:, 0].numpy()
                                          - np.asarray(jfull[:, t])).max()))
    return max(errs), max(jerrs, default=0.0)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward(arch):
    """The port's cached decode against its own kernel-route forward
    (2e-4); for the families of this file also against JAX's forward on
    the same weights (``tests/test_torch_llm.py`` holds gemma-2b's and
    mamba2-370m's decode to JAX's)."""
    T = S
    if arch in FAMILIES:
        jmodel, jparams, model, params = cached_pair(arch)
        toks = tokens(model.cfg.vocab_size, (2, T))
        jfull, _ = jax_forward(arch)(jparams, {"tokens": jnp.asarray(toks)})
    else:
        model = build_model(reduced_for_smoke(get_config(arch)))
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        toks = tokens(model.cfg.vocab_size, (2, T))
        jfull = None
    with torch.no_grad():
        full, _ = model.forward(params, tokens=toks)
    err, jerr = decode_errors(model, params, toks, full, jfull)
    assert err < DECODE_ATOL, (arch, err)
    assert jerr < DECODE_ATOL, (arch, jerr)


# ----------------------------------------- tests/test_decode_parity.py:36
def test_mla_absorb_equals_naive():
    """The reference's absorbed and naive forwards agree within 1e-4, and
    the port's kernel forward (absorption has no say there) is held to
    each; on the decode path, where absorption changes the arithmetic, the
    port's absorbed and naive steps each match the forward and each
    other."""
    jmodel, jparams, model, params = cached_pair("deepseek-v3-671b")
    toks = tokens(model.cfg.vocab_size, (2, 16))
    with torch.no_grad():
        la, _ = model.forward(params, tokens=toks)
    jla, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks), mla_absorb=True)
    jln, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                            mla_absorb=False)
    assert float(jnp.abs(jla - jln).max()) < ABSORB_ATOL
    for ref in (jla, jln):
        assert float(np.abs(la.numpy() - np.asarray(ref)).max()) < ABSORB_ATOL
    errs = {}
    for absorb in (True, False):
        errs[absorb] = decode_errors(model, params, toks, la, jla,
                                     mla_absorb=absorb)
        assert max(errs[absorb]) < DECODE_ATOL, (absorb, errs[absorb])
    caches = {a: model.init_caches(2, 16, torch.float32, "cpu")
              for a in (True, False)}
    with torch.no_grad():
        for t in range(16):
            out = {}
            for a in (True, False):
                out[a], caches[a] = model.decode_step(
                    params, caches[a], torch.as_tensor(toks[:, t:t + 1]), t,
                    mla_absorb=a)
            assert float((out[True] - out[False]).abs().max()) < ABSORB_ATOL


def test_mla_latent_cache_holds_only_the_latent():
    cfg = reduced_for_smoke(get_config("deepseek-v3-671b"))
    caches = build_model(cfg).init_caches(2, 20, torch.float32, "cpu")
    shapes = {tuple(x.shape) for x in tree_leaves(caches)}
    m = cfg.mla
    assert shapes == {(2, 20, m.kv_lora_rank), (2, 20, m.qk_rope_head_dim),
                      (1, 2, 20, m.kv_lora_rank),
                      (1, 2, 20, m.qk_rope_head_dim)}


# ----------------------------------------- tests/test_decode_parity.py:46
def test_sliding_window_decode_matches_windowed_forward():
    """Port only: ``tests/test_torch_llm.py`` holds the windowed decode to
    JAX's."""
    model = build_model(reduced_for_smoke(get_config("deepseek-7b")))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    T, W = 16, 4
    toks = tokens(model.cfg.vocab_size, (1, T))
    with torch.no_grad():
        full, _ = model.forward(params, tokens=toks, window_override=W)
    err, _ = decode_errors(model, params, toks, full, None,
                           window_override=W)
    assert err < DECODE_ATOL, err


# ------------------------------------- tests/test_decode_parity.py:64,75
def hybrid3(window=None):
    """The 5-layer hybrid pair cut to 3 layers, one whole (rec, rec,
    local_attn) group (its first segment's weights), the local window set
    to ``window`` where given."""
    jmodel, jparams, model, params = cached_pair("recurrentgemma-9b")

    def edit(cfg):
        cfg = cfg.replace(n_layers=3)
        if window:
            cfg = cfg.replace(rglru=dataclasses.replace(cfg.rglru,
                                                        attn_window=window))
        return cfg

    def cut(tree):
        return dict(tree, segments={"seg0": tree["segments"]["seg0"]})

    return (jax_build_model(edit(jmodel.cfg)), cut(jparams),
            build_model(edit(model.cfg)), cut(params))


def test_rolling_local_cache_is_window_sized():
    cfg = reduced_for_smoke(get_config("recurrentgemma-9b")).replace(
        n_layers=3)
    caches = build_model(cfg).init_caches(2, 512, torch.float32, "cpu")
    kv = caches["seg0"]["b2"]
    assert set(kv) == {"k", "v"}
    assert kv["k"].shape == (1, 2, cfg.rglru.attn_window, 1, 64)
    assert {tuple(x.shape) for x in caches["seg0"]["b0"].values()} == {
        (1, 2, cfg.rglru.conv_width - 1, 256), (1, 2, 256)}


@pytest.mark.parametrize("window", [None, 4])
def test_hybrid_full_pattern_decode_parity(window):
    """(rec, rec, local_attn) with its rolling cache: decode against the
    forward and against JAX's decode, with pos a scalar and a (b,) vector;
    at window 4 the rolling cache wraps twice within T 12."""
    jmodel, jparams, model, params = hybrid3(window)
    T = 12
    toks = tokens(model.cfg.vocab_size, (2, T))
    jstep = jax.jit(jmodel.decode_step)
    jcaches = jmodel.init_caches(2, T, jnp.float32)
    errs, jerrs = [], []
    with torch.no_grad():
        full, _ = model.forward(params, tokens=toks)
        caches = [model.init_caches(2, T, torch.float32, "cpu")
                  for _ in range(2)]
        assert caches[0]["seg0"]["b2"]["k"].shape[2] == min(
            T, model.cfg.rglru.attn_window)
        for t in range(T):
            jlg, jcaches = jstep(jparams, jcaches,
                                 jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            for i, pos in enumerate((t, torch.full((2,), t))):
                lg, caches[i] = model.decode_step(
                    params, caches[i], torch.as_tensor(toks[:, t:t + 1]), pos)
                errs.append((lg[:, 0] - full[:, t]).abs().max().item())
                jerrs.append(float(np.abs(lg.numpy() - np.asarray(jlg)).max()))
    assert max(errs) < DECODE_ATOL, max(errs)
    assert max(jerrs) < LOGITS_ATOL, max(jerrs)
    if window:               # the window really cuts the context
        with torch.no_grad():
            wide, _ = build_model(model.cfg.replace(rglru=dataclasses.replace(
                model.cfg.rglru, attn_window=64))).forward(params, tokens=toks)
        assert (wide - full).abs().max().item() > 1e-3


# ---------------------------------------------- tests/test_serving.py:47
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b",
                                  "recurrentgemma-9b", "internvl2-76b"])
def test_ragged_equals_independent_and_jax(arch):
    """Ragged equals independent decoding, greedy, token for token; for
    deepseek-v3-671b (the reference test's arch) also JAX's tokens."""
    jmodel, jparams, model, params = cached_pair(arch)
    eng = ServeEngine(model, params, max_len=48)
    rng = np.random.default_rng(2)
    reqs = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
            for n in (4, 7)]
    ragged = eng.generate_ragged(reqs, 4)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(ragged[i], eng.generate(r[None], 4)[0])
    if arch != "deepseek-v3-671b":
        return
    jeng = JaxServeEngine(jmodel, jparams, max_len=48)
    np.testing.assert_array_equal(
        ragged, np.asarray(jeng.generate_ragged([jnp.asarray(r)
                                                 for r in reqs], 4)))


def test_hybrid_ragged_with_a_wrapping_window():
    """The rolling cache under continuous batching: at window 4 each
    request's cache wraps during its own prefill, then the batch decodes at
    per-request offsets; equal to independent decoding and to JAX's."""
    jmodel, jparams, model, params = hybrid3(4)
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
            for n in (3, 9)]
    eng = ServeEngine(model, params, max_len=32)
    ragged = eng.generate_ragged(reqs, 5)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(ragged[i], eng.generate(r[None], 5)[0])
    np.testing.assert_array_equal(ragged, np.asarray(
        JaxServeEngine(jmodel, jparams, max_len=32).generate_ragged(
            [jnp.asarray(r) for r in reqs], 5)))


# ------------------------------------------------------------------- MoE
class recording_top_k:
    """Records the experts ``jax.lax.top_k`` selects inside the reference's
    ``moe_forward`` (compiled: a host callback hands over the values)."""

    def __init__(self, monkeypatch):
        self.seen = []
        real = jax.lax.top_k

        def top_k(x, k):
            out = real(x, k)
            jax.debug.callback(lambda e: self.seen.append(np.asarray(e)),
                               out[1])
            return out

        monkeypatch.setattr(jax.lax, "top_k", top_k)


def reference_keep(top_e, n_experts, capacity):
    """The reference's keep mask from its selected experts: each (token, k)
    ranked inside its expert by a stable sort of the flat ids."""
    flat = top_e.reshape(-1)
    rank = np.empty_like(flat)
    for e in range(n_experts):
        where = np.flatnonzero(flat == e)
        rank[where] = np.arange(where.size)
    return (rank < capacity).reshape(top_e.shape)


@pytest.mark.parametrize("arch,capacity_factor", [
    ("deepseek-moe-16b", None), ("deepseek-v3-671b", None),
    ("deepseek-moe-16b", 0.5), ("deepseek-v3-671b", 0.3)])
def test_moe_selection_keep_and_aux_match_jax(arch, capacity_factor,
                                              monkeypatch):
    """The selected experts, the keep mask, the aux loss and the output of
    ``moe_forward`` against the reference's, as configured (dropless at
    this scale) and with a capacity that drops (dropped entries land in
    the next expert's slot 0, as the reference's scatter has them)."""
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced_for_smoke(get_config(arch))
    if capacity_factor:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    jp = jax_init_from_schema(jax_moe.moe_schema(jcfg), jax.random.key(0))
    if jcfg.moe.score_func == "sigmoid":      # a bias that moves selections
        jp["router_bias"] = 0.02 * jax.random.normal(
            jax.random.key(3), jp["router_bias"].shape)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    rec = recording_top_k(monkeypatch)
    jy, jaux = jax.jit(lambda p, x: jax_moe.moe_forward(jcfg, p, x))(
        jp, jnp.asarray(x))
    jax.effects_barrier()
    (jtop_e,) = rec.seen
    y, aux = moe.moe_forward(cfg, p, torch.as_tensor(x))
    _, top_e, _ = moe.route(cfg, p, torch.as_tensor(x).reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(top_e.numpy(), jtop_e)
    C = moe._capacity(32, cfg.moe.top_k, cfg.moe.n_routed_experts,
                      cfg.moe.capacity_factor)
    keep, _, _ = moe.dispatch(top_e.reshape(-1), cfg.moe.n_routed_experts, C)
    want_keep = reference_keep(jtop_e, cfg.moe.n_routed_experts, C)
    np.testing.assert_array_equal(keep.numpy().reshape(jtop_e.shape),
                                  want_keep)
    assert want_keep.all() == (capacity_factor is None)
    assert abs(float(aux) - float(jaux)) <= LOSS_TOL
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=LOGITS_ATOL)


def test_moe_reference_internals(rng):
    """``tests/test_models_internals.py:99,112`` on the port: output shape,
    a positive aux loss, no NaN."""
    for arch, shape in (("deepseek-moe-16b", (2, 8)),
                        ("deepseek-v3-671b", (1, 16))):
        cfg = reduced_for_smoke(get_config(arch))
        p = init_from_schema(moe.moe_schema(cfg),
                                 torch.Generator().manual_seed(0), "cpu")
        x = torch.as_tensor(rng.standard_normal(
            (*shape, cfg.d_model)).astype(np.float32))
        y, aux = moe.moe_forward(cfg, p, x)
        assert y.shape == x.shape and float(aux) > 0.0
        assert not bool(torch.isnan(y).any())


# ---------------------------------------------------------------- RG-LRU
def test_rglru_scan_is_the_recurrence_and_matches_jax():
    cfg = reduced_for_smoke(get_config("recurrentgemma-9b"))
    jcfg = jax_reduced(jax_get_config("recurrentgemma-9b"))
    jp = jax_init_from_schema(jax_rglru.rglru_schema(jcfg), jax.random.key(1))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jforward = jax.jit(lambda p, x: jax_rglru.rglru_forward(jcfg, p, x)[0])
    for L in (1, 37):
        x = np.random.default_rng(L).standard_normal(
            (2, L, cfg.d_model)).astype(np.float32)
        y, _ = rglru.rglru_forward(cfg, p, torch.as_tensor(x))
        jy = jforward(jp, jnp.asarray(x))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                   atol=LOGITS_ATOL)
        state = rglru.init_rglru_state(cfg, 2, device="cpu")
        steps = []
        for t in range(L):
            yt, state = rglru.rglru_forward(
                cfg, p, torch.as_tensor(x[:, t:t + 1]), state=state)
            steps.append(yt)
        np.testing.assert_allclose(y.numpy(), torch.cat(steps, 1).numpy(),
                                   atol=1e-5)
    gen = torch.Generator().manual_seed(2)
    a = torch.rand(3, 100, 4, generator=gen)
    b = torch.randn(3, 100, 4, generator=gen)
    h, want = torch.zeros(3, 4), []
    for t in range(100):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b), torch.stack(want, 1),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------ softcap, flash_attention
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_flash_matches_sdpa_and_jax(causal, window):
    """``tests/test_models_internals.py:23`` on the port, and the port's
    flash against the reference's on the same inputs (softcap too)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, 80, 2, 3, 16), (2, 80, 2, 16), (2, 80, 2, 16)))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    fa = attention.flash_attention(tq, tk, tv, causal=causal, window=window,
                                   scale=0.25, blk_q=16, blk_k=32)
    bias = attention._mask_bias(torch.arange(80), torch.arange(80),
                                causal=causal, window=window)
    ref = attention._sdpa(tq, tk, tv, bias, 0.25, 0.0, None)
    np.testing.assert_allclose(fa.numpy(), ref.numpy(), atol=2e-5)
    for cap in (0.0, 2.0):
        got = attention.flash_attention(tq, tk, tv, causal=causal,
                                        window=window, scale=0.25, cap=cap,
                                        blk_q=16, blk_k=32)
        want = jax_attention.flash_attention(
            *map(jnp.asarray, (q, k, v)), causal=causal, window=window,
            scale=0.25, cap=cap, blk_q=16, blk_k=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("threshold", [4096, 8])
def test_softcapped_attention_matches_jax(threshold, monkeypatch):
    """Reduced gemma-2b with a logit softcap of 50: plain torch, never the
    kernel, on ``_sdpa`` below FLASH_THRESHOLD and on ``flash_attention``
    above it (the threshold lowered in both packages); decode too."""
    def capped(cfg):
        return cfg.replace(attn_logit_softcap=50.0)

    jmodel, jparams, model, params = load_pair("gemma-2b", capped)
    toks = tokens(model.cfg.vocab_size, (2, 12))
    with torch.no_grad():
        plain, _ = build_model(model.cfg.replace(
            attn_logit_softcap=0.0)).forward(params, tokens=toks)
    monkeypatch.setattr(jax_attention, "FLASH_THRESHOLD", threshold)
    monkeypatch.setattr(attention, "FLASH_THRESHOLD", threshold)
    jfull, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks))

    def refuse(*a, **kw):
        raise AssertionError("softcapped attention reached the kernel")

    monkeypatch.setattr(attention, "local_flash_attention", refuse)
    with torch.no_grad():
        full, _ = model.forward(params, tokens=toks)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull),
                               atol=LOGITS_ATOL)
    assert (plain - full).abs().max().item() > 1e-6   # the cap bites
    err, jerr = decode_errors(model, params, toks, full, jfull)
    assert err < DECODE_ATOL and jerr < DECODE_ATOL, (err, jerr)
