"""The port's LLM inference path against the JAX package, on the CPU.

Both packages run ``reduced_for_smoke`` of mamba2-370m and gemma-2b in
float32; the port loads the JAX-initialised parameters through the weights
bridge, and token inputs come from one seeded numpy generator.  On the CPU
the port's attention and SSD run the kernels' plain versions; the JAX side
runs once with its jnp paths (``ATTN_BACKEND`` / ``SSD_BACKEND`` "jax") and
once with its Pallas kernels in interpret mode ("pallas").  Tolerances are
the reference tests' own: logits atol 5e-5 (``tests/test_kernels.py``),
decode against forward 2e-4 (``tests/test_decode_parity.py``), greedy
tokens exactly (``tests/test_serving.py``); the eval loss within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_for_smoke as jax_reduced
from repro.data.lm_synth import lm_batch as jax_lm_batch
from repro.models import attention as jax_attention
from repro.models import ssm as jax_ssm
from repro.models.model import build_model as jax_build_model
from repro.models.params import count_params_analytic as jax_count
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.training.train_step import build_eval_step as jax_eval_step
from repro_torch.configs import ALL_ARCHS, get_config, reduced_for_smoke
from repro_torch.data.lm_synth import lm_batch
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.model import build_model
from repro_torch.models.params import count_params_analytic
from repro_torch.serving.engine import ServeEngine, build_decode_step
from repro_torch.training.train_step import build_eval_step
from repro_torch.utils.tree import params_from_numpy, params_to_numpy, tree_leaves

ARCHS = ["mamba2-370m", "gemma-2b"]
LOGITS_ATOL = 5e-5
DECODE_ATOL = 2e-4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX model, JAX params, port model, port params) at smoke size."""
    arch = request.param
    jmodel = jax_build_model(jax_reduced(jax_get_config(arch)))
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduced_for_smoke(get_config(arch)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return arch, jmodel, jparams, model, params


def tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_configs_equal_the_reference():
    for arch in ALL_ARCHS:
        ref = jax_get_config(arch)
        got = get_config(arch)
        assert repr(got) == repr(ref)
        assert repr(reduced_for_smoke(got)) == repr(jax_reduced(ref))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("include_embed", [False, True])
def test_param_count_of_the_full_config_equals_jax(arch, include_embed):
    """Schema only: no parameter of the full model is allocated."""
    cfg = get_config(arch)
    want = jax_count(jax_get_config(arch), include_embed=include_embed)
    assert count_params_analytic(cfg, include_embed=include_embed) == want
    shapes = build_model(cfg).param_shapes()
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    assert sum(t.numel() for t in tree_leaves(shapes)) == \
        count_params_analytic(cfg, include_embed=True)


def test_tree_and_init_line_up_with_jax(pair):
    arch, jmodel, jparams, model, params = pair
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves)
    for (path, j), t in zip(jleaves, leaves, strict=True):
        assert tuple(t.shape) == j.shape, path
    # the port's own init draws other numbers but keeps every shape, dtype
    # and scale, including the stacked leaves' fan-in over the layer axis
    own = model.init(torch.Generator().manual_seed(0), "cpu")
    for t, s, (path, j) in zip(tree_leaves(own),
                               tree_leaves(model.param_shapes()), jleaves,
                               strict=True):
        assert t.shape == s.shape and t.dtype == s.dtype
        if t.numel() >= 4096:
            want = float(np.std(np.asarray(j)))
            assert abs(t.std().item() - want) <= 0.05 * want, path


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_forward_matches_jax(pair, backend, monkeypatch):
    arch, jmodel, jparams, model, params = pair
    monkeypatch.setattr(jax_ssm, "SSD_BACKEND", backend)
    monkeypatch.setattr(jax_attention, "ATTN_BACKEND", backend)
    toks = tokens(model.cfg.vocab_size, (2, 40))    # 40 = 1.25 SSD chunks
    ref, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    reset_launch_counts()
    with torch.no_grad():
        out, aux = model.forward(params, tokens=toks)
    assert all(n == 0 for n in launch_counts().values())   # CPU: plain route
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGITS_ATOL)


def test_eval_step_matches_jax(pair):
    arch, jmodel, jparams, model, params = pair
    cfg = model.cfg
    batch = lm_batch(np.random.default_rng(99), 4, 32, cfg.vocab_size)
    ref = jax_eval_step(jmodel, jmodel.cfg)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = build_eval_step(model, cfg)(params, batch)
    for key in ("loss", "ce", "moe_loss"):
        assert abs(float(got[key]) - float(ref[key])) <= 1e-5, key
    assert abs(float(got["loss"]) - np.log(cfg.vocab_size)) < 2.0


def test_decode_matches_forward(pair):
    """The port's cached decode against its own kernel-route forward."""
    arch, jmodel, jparams, model, params = pair
    T = 12
    toks = torch.as_tensor(tokens(model.cfg.vocab_size, (2, T)))
    with torch.no_grad():
        full, _ = model.forward(params, tokens=toks)
        caches = model.init_caches(2, T, torch.float32, "cpu")
        errs = []
        for t in range(T):
            lg, caches = model.decode_step(params, caches, toks[:, t:t + 1], t)
            errs.append((lg[:, 0] - full[:, t]).abs().max().item())
    assert max(errs) < DECODE_ATOL, (arch, max(errs))


WINDOW_T, WINDOW_W = 16, 4     # tests/test_decode_parity.py's sliding case


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_windowed_forward_matches_jax(pair, backend, monkeypatch):
    """``window_override`` (the reference's long-context knob): the
    kernel-route forward under a sliding window against JAX's."""
    arch, jmodel, jparams, model, params = pair
    monkeypatch.setattr(jax_ssm, "SSD_BACKEND", backend)
    monkeypatch.setattr(jax_attention, "ATTN_BACKEND", backend)
    toks = tokens(model.cfg.vocab_size, (2, WINDOW_T))
    ref, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                            window_override=WINDOW_W)
    with torch.no_grad():
        out, _ = model.forward(params, tokens=toks, window_override=WINDOW_W)
        plain, _ = model.forward(params, tokens=toks)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGITS_ATOL)
    if arch == "gemma-2b":          # the window really cuts the context
        assert (out - plain).abs().max().item() > 1e-3


@pytest.mark.parametrize("per_sequence_pos", [False, True])
def test_windowed_decode_matches_forward_and_jax(pair, per_sequence_pos):
    """Decode under ``window_override`` over a longer cache (the gather of
    the last W slots) against the windowed forward and JAX's decode, with
    ``pos`` a scalar or one offset per sequence."""
    arch, jmodel, jparams, model, params = pair
    toks = tokens(model.cfg.vocab_size, (2, WINDOW_T))
    step = build_decode_step(model, window_override=WINDOW_W)
    jstep = jax.jit(lambda p, c, x, t: jmodel.decode_step(
        p, c, x, t, window_override=WINDOW_W))
    jcaches = jmodel.init_caches(2, WINDOW_T, jnp.float32)
    with torch.no_grad():
        full, _ = model.forward(params, tokens=toks, window_override=WINDOW_W)
        caches = model.init_caches(2, WINDOW_T, torch.float32, "cpu")
        errs, jerrs = [], []
        for t in range(WINDOW_T):
            pos = torch.full((2,), t) if per_sequence_pos else t
            lg, caches = step(params, caches, torch.as_tensor(toks[:, t:t + 1]),
                              pos)
            jlg, jcaches = jstep(jparams, jcaches,
                                 jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            errs.append((lg[:, 0] - full[:, t]).abs().max().item())
            jerrs.append(np.abs(lg.numpy() - np.asarray(jlg)).max())
    assert max(errs) < DECODE_ATOL, (arch, max(errs))
    assert max(jerrs) < LOGITS_ATOL, (arch, max(jerrs))


def test_greedy_generation_matches_jax(pair):
    arch, jmodel, jparams, model, params = pair
    prompts = tokens(model.cfg.vocab_size, (3, 6), seed=2)
    ref = JaxServeEngine(jmodel, jparams, max_len=32).generate(prompts, 5)
    reset_launch_counts()
    got = ServeEngine(model, params, max_len=32).generate(prompts, 5)
    assert got.dtype == np.int32 and got.shape == (3, 5)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert all(n == 0 for n in launch_counts().values())


def test_ragged_generation_matches_jax_and_independent_decoding(pair):
    arch, jmodel, jparams, model, params = pair
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
            for n in (5, 11, 7)]
    eng = ServeEngine(model, params, max_len=32)
    got = eng.generate_ragged(reqs, 4)
    ref = JaxServeEngine(jmodel, jparams, max_len=32).generate_ragged(
        [jnp.asarray(r) for r in reqs], 4)
    np.testing.assert_array_equal(got, np.asarray(ref))
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(got[i], eng.generate(r[None], 4)[0])


def test_temperature_sampling_is_seeded():
    cfg = reduced_for_smoke(get_config("gemma-2b"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(model, params, max_len=16, temperature=1.0)
    prompts = tokens(cfg.vocab_size, (2, 3))
    a, b = eng.generate(prompts, 4, seed=5), eng.generate(prompts, 4, seed=5)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()


@pytest.mark.parametrize("batch,seq,structure", [(4, 32, 0.5), (3, 17, 1.0),
                                                 (2, 2048, 0.5)])
def test_lm_batch_is_bit_equal(batch, seq, structure):
    vocab = 50_280
    a = lm_batch(np.random.default_rng(7), batch, seq, vocab, structure)
    b = jax_lm_batch(np.random.default_rng(7), batch, seq, vocab, structure)
    for key in ("tokens", "labels"):
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])


def test_bf16_params_round_trip_bit_exactly():
    """The full configs' dtype: a bfloat16 JAX tree through the bridge and
    back keeps every bit, and the f32 leaves stay f32."""
    cfg = jax_reduced(jax_get_config("mamba2-370m")).replace(dtype="bfloat16")
    jparams = jax_build_model(cfg).init(jax.random.key(4))
    np_params = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(np_params, "cpu")
    dtypes = {str(t.dtype) for t in tree_leaves(params)}
    assert dtypes == {"torch.bfloat16", "torch.float32"}
    back = params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params),
                    strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    emb = params["embed"].to(torch.float32).numpy()
    np.testing.assert_array_equal(emb, np.asarray(jparams["embed"], np.float32))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_builds(arch):
    """Every config of the repo builds at full size, schema only (no
    parameter allocated): the reference's stack layout, and its parameter
    counts, all and active."""
    cfg = get_config(arch)
    model = build_model(cfg)
    assert model.layout == jax_build_model(jax_get_config(arch)).layout
    shapes = model.param_shapes()
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    for kw in ({"include_embed": True}, {"active_only": True}):
        assert count_params_analytic(cfg, **kw) == jax_count(
            jax_get_config(arch), **kw), kw
    assert sum(t.numel() for t in tree_leaves(shapes)) == \
        count_params_analytic(cfg, include_embed=True)


def test_llm_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(reduced_for_smoke(get_config("gemma-2b")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_caches(1, 8)
