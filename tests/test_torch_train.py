"""The port's language-model training against the JAX package, on the CPU.

Both packages run ``reduced_for_smoke`` of every LLM config (dense, SSM,
MoE, MLA with MTP, the RG-LRU hybrid, audio and VLM), in float32, from the
same JAX-initialised parameters (the weights bridge) and one numpy batch
of the family's kind.  On the CPU the port's attention and
SSD run the kernels' plain versions, forward and backward (the backward's
plain versions are the explicit VJPs in ``kernels/*/ref.py``); the JAX side
differentiates its jnp paths, as its own training does.  Tolerances: loss,
``ce`` and ``grad_norm`` within 1e-5; parameters after a step within
1e-5 x max(1, max|p|) (f32 sums in another order); 2 microbatches equal to
1 within the same limits; the federated round's stats exactly (numpy
draws and the schedule) and its global model within 1e-5 x max(1, max|p|).

The kernels' plain VJPs are held to ``torch.autograd`` of the plain
forwards in f64 (``gradcheck``), with a window, GQA and per-group B and C.
"""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_for_smoke as jax_reduced
from repro.core.continual import EWCState as JaxEWCState
from repro.core.fedccl import ClusterSpaceConfig as JaxSpace
from repro.core.fedccl import FedCCL as JaxFedCCL
from repro.core.fedccl import FedCCLConfig as JaxFedCCLConfig
from repro.core.protocol import ClientSpec as JaxClientSpec
from repro.data.lm_synth import lm_batch as jax_lm_batch
from repro.models.model import build_model as jax_build_model
from repro.optim import optimizers as jopt
from repro.training.train_step import TrainState as JaxTrainState
from repro.training.train_step import build_train_step as jax_train_step
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.core.continual import EWCState
from repro_torch.core.fedccl import ClusterSpaceConfig, FedCCL, FedCCLConfig
from repro_torch.core.protocol import ClientSpec
from repro_torch.data.lm_synth import audio_batch, lm_batch, vlm_batch
from repro_torch.kernels.local_attn.ops import LocalAttnFn
from repro_torch.kernels.local_attn.ref import (
    local_attention_bwd_ref,
    local_attention_ref,
)
from repro_torch.kernels.ssd_chunk.ops import SsdIntraChunkFn
from repro_torch.kernels.ssd_chunk.ref import (
    ssd_intra_chunk_bwd_ref,
    ssd_intra_chunk_ref,
)
from repro_torch.models.model import build_model
from repro_torch.optim import adamw, sgd
from repro_torch.training.train_step import (
    TrainState,
    build_train_step,
    init_train_state,
)
from repro_torch.utils.tree import (
    params_from_numpy,
    params_to_numpy,
    tree_leaves,
    tree_map,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

ARCHS = ["deepseek-7b", "gemma-2b", "glm4-9b", "granite-8b", "mamba2-370m",
         "deepseek-moe-16b", "deepseek-v3-671b", "recurrentgemma-9b",
         "hubert-xlarge", "internvl2-76b"]
B, S, N_PATCH = 2, 24, 8
TOL = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX model, cfg, params; port model, cfg, params) at smoke size, the
    port's params loaded from the JAX ones."""
    arch = request.param
    jcfg = jax_reduced(jax_get_config(arch))
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    cfg = reduced_for_smoke(get_config(arch))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jcfg, jparams, build_model(cfg), cfg, params


def np_batch(cfg, seed=1):
    """A batch of the family's kind: tokens, frames with a mask (both rows
    masking as many frames, so the mean of two one-row microbatches' masked
    means is the batch's), or patches and tokens."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        batch = audio_batch(rng, B, S, cfg.frontend.embed_dim, cfg.vocab_size,
                            mask_prob=0.3)
        batch["mask"][1] = np.roll(batch["mask"][0], 5)
        return batch
    if cfg.family == "vlm":
        return vlm_batch(rng, B, N_PATCH + S, N_PATCH, cfg.frontend.embed_dim,
                         cfg.vocab_size)
    return lm_batch(rng, B, S, cfg.vocab_size)


def forward_inputs(cfg, batch) -> dict:
    if cfg.family == "audio":
        return {"embeds": batch["embeds"], "mask": batch["mask"]}
    if cfg.family == "vlm":
        return {"tokens": batch["tokens"], "embeds": batch["patches"]}
    return {"tokens": batch["tokens"]}


def metric_keys(cfg) -> tuple:
    """The metrics a step of ``cfg`` reports beside the loss."""
    keys = ("loss", "ce", "grad_norm")
    if cfg.family in ("audio", "vlm"):
        return keys
    return keys + ("moe_loss",) + (("mtp_ce",) if cfg.mtp_depth else ())


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_params_close(got, want):
    for g, w in zip(tree_leaves(params_to_numpy(got)), jax.tree.leaves(want),
                    strict=True):
        w = np.asarray(w, np.float64)
        lim = TOL * max(1.0, float(np.abs(w).max()))
        err = float(np.abs(np.asarray(g, np.float64) - w).max())
        assert err <= lim, (err, lim)


def assert_metrics_close(got, want, keys=("loss", "ce", "grad_norm")):
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


def jax_step_of(jmodel, jcfg, jparams, jopt_, batch, **kw):
    step = jax.jit(jax_train_step(jmodel, jcfg, jopt_, **kw))
    return step(JaxTrainState(jparams, jopt_.init(jparams)),
                jax_batch(batch))


def port_step_of(model, cfg, params, opt, batch, **kw):
    step = build_train_step(model, cfg, opt, **kw)
    return step(TrainState(params, opt.init(params)), batch)


# ---------------------------------------------------------------- one step
def test_sgd_step_matches_jax(pair):
    jmodel, jcfg, jparams, model, cfg, params = pair
    batch = np_batch(cfg)
    jstate, jmet = jax_step_of(jmodel, jcfg, jparams, jopt.sgd(0.05), batch)
    state, met = port_step_of(model, cfg, params, sgd(0.05), batch)
    assert set(met) == set(jmet) == set(metric_keys(cfg))
    assert_metrics_close(met, jmet, metric_keys(cfg))
    if "moe_loss" in met:
        assert (float(met["moe_loss"]) > 0.0) == cfg.is_moe
    assert_params_close(state.params, jstate.params)
    assert int(state.opt_state["step"]) == 1


def test_two_microbatches_equal_one(pair):
    """2 microbatches equal 1, but for MoE: its Switch aux loss (a product
    of two batch means) and its capacity are a microbatch's, in both
    packages, so there the 2-microbatch step is held to JAX's."""
    jmodel, jcfg, jparams, model, cfg, params = pair
    batch = np_batch(cfg)
    two, met2 = port_step_of(model, cfg, params, sgd(0.05), batch,
                             n_microbatches=2)
    if cfg.is_moe:
        one, met1 = jax_step_of(jmodel, jcfg, jparams, jopt.sgd(0.05), batch,
                                n_microbatches=2)
        assert_metrics_close(met2, met1, metric_keys(cfg))
        assert_params_close(two.params, one.params)
        return
    one, met1 = port_step_of(model, cfg, params, sgd(0.05), batch)
    assert_metrics_close(met2, met1, metric_keys(cfg))
    assert_params_close(two.params, params_to_numpy(one.params))


def test_ewc_step_matches_jax(pair):
    jmodel, jcfg, jparams, model, cfg, params = pair
    batch = np_batch(cfg)
    rng = np.random.default_rng(7)
    anchor = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), jparams)
    jstate, jmet = jax_step_of(
        jmodel, jcfg, jparams, jopt.sgd(0.05), batch,
        ewc=JaxEWCState(jax.tree.map(jnp.asarray, anchor), None, 0.5))
    state, met = port_step_of(
        model, cfg, params, sgd(0.05), batch,
        ewc=EWCState(params_from_numpy(anchor, "cpu"), None, 0.5))
    assert_metrics_close(met, jmet)
    assert float(met["loss"]) > float(met["ce"])       # the penalty is in
    assert_params_close(state.params, jstate.params)


def test_ewc_step_with_fisher_and_microbatches_matches_jax():
    """SGD, as every step above: Adam's first step is -lr * g / (|g| + eps),
    so a gradient entry near eps moves by lr under a 1e-8 change of g and
    the comparison would measure that, not the port (the optimizers are
    held alone in tests/test_torch_optim.py)."""
    jcfg = jax_reduced(jax_get_config("mamba2-370m"))
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(2))
    cfg = reduced_for_smoke(get_config("mamba2-370m"))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(8)
    anchor = jax.tree.map(lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(
        x.shape)).astype(np.float32), jparams)
    fisher = jax.tree.map(lambda x: rng.random(x.shape).astype(np.float32),
                          jparams)
    batch = np_batch(cfg, seed=3)
    jstate, jmet = jax_step_of(
        jmodel, jcfg, jparams, jopt.sgd(0.05), batch,
        n_microbatches=2,
        ewc=JaxEWCState(jax.tree.map(jnp.asarray, anchor),
                        jax.tree.map(jnp.asarray, fisher), 2.0))
    state, met = port_step_of(
        build_model(cfg), cfg, params, sgd(0.05), batch, n_microbatches=2,
        ewc=EWCState(params_from_numpy(anchor, "cpu"),
                     params_from_numpy(fisher, "cpu"), 2.0))
    assert_metrics_close(met, jmet)
    assert_params_close(state.params, jstate.params)


# ------------------------------- tests/test_smoke_archs.py:32,65 (port side)
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_train_step(arch):
    cfg = reduced_for_smoke(get_config(arch))
    model = build_model(cfg)
    opt = adamw(1e-3)
    state = init_train_state(model, opt, torch.Generator().manual_seed(0),
                             "cpu")
    batch = np_batch(cfg, seed=0)
    with torch.no_grad():
        logits, _ = model.forward(state.params, **forward_inputs(cfg, batch))
    n_patch = N_PATCH if cfg.family == "vlm" else 0
    assert logits.shape == (B, n_patch + S, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any()), arch
    new_state, metrics = build_train_step(model, cfg, opt)(state, batch)
    assert np.isfinite(float(metrics["loss"])), arch
    assert any(bool(torch.any(a != b)) for a, b in zip(
        tree_leaves(state.params), tree_leaves(new_state.params),
        strict=True)), arch


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-370m"])
def test_smoke_two_steps_reduce_loss(arch):
    cfg = reduced_for_smoke(get_config(arch))
    model = build_model(cfg)
    opt = adamw(5e-3)
    state = init_train_state(model, opt, torch.Generator().manual_seed(1),
                             "cpu")
    step = build_train_step(model, cfg, opt)
    batch = lm_batch(np.random.default_rng(0), B, S, cfg.vocab_size)
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch)   # same batch: loss must drop
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], (arch, losses)


# ----------------------------- tests/test_system.py:64, and its example
def test_federated_llm_round_matches_jax():
    """The reference's ``test_federated_llm_round`` (reduced gemma, sgd, 3
    organisations, one round) in both packages from the same parameters."""
    jcfg = jax_reduced(jax_get_config("gemma-2b"))
    jmodel = jax_build_model(jcfg)
    jo = jopt.sgd(5e-3)
    jparams = jmodel.init(jax.random.key(0))
    jstep = jax.jit(jax_train_step(jmodel, jcfg, jo))

    def jax_train_fn(p, dataset, rng_, anchor):
        state = JaxTrainState(p, jo.init(p))
        for _ in range(2):
            b = jax_lm_batch(rng_, 2, 16, jcfg.vocab_size)
            state, _ = jstep(state, jax_batch(b))
        return state.params, 4, 2

    cfg = reduced_for_smoke(get_config("gemma-2b"))
    model = build_model(cfg)
    opt = sgd(5e-3)
    step = build_train_step(model, cfg, opt)

    def train_fn(p, dataset, rng_, anchor):
        state = TrainState(p, opt.init(p))
        for _ in range(2):
            state, _ = step(state, lm_batch(rng_, 2, 16, cfg.vocab_size))
        return state.params, 4, 2

    def specs(cls):
        rngn = np.random.default_rng(0)
        return [cls(f"org{i}", {"loc": np.array([48.2 + rngn.normal(0, .1),
                                                 16.4 + rngn.normal(0, .1)])},
                    None) for i in range(3)]

    jfed = JaxFedCCL(JaxFedCCLConfig(
        spaces=(JaxSpace("loc", eps=100.0, min_samples=2,
                         metric="haversine"),), seed=0), jparams,
        jax_train_fn)
    jfed.setup(specs(JaxClientSpec))
    jstats = jfed.run(rounds=1)
    init = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    fed = FedCCL(FedCCLConfig(
        spaces=(ClusterSpaceConfig("loc", eps=100.0, min_samples=2,
                                   metric="haversine"),), seed=0), init,
        train_fn, device="cpu")
    fed.setup(specs(ClientSpec))
    stats = fed.run(rounds=1)
    assert stats == jstats
    assert stats["updates"] == 3 * 2          # cluster + global per client
    g = fed.store.params("global")
    assert_params_close(g, jfed.store.params("global"))
    assert any(bool(torch.any(a != b)) for a, b in zip(
        tree_leaves(g), tree_leaves(init), strict=True))


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_federated_llm_example_matches_jax(capsys):
    """``examples/federated_llm_torch.py`` against ``examples/
    federated_llm.py`` (reduced mamba2-370m, 4 organisations, 2 rounds):
    the same schedule and stats (weights differ: each package draws its
    own), the eval loss falling in both, and the update count
    ``chip_smoke.py`` holds its full-width run to."""
    ref = load_example("federated_llm")
    seen = []

    class Recording(JaxFedCCL):
        def run(self, *a, **kw):
            seen.append(super().run(*a, **kw))
            return seen[-1]

    ref.FedCCL = Recording
    ref.federate("mamba2-370m")
    got = load_example("federated_llm_torch").federate("mamba2-370m",
                                                       device="cpu")
    assert len(seen) == 1
    assert got["stats"] == seen[0]
    assert got["stats"]["updates"] == chip_smoke.FED_LLM_UPDATES
    assert got["loss1"] < got["loss0"]
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == ["mamba2-370m"] * 2


def test_federated_llm_example_federates_moe(capsys):
    """The example federates deepseek-moe-16b, one of the reference
    example's default archs: the same update count
    as the mamba2-370m run (the schedule does not depend on the model) and
    a falling eval loss."""
    got = load_example("federated_llm_torch").federate("deepseek-moe-16b",
                                                       device="cpu")
    assert got["stats"]["updates"] == chip_smoke.FED_LLM_UPDATES
    assert got["loss1"] < got["loss0"]
    assert capsys.readouterr().out.split()[0] == "deepseek-moe-16b"


# --------------------------------------------- the kernels' plain VJPs, f64
@pytest.mark.parametrize("b,c,l,h,p,g,n", [
    (1, 2, 6, 4, 3, 2, 5),            # two groups of two heads
    (2, 1, 5, 3, 2, 1, 4),            # one group (mamba2's layout)
    (1, 2, 4, 2, 3, 2, 3),            # g == h, the head-broadcast layout
])
def test_ssd_chunk_plain_vjp_is_the_gradient(b, c, l, h, p, g, n):
    gen = torch.Generator().manual_seed(b * 100 + l)
    f64 = torch.float64

    def r(*shape):
        return torch.randn(*shape, generator=gen, dtype=f64)
    args = (r(b, c, l, h, p), -torch.rand(b, c, l, h, generator=gen,
                                           dtype=f64),
            r(b, c, l, g, n), r(b, c, l, g, n))
    live = [a.clone().requires_grad_() for a in args]
    assert torch.autograd.gradcheck(SsdIntraChunkFn.apply, live)
    y, st = ssd_intra_chunk_ref(*live)
    dy, dst = r(*y.shape), r(*st.shape)
    want = torch.autograd.grad((y * dy).sum() + (st * dst).sum(), live)
    got = ssd_intra_chunk_bwd_ref(*args, dy, dst)
    for a, w in zip(got, want, strict=True):
        assert a.dtype == f64
        torch.testing.assert_close(a, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("H,KV,S,T,causal,window", [
    (4, 2, 7, 7, True, 0),            # GQA, causal
    (3, 1, 6, 9, False, 0),           # MQA, bidirectional, S != T
    (2, 2, 9, 9, True, 3),            # a window
    (4, 1, 8, 8, False, 4),           # a window without causality
])
def test_local_attn_plain_vjp_is_the_gradient(H, KV, S, T, causal, window):
    gen = torch.Generator().manual_seed(H * 10 + S)
    f64 = torch.float64
    q = torch.randn(2, H, S, 5, generator=gen, dtype=f64)
    k, v = (torch.randn(2, KV, T, 5, generator=gen, dtype=f64)
            for _ in range(2))
    kw = dict(causal=causal, window=window, scale=0.6)
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda *a: LocalAttnFn.apply(*a, causal, window, 0.6, True), live)
    out = local_attention_ref(*live, **kw)
    assert out.dtype == f64
    dout = torch.randn(out.shape, generator=gen, dtype=f64)
    want = torch.autograd.grad((out * dout).sum(), live)
    got = local_attention_bwd_ref(q, k, v, dout, **kw)
    for a, w in zip(got, want, strict=True):
        torch.testing.assert_close(a, w, rtol=1e-10, atol=1e-10)


def test_model_gradients_flow_through_both_kernels():
    """Every leaf of both LLM families gets a gradient, the mixers'
    projections among them (what a forward with no grad_fn would lose)."""
    for arch in ("mamba2-370m", "gemma-2b"):
        cfg = reduced_for_smoke(get_config(arch))
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        live = tree_map(lambda x: x.requires_grad_(), params)
        batch = np_batch(cfg)
        logits, _ = model.forward(live, tokens=batch["tokens"])
        grads = torch.autograd.grad(logits.float().square().mean(),
                                    tree_leaves(live), allow_unused=True)
        assert all(g is not None and bool(g.abs().sum() > 0)
                   for g in grads), arch
