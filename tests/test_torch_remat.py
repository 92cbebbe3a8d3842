"""``cfg.remat`` in the port's forward, on the CPU.

The reference wraps each repetition of a "scan" segment in
``jax.checkpoint`` ("full") or ``jax.checkpoint`` with ``dots_saveable``
(``src/repro/models/model.py``); the port runs it under
``torch.utils.checkpoint`` (non-reentrant; selective for
"dots_saveable").  Reduced f32 configs of every LLM family
(recurrentgemma at 5 layers, so that one (rec, rec, attn) group scans
beside its unrolled (rec, rec) tail):

- one AdamW step under "full" and "dots_saveable" gives the loss and
  ``grad_norm`` bit-equal to "none", parameters within 1e-6 x
  max(1, max|p|) (a gradient summed in another order);
- the hybrid and MoE families under "full" equal the JAX package's SGD
  step under ``remat="full"`` from the same JAX-initialised weights,
  within the 1e-5 of ``tests/test_torch_train.py``;
- the bytes a forward leaves alive for its backward (every storage an op
  made during the forward that is still held when it returns: what
  autograd saved, and what checkpoint kept, whose own saved-tensor hooks
  nest inside any the caller installs) under "full" are at most half
  those under "none" at 2 x 256, and "dots_saveable" lies between;
- in that step the plain attention runs twice a scanned attention block
  (the forward and its recompute), once an unrolled block and once the
  MTP block, and its backward once a block; with no gradient taken it
  runs once a block and the logits are bit-equal to "none";
- an unknown ``remat`` raises.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_for_smoke as jax_reduced
from repro.models.model import build_model as jax_build_model
from repro.optim import optimizers as jopt
from repro.training.train_step import TrainState as JaxTrainState
from repro.training.train_step import build_train_step as jax_train_step
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.data.lm_synth import audio_batch, lm_batch, vlm_batch
from repro_torch.kernels.local_attn import ops as attn_ops
from repro_torch.models.blocks import ATTN_KINDS
from repro_torch.models.model import build_model
from repro_torch.optim import adamw, sgd
from repro_torch.training.losses import loss_for_batch
from repro_torch.training.train_step import TrainState, build_train_step
from repro_torch.utils.tree import (
    params_from_numpy,
    params_to_numpy,
    tree_leaves,
    tree_map,
)

ARCHS = ["deepseek-7b", "gemma-2b", "glm4-9b", "granite-8b", "mamba2-370m",
         "deepseek-moe-16b", "deepseek-v3-671b", "recurrentgemma-9b",
         "hubert-xlarge", "internvl2-76b"]
B, S, N_PATCH = 2, 24, 8
STEP_RTOL = 1e-6        # remat against "none": parameters x max(1, max|p|)
JAX_TOL = 1e-5          # the port against the JAX package


@pytest.fixture(autouse=True)
def one_thread():
    """Each case is many small ops: one intra-op thread a process keeps the
    suite's workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(arch, remat="none"):
    cfg = reduced_for_smoke(get_config(arch))
    if cfg.family == "hybrid":
        cfg = cfg.replace(n_layers=5)
    return cfg.replace(remat=remat)


def np_batch(cfg, s=S, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return audio_batch(rng, B, s, cfg.frontend.embed_dim, cfg.vocab_size,
                           mask_prob=0.3)
    if cfg.family == "vlm":
        return vlm_batch(rng, B, N_PATCH + s, N_PATCH, cfg.frontend.embed_dim,
                         cfg.vocab_size)
    return lm_batch(rng, B, s, cfg.vocab_size)


def init(cfg):
    return build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")


def train_step(cfg, params, batch, opt=None):
    opt = opt or adamw(1e-3)
    step = build_train_step(build_model(cfg), cfg, opt)
    return step(TrainState(params, opt.init(params)), batch)


def scanned_attention_blocks(model) -> int:
    return sum(repeat * sum(k in ATTN_KINDS for k in kinds)
               for mode, kinds, repeat in model.layout if mode == "scan")


def attention_blocks(model) -> int:
    return sum(repeat * sum(k in ATTN_KINDS for k in kinds)
               for _mode, kinds, repeat in model.layout) + model.cfg.mtp_depth


class counted_attention:
    """Counts calls of the plain attention and its VJP, the CPU route of
    ``local_attn``'s forward and backward."""

    def __init__(self, monkeypatch):
        self.fwd = self.bwd = 0
        fwd, bwd = attn_ops.local_attention_ref, attn_ops.local_attention_bwd_ref

        def counted_fwd(*a, **kw):
            self.fwd += 1
            return fwd(*a, **kw)

        def counted_bwd(*a, **kw):
            self.bwd += 1
            return bwd(*a, **kw)

        monkeypatch.setattr(attn_ops, "local_attention_ref", counted_fwd)
        monkeypatch.setattr(attn_ops, "local_attention_bwd_ref", counted_bwd)

    def take(self) -> tuple[int, int]:
        out, self.fwd, self.bwd = (self.fwd, self.bwd), 0, 0
        return out


_NONE_STEPS: dict = {}


def none_step(arch, count):
    """(params, batch, state, metrics, attention calls) of one AdamW step
    of ``arch`` under "none", made once a module."""
    if arch not in _NONE_STEPS:
        cfg = config(arch)
        params, batch = init(cfg), np_batch(cfg)
        count.take()
        _NONE_STEPS[arch] = (params, batch, *train_step(cfg, params, batch),
                             count.take())
    return _NONE_STEPS[arch]


@pytest.mark.parametrize("remat", ["full", "dots_saveable"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_step_equals_none(arch, remat, monkeypatch):
    count = counted_attention(monkeypatch)
    params, batch, want_state, want, calls = none_step(arch, count)
    cfg = config(arch, remat)
    got_state, got = train_step(cfg, params, batch)
    for key in ("loss", "grad_norm"):
        assert float(got[key]) == float(want[key]), (key, got[key], want[key])
    for g, w in zip(tree_leaves(got_state.params),
                    tree_leaves(want_state.params), strict=True):
        lim = STEP_RTOL * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= lim
    # the plain attention: once a block and its VJP once under "none"; a
    # scanned block's forward runs again in the backward
    model = build_model(cfg)
    blocks, again = attention_blocks(model), scanned_attention_blocks(model)
    assert calls == (blocks, blocks)
    assert count.take() == (blocks + again, blocks)
    assert again > 0 or cfg.family == "ssm"


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "deepseek-moe-16b"])
def test_full_remat_step_matches_jax(arch):
    """One SGD step (as ``tests/test_torch_train.py``'s: AdamW's first
    step, m / sqrt(v), turns 1e-7 in a gradient near 0 into 1e-4 in a
    parameter under either remat)."""
    cfg = config(arch, "full")
    if cfg.family == "hybrid":
        cfg = cfg.replace(n_layers=3)   # one scanned group: JAX compiles less
    jcfg = jax_reduced(jax_get_config(arch)).replace(n_layers=cfg.n_layers,
                                                     remat="full")
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    batch = np_batch(cfg)
    jopt_ = jopt.sgd(0.05)
    jstep = jax.jit(jax_train_step(jmodel, jcfg, jopt_))
    jstate, jmet = jstep(JaxTrainState(jparams, jopt_.init(jparams)),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    state, met = train_step(cfg, params, batch, sgd(0.05))
    for key in ("loss", "ce", "grad_norm", "moe_loss"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=JAX_TOL, atol=JAX_TOL, err_msg=key)
    for g, w in zip(tree_leaves(params_to_numpy(state.params)),
                    jax.tree.leaves(jstate.params), strict=True):
        w = np.asarray(w, np.float64)
        lim = JAX_TOL * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(np.asarray(g, np.float64) - w).max()) <= lim


class HeldBytes(TorchDispatchMode):
    """Every storage an op makes while the mode is on; ``held()`` sums the
    ones still alive."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.made.append((StorageWeakRef(st), st.nbytes()))
        return out

    def held(self) -> int:
        gc.collect()
        return sum({ref.cdata: n for ref, n in self.made
                    if not ref.expired()}.values())


def held_for_backward(cfg, params, batch) -> int:
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with HeldBytes() as census:
        loss, _ = loss_for_batch(build_model(cfg), cfg, live, batch)
    held = census.held()
    del loss
    return held


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-370m"])
def test_remat_keeps_fewer_bytes_for_the_backward(arch):
    base = config(arch)
    params, batch = init(base), np_batch(base, s=256)
    held = {r: held_for_backward(base.replace(remat=r), params, batch)
            for r in ("none", "full", "dots_saveable")}
    assert held["full"] <= held["none"] / 2, held
    assert held["full"] < held["dots_saveable"] < held["none"], held


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-9b"])
def test_no_gradient_no_recompute(arch, monkeypatch):
    params = init(config(arch))
    batch = np_batch(config(arch))
    logits = {}
    for remat in ("none", "full"):
        model = build_model(config(arch, remat))
        count = counted_attention(monkeypatch)
        with torch.no_grad():
            logits[remat], _ = model.forward(params, tokens=batch["tokens"])
        assert count.fwd == attention_blocks(model) and count.bwd == 0
    assert torch.equal(logits["full"], logits["none"])


def test_unknown_remat_raises():
    with pytest.raises(ValueError, match="remat"):
        build_model(config("gemma-2b", "offload"))
