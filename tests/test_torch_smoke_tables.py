"""The smoke's LLM tables cover every config, on the CPU.

``chip_smoke.py`` runs on the card what its tables name: ``LLM`` (scoring,
serving, decode by replay and the CUDA-against-CPU gradients), ``LLM_TRAIN``
and ``REMAT_TRAIN`` (training).  A config missing from them never runs
on the card, and nothing else would say so:

- every config of ``repro_torch.configs.ALL_ARCHS`` has a row in ``LLM``,
  and trains in ``LLM_TRAIN`` or ``REMAT_TRAIN`` (each with its batch in
  ``LLM_TRAIN``) unless it is in ``MULTI_CARD_TRAIN``, the configs whose
  training needs more than one card (deepseek-v3-671b alone); the kernel
  phase's D 128 shape is glm4-9b's training shape;
- the smoke holds each training step of the three dense configs at D 128
  to ``step_launches``: one reduced step of each under remat "full" calls
  the attention wrapper (the kernel's forward on the card) once a block
  and once more a recomputed block, and its backward once a block.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import repro_torch.models.attention as attention
from repro_torch.configs import ALL_ARCHS, get_config, reduced_for_smoke
from repro_torch.data.lm_synth import lm_batch
from repro_torch.kernels.local_attn import ops as attn_ops
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.training.train_step import TrainState, build_train_step

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

DENSE_D128 = ("deepseek-7b", "glm4-9b", "granite-8b")
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work: the suite's xdist
    workers share the cores, and torch's default pool in each would
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_every_config_runs_on_the_card():
    assert chip_smoke.MULTI_CARD_TRAIN == {"deepseek-v3-671b"}
    for arch in ALL_ARCHS:
        assert arch in chip_smoke.LLM, f"{arch}: no row in chip_smoke.LLM"
        trained = arch in chip_smoke.LLM_TRAIN or arch in chip_smoke.REMAT_TRAIN
        assert trained or arch in chip_smoke.MULTI_CARD_TRAIN, (
            f"{arch}: trained nowhere in the smoke")
    assert set(chip_smoke.LLM) == set(ALL_ARCHS)
    assert set(chip_smoke.REMAT_TRAIN) <= set(chip_smoke.LLM_TRAIN)
    assert not chip_smoke.MULTI_CARD_TRAIN & (set(chip_smoke.LLM_TRAIN)
                                              | set(chip_smoke.REMAT_TRAIN))
    cfg = get_config("glm4-9b")
    b, s = chip_smoke.LLM_TRAIN["glm4-9b"]
    assert chip_smoke.ATTN_D128 == (b, cfg.n_heads, cfg.n_kv_heads, s,
                                    cfg.head_dim)


@pytest.mark.parametrize("arch", DENSE_D128)
def test_remat_step_calls_attention_as_the_smoke_counts(arch, monkeypatch):
    cfg = reduced_for_smoke(get_config(arch)).replace(remat="full")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = attention.local_flash_attention, attn_ops.local_attention_bwd

    def spy_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def spy_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(attention, "local_flash_attention", spy_fwd)
    monkeypatch.setattr(attn_ops, "local_attention_bwd", spy_bwd)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    opt = adamw(1e-3)
    step = build_train_step(model, cfg, opt)
    batch = lm_batch(np.random.default_rng(1), B, S, cfg.vocab_size)
    _, metrics = step(TrainState(params, opt.init(params)), batch)
    want = chip_smoke.step_launches(cfg)
    assert np.isfinite(float(metrics["loss"]))
    assert want["local_attn_tc"] > cfg.n_layers     # the recomputes
    assert calls == {"fwd": want["local_attn_tc"],
                     "bwd": want["local_attn_bwd_tc"]}, (calls, want)
