"""Transformer and SSM blocks over stacked layers.

A *block kind* bundles a mixer and a feed-forward choice.  The port has:
  attn_mlp     pre-norm attention (GQA/MQA) + gated MLP   (dense)
  ssm          single-norm Mamba-2 mixer                  (ssm)
The reference's other kinds (attn_dense, attn_moe, recurrent, local_attn)
and families (moe, hybrid, audio, vlm) raise ``NotImplementedError``.

Each kind exposes ``block_schema(cfg, kind)`` and ``block_apply`` with one
signature, so the model walks homogeneous stacks of stacked params and
caches.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    NOT_PORTED,
    attention_forward,
    attention_schema,
    init_kv_cache,
)
from repro_torch.models.layers import rmsnorm, rmsnorm_schema
from repro_torch.models.mlp import mlp_forward, mlp_schema
from repro_torch.models.ssm import init_ssm_state, ssm_forward, ssm_schema

KINDS = ("attn_mlp", "ssm")


def _require_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r} is {NOT_PORTED}")


def block_schema(cfg: ModelConfig, kind: str) -> dict:
    _require_kind(kind)
    d = cfg.d_model
    if kind == "ssm":
        return {"norm": rmsnorm_schema(d), "mixer": ssm_schema(cfg)}
    if cfg.mla is not None:
        raise NotImplementedError(f"MLA attention is {NOT_PORTED}")
    return {"norm1": rmsnorm_schema(d), "attn": attention_schema(cfg),
            "norm2": rmsnorm_schema(d), "mlp": mlp_schema(d, cfg.d_ff)}


def block_apply(cfg: ModelConfig, kind: str, p: dict, h, *, positions,
                rules=None, cache=None, cache_pos=None, window_override=None):
    """Returns (h_out, new_cache, aux_loss)."""
    _require_kind(kind)
    eps = cfg.norm_eps
    causal = not cfg.encoder_only
    zero = torch.zeros((), dtype=torch.float32, device=h.device)

    if kind == "ssm":
        y, new_state = ssm_forward(cfg, p["mixer"], rmsnorm(p["norm"], h, eps),
                                   rules=rules, state=cache)
        return h + y, new_state, zero

    window = cfg.attn_window or 0
    if window_override is not None:
        window = window_override
    y, new_cache = attention_forward(
        cfg, p["attn"], rmsnorm(p["norm1"], h, eps), positions=positions,
        window=window, causal=causal, rules=rules, cache=cache,
        cache_pos=cache_pos)
    h = h + y
    inner = rmsnorm(p["norm2"], h, eps)
    h = h + mlp_forward(p["mlp"], inner, cfg.mlp_activation, rules)
    return h, new_cache, zero


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None):
    """Per-layer cache/state for decode."""
    _require_kind(kind)
    if kind == "ssm":
        return init_ssm_state(cfg, batch, torch.float32, device)
    return init_kv_cache(cfg, batch, max_len, dtype, device)


# ---------------------------------------------------------------------------
# Stack layout per architecture family
# ---------------------------------------------------------------------------


def stack_layout(cfg: ModelConfig) -> list[tuple[str, list[str], int]]:
    """Returns segments: (mode, [block kinds in group], repeat).

    mode "scan": params stacked (repeat, ...), walked layer by layer.
    """
    if cfg.family == "ssm":
        return [("scan", ["ssm"], cfg.n_layers)]
    if cfg.family == "dense" and not cfg.is_moe:
        return [("scan", ["attn_mlp"], cfg.n_layers)]
    raise NotImplementedError(f"the {cfg.family!r} family ({cfg.name}) is "
                              f"{NOT_PORTED}")
