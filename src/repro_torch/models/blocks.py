"""Transformer / SSM / hybrid blocks over stacked layers.

A *block kind* bundles a mixer and a feed-forward choice:
  attn_mlp     pre-norm attention (GQA/MQA/MLA) + gated MLP   (dense/audio/vlm)
  attn_dense   like attn_mlp but with the MoE config's dense d_ff (first-k)
  attn_moe     attention + mixture-of-experts                  (moe archs)
  ssm          single-norm Mamba-2 mixer                       (ssm archs)
  recurrent    RG-LRU + gated MLP                              (hybrid)
  local_attn   windowed attention + gated MLP, a window-sized
               rolling cache                                   (hybrid)

Each kind exposes ``block_schema(cfg, kind)`` and ``block_apply`` with one
signature, so the model walks homogeneous stacks of stacked params and
caches ("scan" segments) and per-block ones ("unroll" segments).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    attention_forward,
    attention_schema,
    init_kv_cache,
    mla_forward,
    mla_schema,
)
from repro_torch.models.layers import rmsnorm, rmsnorm_schema
from repro_torch.models.mlp import mlp_forward, mlp_schema
from repro_torch.models.moe import moe_forward, moe_schema
from repro_torch.models.rglru import init_rglru_state, rglru_forward, rglru_schema
from repro_torch.models.ssm import init_ssm_state, ssm_forward, ssm_schema

ATTN_KINDS = ("attn_mlp", "attn_dense", "attn_moe", "local_attn")


def _attn_schema(cfg: ModelConfig) -> dict:
    return mla_schema(cfg) if cfg.mla is not None else attention_schema(cfg)


def block_schema(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    if kind == "ssm":
        return {"norm": rmsnorm_schema(d), "mixer": ssm_schema(cfg)}
    if kind == "recurrent":
        return {"norm1": rmsnorm_schema(d), "rglru": rglru_schema(cfg),
                "norm2": rmsnorm_schema(d), "mlp": mlp_schema(d, cfg.d_ff)}
    if kind in ("attn_mlp", "local_attn"):
        return {"norm1": rmsnorm_schema(d), "attn": _attn_schema(cfg),
                "norm2": rmsnorm_schema(d), "mlp": mlp_schema(d, cfg.d_ff)}
    if kind == "attn_dense":
        return {"norm1": rmsnorm_schema(d), "attn": _attn_schema(cfg),
                "norm2": rmsnorm_schema(d),
                "mlp": mlp_schema(d, cfg.moe.effective_dense_d_ff)}
    if kind == "attn_moe":
        return {"norm1": rmsnorm_schema(d), "attn": _attn_schema(cfg),
                "norm2": rmsnorm_schema(d), "moe": moe_schema(cfg)}
    raise ValueError(kind)


def _attn_apply(cfg, p, x, *, positions, window, causal, rules, cache, cache_pos,
                absorb=True, rolling=False):
    if cfg.mla is not None:
        return mla_forward(cfg, p, x, positions=positions, window=window,
                           causal=causal, rules=rules, cache=cache,
                           cache_pos=cache_pos, absorb=absorb)
    return attention_forward(cfg, p, x, positions=positions, window=window,
                             causal=causal, rules=rules, cache=cache,
                             cache_pos=cache_pos, rolling=rolling)


def block_apply(cfg: ModelConfig, kind: str, p: dict, h, *, positions,
                rules=None, cache=None, cache_pos=None, window_override=None,
                mla_absorb: bool = True):
    """Returns (h_out, new_cache, aux_loss).  ``mla_absorb`` acts on MLA
    with a cache (decode) only: the cache-free forward runs the kernel on
    the expanded K/V."""
    eps = cfg.norm_eps
    causal = not cfg.encoder_only
    zero = torch.zeros((), dtype=torch.float32, device=h.device)

    if kind == "ssm":
        y, new_state = ssm_forward(cfg, p["mixer"], rmsnorm(p["norm"], h, eps),
                                   rules=rules, state=cache)
        return h + y, new_state, zero

    if kind == "recurrent":
        y, new_state = rglru_forward(cfg, p["rglru"], rmsnorm(p["norm1"], h, eps),
                                     rules=rules, state=cache)
        h = h + y
        h = h + mlp_forward(p["mlp"], rmsnorm(p["norm2"], h, eps),
                            cfg.mlp_activation, rules)
        return h, new_state, zero

    # attention-bearing kinds
    if kind not in ATTN_KINDS:
        raise ValueError(kind)
    if kind == "local_attn":
        window = cfg.rglru.attn_window if cfg.rglru else (cfg.attn_window or 0)
    else:
        window = cfg.attn_window or 0
    if window_override is not None:
        window = window_override

    y, new_cache = _attn_apply(cfg, p["attn"], rmsnorm(p["norm1"], h, eps),
                               positions=positions, window=window, causal=causal,
                               rules=rules, cache=cache, cache_pos=cache_pos,
                               absorb=mla_absorb, rolling=(kind == "local_attn"))
    h = h + y
    inner = rmsnorm(p["norm2"], h, eps)
    if kind == "attn_moe":
        y2, aux = moe_forward(cfg, p["moe"], inner, rules)
        return h + y2, new_cache, aux
    h = h + mlp_forward(p["mlp"], inner, cfg.mlp_activation, rules)
    return h, new_cache, zero


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None):
    """Per-layer cache/state for decode.  local_attn caches only its window."""
    if kind == "ssm":
        return init_ssm_state(cfg, batch, torch.float32, device)
    if kind == "recurrent":
        return init_rglru_state(cfg, batch, torch.float32, device)
    if kind == "local_attn":
        window = cfg.rglru.attn_window if cfg.rglru else (cfg.attn_window or max_len)
        return init_kv_cache(cfg, batch, min(window, max_len), dtype, device)
    if kind in ("attn_mlp", "attn_dense", "attn_moe"):
        return init_kv_cache(cfg, batch, max_len, dtype, device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Stack layout per architecture family
# ---------------------------------------------------------------------------


def stack_layout(cfg: ModelConfig) -> list[tuple[str, list[str], int]]:
    """Returns segments: (mode, [block kinds in group], repeat).

    mode "scan": params stacked (repeat, ...), walked layer by layer.
    mode "unroll": separate params per block, python loop.
    """
    if cfg.family == "ssm":
        return [("scan", ["ssm"], cfg.n_layers)]
    if cfg.family == "hybrid":
        pattern = list(cfg.rglru.block_pattern)
        pattern = ["recurrent" if k == "recurrent" else "local_attn" for k in pattern]
        n_groups, rem = divmod(cfg.n_layers, len(pattern))
        segs: list = [("scan", pattern, n_groups)] if n_groups else []
        if rem:
            segs.append(("unroll", pattern[:rem], 1))
        return segs
    if cfg.is_moe:
        segs = []
        fk = cfg.moe.first_k_dense
        if fk:
            segs.append(("unroll", ["attn_dense"] * fk, 1))
        segs.append(("scan", ["attn_moe"], cfg.n_layers - fk))
        return segs
    # dense / audio / vlm
    return [("scan", ["attn_mlp"], cfg.n_layers)]


def attention_blocks(cfg: ModelConfig) -> int:
    """Attention-bearing blocks one full-sequence forward walks (one
    ``local_attn`` launch each on CUDA), the MTP block not included."""
    return sum(repeat * sum(k in ATTN_KINDS for k in kinds)
               for _mode, kinds, repeat in stack_layout(cfg))
