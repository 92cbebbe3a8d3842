"""Attention, the GQA / MQA part: RoPE, causal & bidirectional &
sliding-window masks, KV caches.

The cache-free (full-sequence) forward goes through the ``local_attn``
kernel (``kernels/local_attn``; its plain version on the CPU); decode uses
the einsum ``_sdpa`` over the cache, as in the reference.  MLA, rolling
caches and softcapped attention are not ported yet (``ROADMAP.md`` §1,
the entry "The rest of the LLM side") and raise.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.local_attn.ops import local_flash_attention
from repro_torch.models.layers import apply_rope, einsum, softcap
from repro_torch.sharding.logical import ParamSpec, constrain

NEG_INF = -2.0**30  # large-negative instead of -inf: keeps softmax NaN-free
NOT_PORTED = ("not ported to repro_torch yet (ROADMAP.md §1, \"The rest "
              "of the LLM side\": MoE, MLA and RG-LRU with rolling caches)")


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------


def attention_schema(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sch = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        sch["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), init="zeros")
        sch["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        sch["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    return sch


# ---------------------------------------------------------------------------
# Masking helpers
# ---------------------------------------------------------------------------


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int):
    """(q, k) additive bias from position vectors.

    q_pos: (s,) or (b, s); k_pos: (t,) or (b, t) -> bias (s, t) or (b, s, t).
    """
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    shape = torch.broadcast_shapes(q.shape, k.shape)
    ok = torch.ones(shape, dtype=torch.bool, device=q.device)
    if causal:
        ok &= k <= q
    if window:
        ok &= k > q - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


# ---------------------------------------------------------------------------
# Core attention math (einsum path, decode)
# ---------------------------------------------------------------------------


def _sdpa(q, k, v, bias, scale, cap, rules):
    """q: (b,s,kv,g,hd); k,v: (b,t,kv,hd); bias: (s,t) or (b,s,t)."""
    qf = q.to(torch.float32) * scale
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.to(torch.float32))
    scores = softcap(scores, cap)
    if bias.dim() == 2:
        scores = scores + bias
    else:
        scores = scores + bias[:, None, None]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.to(torch.float32))
    return out.to(v.dtype)


def _kernel_attention(qg, k, v, *, causal, window, scale):
    """qg: (b,s,kv,g,hd); k/v: (b,t,kv,hd) -> (b,s,kv,g,hd)."""
    b, s, kvh, g, hd = qg.shape
    qh = qg.reshape(b, s, kvh * g, hd).transpose(1, 2)          # (b,H,s,hd)
    kh = k.transpose(1, 2)                                      # (b,KV,t,hd)
    vh = v.transpose(1, 2)
    out = local_flash_attention(qh, kh, vh, causal=causal, window=window,
                                scale=scale)
    return out.transpose(1, 2).reshape(b, s, kvh, g, hd)


def _write_at(cache, new, pos_b):
    """A copy of ``cache`` (b, S, ...) with ``new`` (b, s, ...) written at
    each row's offset, clamped into range as ``dynamic_update_slice``."""
    b, s = new.shape[0], new.shape[1]
    start = torch.clamp(pos_b, 0, cache.shape[1] - s)
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = start[:, None] + torch.arange(s, device=cache.device)
    out = cache.clone()
    out[rows, cols] = new.to(cache.dtype)
    return out


def attention_forward(cfg: ModelConfig, p: dict, x, *, positions, window: int,
                      causal: bool, rules=None, cache: dict | None = None,
                      cache_pos=None, rolling: bool = False):
    """Full-sequence forward (cache=None) or single/multi-token decode step.

    Returns (y, new_cache). Cache layout: {"k","v"}: (b, S, kv, hd).
    ``cache_pos``: scalar (lockstep batch) or (b,) per-sequence offsets.
    """
    if cfg.attn_logit_softcap:
        raise NotImplementedError(f"softcapped attention is {NOT_PORTED}")
    if rolling:
        raise NotImplementedError(f"the rolling local-attention cache is "
                                  f"{NOT_PORTED}")
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    scale = hd ** -0.5

    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = constrain(q, ("batch", "seq", "heads", "head_dim"), rules)
    k = constrain(k, ("batch", "seq", "kv_heads", "head_dim"), rules)
    v = constrain(v, ("batch", "seq", "kv_heads", "head_dim"), rules)

    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    qg = q.reshape(b, s, kv, g, hd)

    if cache is None:
        out = _kernel_attention(qg, k, v, causal=causal, window=window,
                                scale=scale)
        new_cache = None
    else:
        # decode: write new k/v at cache_pos, attend over (windowed) cache.
        S = cache["k"].shape[1]
        dev = x.device
        pos_b = torch.as_tensor(cache_pos, device=dev).reshape(-1).expand(b)
        ck = _write_at(cache["k"], k, pos_b)
        cv = _write_at(cache["v"], v, pos_b)
        new_cache = {"k": ck, "v": cv}
        if window and window < S:
            start = torch.clamp(pos_b + s - window, 0, S - window)  # (b,)
            idx = start[:, None] + torch.arange(window, device=dev)  # (b, w)
            rows = torch.arange(b, device=dev)[:, None]
            k_att, v_att = ck[rows, idx], cv[rows, idx]
            k_pos_idx = idx
        else:
            k_att, v_att = ck, cv
            k_pos_idx = torch.arange(S, device=dev).expand(b, S)
        valid = k_pos_idx < (pos_b[:, None] + s)             # only written slots
        bias = _mask_bias(positions, k_pos_idx, causal=causal, window=window)
        bias = torch.where(valid[:, None, :], bias, NEG_INF)
        out = _sdpa(qg, k_att, v_att, bias, scale, cfg.attn_logit_softcap,
                    rules)

    out = out.reshape(b, s, h, hd)
    y = einsum("bshk,hkd->bsd", out, p["wo"])
    return constrain(y, ("batch", "seq", "embed"), rules), new_cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    """Per-layer cache (stacked over layers by the caller)."""
    if cfg.mla is not None:
        raise NotImplementedError(f"the MLA latent cache is {NOT_PORTED}")
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
