"""Attention: MHA / GQA / MQA / MLA, RoPE, causal & bidirectional &
sliding-window masks, KV caches (full, window-sized rolling, MLA latent),
and a plain-torch chunked flash attention (online softmax over query/kv
blocks).

The cache-free (full-sequence) forward goes through the ``local_attn``
kernel (``kernels/local_attn``; its plain version on the CPU), MLA's too,
on K/V expanded from the latent; decode uses the einsum ``_sdpa`` over the
cache, as in the reference.  Softcapped attention never reaches the
kernel, as in the reference: it runs ``flash_attention`` above
``FLASH_THRESHOLD`` and ``_sdpa`` below.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.local_attn.ops import local_flash_attention
from repro_torch.models.layers import apply_rope, einsum, softcap
from repro_torch.sharding.logical import ParamSpec, constrain

NEG_INF = -2.0**30  # large-negative instead of -inf: keeps softmax NaN-free
# softcapped attention takes the chunked flash above this length (the
# reference's default; it reads REPRO_FLASH_THRESHOLD, the port does not)
FLASH_THRESHOLD = 4096


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


def mla_schema(cfg: ModelConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq_a": ParamSpec((d, m.q_lora_rank), ("embed", "rank")),
        "q_norm": ParamSpec((m.q_lora_rank,), ("rank",), init="ones", dtype="float32"),
        "wq_b": ParamSpec((m.q_lora_rank, h, m.qk_head_dim), ("rank", "heads", "head_dim")),
        "wkv_a": ParamSpec((d, m.kv_lora_rank), ("embed", "rank")),
        "kv_norm": ParamSpec((m.kv_lora_rank,), ("rank",), init="ones", dtype="float32"),
        "wk_rope": ParamSpec((d, m.qk_rope_head_dim), ("embed", "head_dim")),
        "wk_b": ParamSpec((m.kv_lora_rank, h, m.qk_nope_head_dim), ("rank", "heads", "head_dim")),
        "wv_b": ParamSpec((m.kv_lora_rank, h, m.v_head_dim), ("rank", "heads", "head_dim")),
        "wo": ParamSpec((h, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


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
# Core attention math (einsum path, decode and softcapped attention)
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


# ---------------------------------------------------------------------------
# Chunked flash attention (plain torch, linear memory)
# ---------------------------------------------------------------------------


def _pad_seq(x, n: int):
    """``x`` with ``n`` zero rows appended on axis 1."""
    if not n:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))],
                     dim=1)


def flash_attention(q, k, v, *, causal: bool, window: int, scale: float,
                    cap: float = 0.0, blk_q: int = 512, blk_k: int = 1024):
    """Online-softmax attention over blocks.  q: (b,s,kv,g,hd), k/v: (b,t,kv,hd).

    Memory per step is O(blk_q * blk_k); never materializes (s, t).
    """
    b, s, kvh, g, hd = q.shape
    hd_v = v.shape[-1]
    t = k.shape[1]
    blk_q = min(blk_q, s)
    blk_k = min(blk_k, t)
    pad_q = (-s) % blk_q
    pad_k = (-t) % blk_k
    q, k, v = _pad_seq(q, pad_q), _pad_seq(k, pad_k), _pad_seq(v, pad_k)
    nq, nk = (s + pad_q) // blk_q, (t + pad_k) // blk_k
    qb = q.reshape(b, nq, blk_q, kvh, g, hd)
    kb = k.reshape(b, nk, blk_k, kvh, hd)
    vb = v.reshape(b, nk, blk_k, kvh, hd_v)

    dev = q.device
    q_pos_all = torch.arange(s + pad_q, device=dev)
    k_pos_all = torch.arange(t + pad_k, device=dev)
    k_valid = k_pos_all < t
    f32 = torch.float32

    outs = []
    for qi in range(nq):
        qchunk = qb[:, qi].to(f32) * scale                   # (b,blkq,kv,g,hd)
        q_pos = q_pos_all[qi * blk_q:(qi + 1) * blk_q]
        m = torch.full((b, kvh, g, blk_q), NEG_INF, dtype=f32, device=dev)
        lsum = torch.zeros((b, kvh, g, blk_q), dtype=f32, device=dev)
        acc = torch.zeros((b, kvh, g, blk_q, hd_v), dtype=f32, device=dev)
        for ki in range(nk):
            kchunk = kb[:, ki].to(f32)
            vchunk = vb[:, ki].to(f32)
            k_pos = k_pos_all[ki * blk_k:(ki + 1) * blk_k]
            kv_ok = k_valid[ki * blk_k:(ki + 1) * blk_k]
            scores = torch.einsum("bskgd,btkd->bkgst", qchunk, kchunk)
            scores = softcap(scores, cap)
            bias = _mask_bias(q_pos, k_pos, causal=causal, window=window)
            bias = torch.where(kv_ok[None, :], bias, NEG_INF)
            scores = scores + bias
            m_new = torch.maximum(m, scores.amax(-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p, vchunk)
            m = m_new
        out = acc / torch.clamp(lsum[..., None], min=1e-30)  # (b,kv,g,blkq,hd)
        outs.append(out.permute(0, 3, 1, 2, 4))              # (b,blkq,kv,g,hd)
    out = torch.cat(outs, dim=1)
    return out[:, :s].to(v.dtype)


# ---------------------------------------------------------------------------
# Standard (GQA) attention layer
# ---------------------------------------------------------------------------


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


def _cache_positions(cache_pos, b: int, device) -> torch.Tensor:
    """``cache_pos`` (an int, a 0-d or a (b,) tensor) as a (b,) vector."""
    return torch.as_tensor(cache_pos, device=device).reshape(-1).expand(b)


def _window_of(cache, pos_b, s: int, window: int):
    """The attended slots of a full-length cache: each row's last
    ``window`` written slots where the window is shorter than the cache
    (``dynamic_slice`` from a clamped start), else all of them.  Returns
    (a function gathering those slots of a (b, S, ...) leaf, their
    absolute positions (b, t))."""
    b, S = pos_b.shape[0], cache.shape[1]
    dev = cache.device
    if window and window < S:
        start = torch.clamp(pos_b + s - window, 0, S - window)   # (b,)
        idx = start[:, None] + torch.arange(window, device=dev)  # (b, w)
        rows = torch.arange(b, device=dev)[:, None]
        return (lambda c: c[rows, idx]), idx
    return (lambda c: c), torch.arange(S, device=dev).expand(b, S)


def attention_forward(cfg: ModelConfig, p: dict, x, *, positions, window: int,
                      causal: bool, rules=None, cache: dict | None = None,
                      cache_pos=None, rolling: bool = False):
    """Full-sequence forward (cache=None) or single/multi-token decode step.

    Returns (y, new_cache). Cache layout: {"k","v"}: (b, S, kv, hd).
    ``cache_pos``: scalar (lockstep batch) or (b,) per-sequence offsets.
    ``rolling=True``: the cache is window-sized; each step shifts it left and
    appends (local attention — RecurrentGemma).  ``cache_pos`` is then the
    absolute position of the first new token.
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    scale = hd ** -0.5
    cap = cfg.attn_logit_softcap

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
        if not cap:
            out = _kernel_attention(qg, k, v, causal=causal, window=window,
                                    scale=scale)
        elif s > FLASH_THRESHOLD:
            out = flash_attention(qg, k, v, causal=causal, window=window,
                                  scale=scale, cap=cap)
        else:
            bias = _mask_bias(positions, positions, causal=causal,
                              window=window)
            out = _sdpa(qg, k, v, bias, scale, cap, rules)
        new_cache = None
    elif rolling:
        # window-sized rolling cache: shift left by s, append new k/v.
        S = cache["k"].shape[1]
        ck = torch.cat([cache["k"][:, s:], k.to(cache["k"].dtype)], dim=1)
        cv = torch.cat([cache["v"][:, s:], v.to(cache["v"].dtype)], dim=1)
        new_cache = {"k": ck, "v": cv}
        # slot i holds absolute position cache_pos + s - S + i
        pos_b = _cache_positions(cache_pos, b, x.device)
        k_pos_idx = pos_b[:, None] + s - S + torch.arange(S, device=x.device)
        valid = k_pos_idx >= 0
        bias = _mask_bias(positions, k_pos_idx, causal=causal, window=window)
        bias = torch.where(valid[:, None, :], bias, NEG_INF)
        out = _sdpa(qg, ck, cv, bias, scale, cap, rules)
    else:
        # decode: write new k/v at cache_pos, attend over (windowed) cache.
        pos_b = _cache_positions(cache_pos, b, x.device)
        ck = _write_at(cache["k"], k, pos_b)
        cv = _write_at(cache["v"], v, pos_b)
        new_cache = {"k": ck, "v": cv}
        take, k_pos_idx = _window_of(ck, pos_b, s, window)
        valid = k_pos_idx < (pos_b[:, None] + s)             # only written slots
        bias = _mask_bias(positions, k_pos_idx, causal=causal, window=window)
        bias = torch.where(valid[:, None, :], bias, NEG_INF)
        out = _sdpa(qg, take(ck), take(cv), bias, scale, cap, rules)

    out = out.reshape(b, s, h, hd)
    y = einsum("bshk,hkd->bsd", out, p["wo"])
    return constrain(y, ("batch", "seq", "embed"), rules), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2/V3) — latent-compressed attention
# ---------------------------------------------------------------------------


def _rms(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    return (xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
            * scale).to(x.dtype)


def _mla_kernel_attention(cfg, p, q_nope, q_rope, c_kv, k_rope, *, causal,
                          window, scale):
    """The cache-free MLA attention through the ``local_attn`` kernel: K
    and V expanded from the latent, every head sharing the rope key; v
    zero-padded to the qk head dim (the kernel takes one D for k and v;
    the wrapper pads all three on to its instantiation), the output sliced
    back.  Returns (b, s, h, v_head_dim)."""
    m = cfg.mla
    b, s, h = q_nope.shape[0], q_nope.shape[1], cfg.n_heads
    k_nope = einsum("btr,rhk->bthk", c_kv, p["wk_b"].to(c_kv.dtype))
    v_exp = einsum("btr,rhk->bthk", c_kv, p["wv_b"].to(c_kv.dtype))
    rope = k_rope[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)
    k_full = torch.cat([k_nope, rope.to(k_nope.dtype)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)              # (b,s,h,qk_hd)
    v_pad = torch.nn.functional.pad(v_exp, (0, m.qk_head_dim - m.v_head_dim))
    out = local_flash_attention(
        q_full.transpose(1, 2), k_full.transpose(1, 2).to(q_full.dtype),
        v_pad.transpose(1, 2).to(q_full.dtype), causal=causal, window=window,
        scale=scale)
    return out.transpose(1, 2)[..., :m.v_head_dim]


def mla_forward(cfg: ModelConfig, p: dict, x, *, positions, window: int,
                causal: bool, rules=None, cache: dict | None = None,
                cache_pos=None, absorb: bool = True):
    """MLA attention.  Cache holds the latent c_kv + shared rope key only
    (the paper-faithful memory saving).  ``absorb=True`` uses the matrix-
    absorption decode trick (scores computed in latent space); ``absorb=
    False`` re-expands K/V.  The cache-free forward runs the kernel on the
    expanded K/V for either value.
    """
    m = cfg.mla
    b, s, _ = x.shape
    scale = m.qk_head_dim ** -0.5
    f32 = torch.float32

    cq = _rms(einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_norm"])
    q = einsum("bsr,rhk->bshk", cq, p["wq_b"])               # (b,s,h,qk_head_dim)
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = _rms(einsum("bsd,dr->bsr", x, p["wkv_a"]), p["kv_norm"])  # (b,s,rank)
    k_rope_new = apply_rope(einsum("bsd,dk->bsk", x, p["wk_rope"]),
                            positions, cfg.rope_theta)       # (b,s,rope_dim)

    if cache is None:
        out = _mla_kernel_attention(cfg, p, q_nope, q_rope, c_kv, k_rope_new,
                                    causal=causal, window=window, scale=scale)
        y = einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
        return constrain(y, ("batch", "seq", "embed"), rules), None

    # cache_pos: scalar or (b,) per-sequence offsets (continuous batching)
    pos_b = _cache_positions(cache_pos, b, x.device)
    c_kv_all = _write_at(cache["c_kv"], c_kv, pos_b)
    k_rope_all = _write_at(cache["k_rope"], k_rope_new, pos_b)
    new_cache = {"c_kv": c_kv_all, "k_rope": k_rope_all}
    take, k_pos_idx = _window_of(c_kv_all, pos_b, s, window)
    c_att, r_att = take(c_kv_all), take(k_rope_all)
    valid = k_pos_idx < (pos_b[:, None] + s)

    bias = _mask_bias(positions, k_pos_idx, causal=causal, window=window)
    bias = torch.where(valid[:, None, :], bias, NEG_INF)[:, None]  # (b,1,s,t)

    cf = c_att.to(f32)
    rf = r_att.to(f32)
    # rope-part scores: every head shares the cached rope key (MQA-like)
    s_rope = torch.einsum("bshk,btk->bhst", q_rope.to(f32), rf)

    if absorb:
        # absorb wk_b into the query: score in latent space, O(t*rank*h)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope.to(f32),
                             p["wk_b"].to(f32))
        s_nope = torch.einsum("bshr,btr->bhst", q_lat, cf)
        w = torch.softmax((s_nope + s_rope) * scale + bias, dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", w, cf)              # (b,s,h,rank)
        out = torch.einsum("bshr,rhk->bshk", o_lat, p["wv_b"].to(f32))
    else:
        # paper-naive: re-expand K and V from the latent for every step
        k_nope = torch.einsum("btr,rhk->bthk", cf, p["wk_b"].to(f32))
        v_exp = torch.einsum("btr,rhk->bthk", cf, p["wv_b"].to(f32))
        s_nope = torch.einsum("bshk,bthk->bhst", q_nope.to(f32), k_nope)
        w = torch.softmax((s_nope + s_rope) * scale + bias, dim=-1)
        out = torch.einsum("bhst,bthk->bshk", w, v_exp)

    y = einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    return constrain(y, ("batch", "seq", "embed"), rules), new_cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    """Per-layer cache (stacked over layers by the caller)."""
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device),
        }
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
