"""Roofline terms of a sharded step, on H100 figures.

    compute term    = FLOPs / (chips * peak_FLOP/s)
    memory term     = HBM_bytes / (chips * HBM_bw)
    collective term = collective_bytes / (chips * link_bw)

The analytic per-device cost model (``analytic_costs``, ``model_flops``)
is the reference's closed forms, copied verbatim: pure Python over the
config, so its numbers equal the reference's.

Collective bytes: the reference parses them from compiled HLO.  PyTorch
has no HLO; here the source is the step itself.  ``collective_bytes``
runs a callable under a dispatch mode that records every
``_c10d_functional`` collective DTensor issues (the redistributions of its
sharding propagation, ``constrain``, the FSDP gathers) with its result's
bytes.  The reference's conventions hold: result-shape bytes, all-reduce
payloads counted twice (ring send + receive), the same five kinds.  Eager
execution runs every layer, so there is no while-body to multiply:
``scan_trip`` is 1.  The gathers ``sharding.mesh_ops`` issues where
DTensor cannot view a sharded dim are not the plan's: they are left out of
``total``, ``by_kind`` and ``counts`` (and so of the collective term) and
reported apart, under ``fallback``.

Hardware model (NVIDIA H100 SXM5, one GPU, dense rates): 989 TFLOP/s bf16,
3.35 TB/s HBM3, 450 GB/s NVLink 4 a direction.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.sharding import mesh_ops

PEAK_FLOPS = 989e12          # bf16 dense, per GPU (NVIDIA H100 SXM5 data sheet)
HBM_BW = 3.35e12             # bytes/s per GPU (H100 SXM5 data sheet, HBM3)
LINK_BW = 450e9              # bytes/s per GPU a direction (NVLink 4: 900 GB/s both ways)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# ``_c10d_functional`` op -> the reference's collective kind
_FUNCTIONAL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensor_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_tensor_bytes(o) for o in out)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Records every functional collective issued while it is active:
    ``by_kind`` bytes a rank and ``counts``, in the reference's kinds;
    those issued inside ``mesh_ops.fallback()`` go to ``fallback_by_kind``
    and ``fallback_counts`` instead."""

    def __init__(self):
        super().__init__()
        self.by_kind = {k: 0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}
        self.fallback_by_kind = {k: 0 for k in _COLLECTIVES}
        self.fallback_counts = {k: 0 for k in _COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        # let DTensor desugar its op into collectives on local tensors
        # first; those come back through this mode
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        ns, _, name = func._overloadpacket._qualified_op_name.partition("::")
        if ns == "_c10d_functional":
            kind = _FUNCTIONAL_KINDS.get(name)
            if kind is not None:
                b = _tensor_bytes(out)
                if kind == "all-reduce":
                    b *= 2               # ring all-reduce moves ~2x the payload
                if mesh_ops.in_fallback():
                    self.fallback_by_kind[kind] += b
                    self.fallback_counts[kind] += 1
                else:
                    self.by_kind[kind] += b
                    self.counts[kind] += 1
        return out

    def summary(self) -> dict:
        return {"total": sum(self.by_kind.values()), "by_kind": dict(self.by_kind),
                "counts": dict(self.counts), "scan_trip": 1,
                "fallback": {"total": sum(self.fallback_by_kind.values()),
                             "by_kind": dict(self.fallback_by_kind),
                             "counts": dict(self.fallback_counts)}}


def collective_bytes(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), summary)``: the collectives ``fn`` issued,
    per rank, as the reference's ``collective_bytes_from_hlo`` reports
    them (``total``, ``by_kind``, ``counts``, ``scan_trip``), and
    ``fallback``, the ``mesh_ops`` gathers, left out of the others."""
    counter = CollectiveCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.summary()


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_dev: float
    bytes_per_dev: float
    collective_bytes_per_dev: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "collective_bytes_per_dev": self.collective_bytes_per_dev,
        }


def roofline_terms(cost: dict, coll: dict) -> RooflineTerms:
    flops = float(cost.get("flops", 0.0) or 0.0)
    bts = float(cost.get("bytes accessed", 0.0) or 0.0)
    cb = float(coll["total"])
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=bts / HBM_BW,
        collective_s=cb / LINK_BW,
        flops_per_dev=flops,
        bytes_per_dev=bts,
        collective_bytes_per_dev=cb,
    )


# ---------------------------------------------------------------------------
# Analytic per-device cost model (primary §Roofline source — see module doc)
# ---------------------------------------------------------------------------


def _attn_flops_per_token(cfg, ctx: float, *, decode: bool = False,
                          mla_absorb: bool = True) -> float:
    """Per-layer attention flops for one token given avg context length."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        m = cfg.mla
        q_proj = 2 * d * m.q_lora_rank + 2 * m.q_lora_rank * h * m.qk_head_dim
        kv_proj = 2 * d * (m.kv_lora_rank + m.qk_rope_head_dim)
        o_proj = 2 * h * m.v_head_dim * d
        if decode and not mla_absorb:
            # paper-naive decode: re-expand K/V from the latent cache for
            # the WHOLE context every step — O(ctx * rank * h * (nope+v))
            expand = 2 * ctx * m.kv_lora_rank * h * (m.qk_nope_head_dim
                                                     + m.v_head_dim)
            sdpa = 4 * h * m.qk_head_dim * ctx
            return q_proj + kv_proj + o_proj + expand + sdpa
        if decode:
            # absorbed: scores/av in latent space, O(ctx * h * rank)
            absorb_q = 2 * h * m.qk_nope_head_dim * m.kv_lora_rank
            scores = 2 * h * (m.kv_lora_rank + m.qk_rope_head_dim) * ctx
            av = 2 * h * m.kv_lora_rank * ctx
            v_up = 2 * h * m.kv_lora_rank * m.v_head_dim
            return q_proj + kv_proj + o_proj + absorb_q + scores + av + v_up
        # train/prefill: K/V expanded once per token (amortized)
        expand = 2 * m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
        sdpa = 4 * h * m.qk_head_dim * ctx
        return q_proj + kv_proj + o_proj + expand + sdpa
    proj = 2 * d * hd * (2 * h + 2 * kv)
    sdpa = 4 * h * hd * ctx
    return proj + sdpa


def _ssm_flops_per_token(cfg) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    g, n, p = s.n_groups, s.d_state, s.head_dim
    conv_dim = di + 2 * g * n
    proj = 2 * d * (2 * di + 2 * g * n + nh) + 2 * di * d
    conv = 2 * s.conv_width * conv_dim
    ssd = 2 * s.chunk_size * (g * n + nh * p) + 4 * nh * p * n
    return proj + conv + ssd


def _ssm_decode_flops_per_token(cfg) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    g, n, p = s.n_groups, s.d_state, s.head_dim
    proj = 2 * d * (2 * di + 2 * g * n + nh) + 2 * di * d
    return proj + 2 * s.conv_width * (di + 2 * g * n) + 6 * nh * p * n


def _rglru_flops_per_token(cfg) -> float:
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    return 4 * d * w + 4 * w * w + 2 * w * d + 10 * w


def _mlp_flops_per_token(d: int, ff: int) -> float:
    return 6 * d * ff


def forward_flops_per_token(cfg, ctx: float, *, decode: bool = False,
                            window: int = 0, mla_absorb: bool = True) -> float:
    """Global fwd flops for one token through all layers (no head)."""
    eff_ctx = min(ctx, window) if window else ctx
    total = 0.0
    if cfg.family == "ssm":
        per = (_ssm_decode_flops_per_token(cfg) if decode
               else _ssm_flops_per_token(cfg))
        return per * cfg.n_layers
    if cfg.family == "hybrid":
        pattern = list(cfg.rglru.block_pattern)
        n_rec = sum(k == "recurrent" for k in pattern)
        n_att = len(pattern) - n_rec
        groups = cfg.n_layers / len(pattern)
        att_ctx = min(ctx, cfg.rglru.attn_window)
        total += groups * n_rec * (_rglru_flops_per_token(cfg)
                                   + _mlp_flops_per_token(cfg.d_model, cfg.d_ff))
        total += groups * n_att * (_attn_flops_per_token(cfg, att_ctx)
                                   + _mlp_flops_per_token(cfg.d_model, cfg.d_ff))
        return total
    # attention stacks (dense / moe / audio / vlm)
    for layer in range(cfg.n_layers):
        total += _attn_flops_per_token(cfg, eff_ctx, decode=decode,
                                       mla_absorb=mla_absorb)
        if cfg.is_moe and layer >= cfg.moe.first_k_dense:
            m = cfg.moe
            total += 2 * cfg.d_model * m.n_routed_experts
            total += (m.top_k * m.capacity_factor + m.n_shared_experts) * \
                _mlp_flops_per_token(cfg.d_model, m.moe_d_ff)
        elif cfg.is_moe:
            total += _mlp_flops_per_token(cfg.d_model, m0_ff(cfg))
        else:
            total += _mlp_flops_per_token(cfg.d_model, cfg.d_ff)
    return total


def m0_ff(cfg) -> int:
    return cfg.moe.effective_dense_d_ff


def analytic_costs(cfg, shape, n_chips: int, mesh_shape: dict, *,
                   remat: str = "full", moment_bytes: int = 4,
                   window_override=None, flash: bool = True,
                   mla_absorb: bool = True) -> dict:
    """Per-device FLOPs and HBM-traffic estimates (documented closed forms).

    Memory-traffic model (per device, per step):
      weights:  N*pb/model_par read per fwd pass (FSDP gather lands in HBM
                once per layer, shared across the data-parallel extent);
                train adds grad writes (f32) + optimizer shard read/write.
      acts:     tokens_dev * d_model * L * c_act * 2B, c_act~12 (block-
                internal reads+writes, flash path); +score matrix traffic
                when the unfused sdpa path materializes (s<=flash threshold).
      decode:   weights read per token + KV-cache read/write per step.
    """

    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    L = cfg.n_layers
    V = cfg.vocab_size
    pb = 2                                     # bf16 params
    model_par = mesh_shape.get("model", 1)
    data_par = n_chips // max(model_par, 1)
    n_params = cfg.n_params()
    n_with_embed = n_params + V * d * (1 if cfg.tie_embeddings else 2)

    window = window_override or cfg.attn_window or 0
    if shape.mode in ("train", "prefill"):
        tokens_global = B * S
        tokens_dev = tokens_global / max(data_par, 1)
        ctx = S / 2                            # causal average
        fwd = forward_flops_per_token(cfg, ctx, window=window) + 2 * d * V
        mult = {"train": 4.0 if remat == "full" else 3.0,
                "prefill": 1.0}[shape.mode]
        if shape.mode == "prefill":
            fwd = forward_flops_per_token(cfg, ctx, window=window)  # head: last pos only
        flops_global = fwd * tokens_global * mult + (
            2 * d * V * B if shape.mode == "prefill" else 0)
        flops_dev = flops_global / n_chips

        w_read = n_with_embed * pb / max(model_par, 1)
        acts = tokens_dev * d * L * 12 * 2
        if not flash and S <= 4096:
            acts += tokens_dev * S * cfg.n_heads / max(model_par, 1) * 4
        if shape.mode == "train":
            passes = 3 if remat == "none" else 4
            opt_shard = n_with_embed / n_chips
            bytes_dev = (w_read * passes
                         + n_with_embed * 4 / n_chips * 2       # grad w+r (f32)
                         + opt_shard * (2 * moment_bytes * 2 + pb * 2)
                         + acts * (2 if remat == "none" else 1.3))
        else:
            bytes_dev = w_read + acts
    else:  # decode
        n_active = cfg.n_active_params()
        ctx = S
        eff_window = window if cfg.family in ("dense", "moe", "vlm") and \
            shape.name == "long_500k" else (window or 0)
        fwd = forward_flops_per_token(cfg, ctx, decode=True,
                                      window=eff_window,
                                      mla_absorb=mla_absorb) + 2 * d * V
        if cfg.is_moe:
            # decode routes real top-k only (capacity ~= top_k at B tokens)
            pass
        flops_global = fwd * B
        flops_dev = flops_global / n_chips

        w_read = (n_active + V * d) * pb / max(model_par, 1)
        # per-device KV traffic: each sequence's cache is read once
        if cfg.family == "ssm":
            s_ = cfg.ssm
            di = s_.expand * d
            cache_per_seq = (di // s_.head_dim) * s_.head_dim * s_.d_state * 4
        elif cfg.family == "hybrid":
            att_layers = L // 3
            cache_per_seq = (att_layers * min(S, cfg.rglru.attn_window)
                             * cfg.n_kv_heads * cfg.head_dim * 2 * 2)
            cache_per_seq += (L - att_layers) * (cfg.rglru.lru_width or d) * 4
        elif cfg.mla is not None:
            cache_per_seq = (min(S, eff_window or S)
                             * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)
                             * 2 * L)
        else:
            cache_per_seq = (min(S, eff_window or S) * cfg.n_kv_heads
                             * cfg.head_dim * 2 * 2 * L)
        bytes_dev = w_read + B * cache_per_seq / n_chips

    return {
        "flops_per_dev": flops_dev,
        "bytes_per_dev": bytes_dev,
        "flops_global": flops_global,
        "tokens_global": (B * S if shape.mode != "decode" else B),
    }


def model_flops(cfg, shape, n_params: int, n_active: int) -> float:
    """6*N*D convention (D = tokens processed globally)."""
    n = n_active if cfg.is_moe else n_params
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens          # forward only
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
