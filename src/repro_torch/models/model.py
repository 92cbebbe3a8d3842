"""LanguageModel: config-driven decoder/encoder over the block stacks.

Covers every family of the reference:
  * text decoders (dense / MoE / SSM / hybrid) — causal LM
  * audio encoder (HuBERT) — bidirectional masked prediction over
    frame embeddings (``frontend_proj``, ``mask_embed``)
  * VLM — stub patch embeddings prepended to the token stream
  * DeepSeek-V3's multi-token prediction head (``mtp_logits``)

The full-sequence forward's attention and SSD run the ``local_attn`` and
``ssd_chunk`` kernels on CUDA; the cached decode step runs neither, as in
the reference.  Parameters keep the reference's tree: a "scan" segment's
leaves are stacked over a leading layer axis (``segments/seg0/b0/...``),
an "unroll" segment's are per block (``segments/seg1/b0/...``), so JAX
parameters load leaf for leaf through ``utils.tree.params_from_numpy``;
the port walks a stacked axis in a Python loop.

``cfg.remat`` is the reference's: each repetition of a "scan" segment
(the whole group of block kinds, carrying ``h`` and ``moe_loss``) runs
under ``torch.utils.checkpoint`` when a gradient is being taken ("full":
only the repetition's inputs are kept and its forward runs again in the
backward; "dots_saveable": the outputs of ``DOTS`` are kept as well and
everything else is recomputed).  "unroll" segments and the MTP block are
never rematerialised, as in the reference; "none", or no gradient being
taken (scoring, decode), walks the layers as they are.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import (
    block_apply,
    block_schema,
    init_block_cache,
    stack_layout,
)
from repro_torch.models.layers import einsum, rmsnorm, rmsnorm_schema
from repro_torch.sharding.logical import (
    ParamSpec,
    Rules,
    constrain,
    init_from_schema,
    schema_shapes,
    specs_from_schema,
    stack_schema,
)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked over a leading layer axis."""
    return tree_map(lambda x: x[i], tree)


def _stack(trees: list):
    """Inverse of ``_layer``: stack per-layer trees on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _layers(mode: str, seg, repeat: int):
    """A segment's per-layer trees: the stacked axis walked ("scan"), or
    the segment itself, once ("unroll")."""
    if mode == "scan":
        return [_layer(seg, li) for li in range(repeat)]
    return [seg]


# "dots_saveable": the ops whose outputs a rematerialised repetition keeps,
# the matmuls that ``torch.einsum`` and ``torch.matmul`` lower to (the
# reference's policy keeps every ``dot_general``).  Everything else is
# recomputed, the ``local_attn`` and ``ssd_chunk`` kernels included: the
# reference's dots would keep their scores, which the kernels never
# materialise.
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
        torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)

REMAT = ("none", "full", "dots_saveable")


def _remat(kind: str):
    """The wrapper that runs one repetition of a "scan" segment under
    ``kind``: ``None`` for "none"."""
    if kind not in REMAT:
        raise ValueError(f"remat {kind!r}; known: {REMAT}")
    if kind == "none":
        return None
    kw = {}
    if kind == "dots_saveable":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(DOTS))
    return functools.partial(checkpoint, use_reentrant=False, **kw)


class LanguageModel:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.layout = stack_layout(cfg)
        self.remat = _remat(cfg.remat)

    # ------------------------------------------------------------------ schema
    def schema(self) -> dict:
        cfg = self.cfg
        sch: dict = {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                               init="embed", scale=0.02),
        }
        if cfg.frontend is not None:
            sch["frontend_proj"] = ParamSpec(
                (cfg.frontend.embed_dim, cfg.d_model), ("frontend_in", "embed"))
            if cfg.family == "audio":
                sch["mask_embed"] = ParamSpec((cfg.d_model,), ("embed",), init="zeros")
        segs = {}
        for si, (mode, kinds, repeat) in enumerate(self.layout):
            group = {f"b{i}": block_schema(cfg, k) for i, k in enumerate(kinds)}
            segs[f"seg{si}"] = (stack_schema(group, repeat) if mode == "scan"
                                else group)
        sch["segments"] = segs
        sch["final_norm"] = rmsnorm_schema(cfg.d_model)
        if not cfg.tie_embeddings:
            sch["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                                    scale=0.02)
        if cfg.mtp_depth:
            sch["mtp"] = {
                "proj": ParamSpec((2 * cfg.d_model, cfg.d_model), ("mtp_in", "embed")),
                "norm_h": rmsnorm_schema(cfg.d_model),
                "norm_e": rmsnorm_schema(cfg.d_model),
                "block": block_schema(
                    cfg, "attn_dense" if cfg.is_moe else "attn_mlp"),
                "final_norm": rmsnorm_schema(cfg.d_model),
            }
        return sch

    def _dtype(self, dtype=None) -> torch.dtype:
        return dtype or getattr(torch, self.cfg.dtype)

    def init(self, generator: torch.Generator, device=None, dtype=None):
        """Random parameters from ``generator`` (drawn on the generator's
        device), placed on ``device`` (CUDA unless the caller says)."""
        return init_from_schema(self.schema(), generator,
                                resolve_device(device), self._dtype(dtype))

    def param_shapes(self):
        return schema_shapes(self.schema(), self._dtype())

    def param_specs(self, rules: Rules):
        return specs_from_schema(self.schema(), rules)

    # ------------------------------------------------------------ embeddings
    def _embed(self, params, tokens):
        table = params["embed"]
        tokens = torch.as_tensor(tokens, device=table.device).long()
        return table[tokens]

    def _embed_inputs(self, params, tokens=None, embeds=None, mask=None,
                      rules=None):
        cfg = self.cfg
        parts = []
        if embeds is not None:
            proj = params["frontend_proj"]
            embeds = torch.as_tensor(embeds, device=proj.device)
            x = einsum("bsf,fd->bsd", embeds.to(proj.dtype), proj)
            if cfg.family == "audio" and mask is not None:
                mask = torch.as_tensor(mask, device=proj.device)
                x = torch.where(mask[..., None],
                                params["mask_embed"].to(x.dtype), x)
            parts.append(x)
        if tokens is not None:
            parts.append(self._embed(params, tokens))
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return constrain(x, ("batch", "seq", "act_embed"), rules)

    # ------------------------------------------------------------- forward
    def forward(self, params, *, tokens=None, embeds=None, mask=None,
                rules=None, window_override=None):
        """Full-sequence forward.  Returns (logits, aux)."""
        cfg = self.cfg
        h = self._embed_inputs(params, tokens, embeds, mask, rules)
        positions = torch.arange(h.shape[1], device=h.device)
        moe_loss = torch.zeros((), dtype=torch.float32, device=h.device)

        def group(layer_p, h, moe_loss, kinds):
            for i, kind in enumerate(kinds):
                h, _, a = block_apply(
                    cfg, kind, layer_p[f"b{i}"], h, positions=positions,
                    rules=rules, window_override=window_override)
                moe_loss = moe_loss + a
            return h, moe_loss

        for si, (mode, kinds, repeat) in enumerate(self.layout):
            run = group
            if (mode == "scan" and self.remat is not None
                    and torch.is_grad_enabled()):
                run = functools.partial(self.remat, group)
            for layer_p in _layers(mode, params["segments"][f"seg{si}"],
                                   repeat):
                h, moe_loss = run(layer_p, h, moe_loss, kinds)

        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = self._head(params, h, rules)
        return logits, {"moe_loss": moe_loss, "hidden": h}

    def _head(self, params, h, rules):
        if self.cfg.tie_embeddings:
            logits = einsum("bsd,vd->bsv", h, params["embed"])
        else:
            logits = einsum("bsd,dv->bsv", h, params["head"])
        return constrain(logits, ("batch", "seq", "vocab"), rules)

    # ------------------------------------------------------------- MTP head
    def mtp_logits(self, params, hidden, next_tokens, rules=None):
        """DeepSeek-V3 multi-token prediction: one extra block over
        [norm(h_i); norm(emb(t_{i+1}))] predicting t_{i+2}."""
        cfg = self.cfg
        p = params["mtp"]
        e = self._embed(params, next_tokens)
        x = torch.cat([rmsnorm(p["norm_h"], hidden, cfg.norm_eps),
                       rmsnorm(p["norm_e"], e, cfg.norm_eps)], dim=-1)
        h = einsum("bse,ed->bsd", x, p["proj"])
        positions = torch.arange(h.shape[1], device=h.device)
        kind = "attn_dense" if cfg.is_moe else "attn_mlp"
        h, _, _ = block_apply(cfg, kind, p["block"], h, positions=positions,
                              rules=rules)
        h = rmsnorm(p["final_norm"], h, cfg.norm_eps)
        return self._head(params, h, rules)

    # ------------------------------------------------------------- decode
    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16,
                    device=None):
        dev = resolve_device(device)
        caches = {}
        for si, (mode, kinds, repeat) in enumerate(self.layout):
            group = {f"b{i}": init_block_cache(self.cfg, k, batch, max_len,
                                               dtype, dev)
                     for i, k in enumerate(kinds)}
            caches[f"seg{si}"] = group if mode != "scan" else tree_map(
                lambda x, repeat=repeat: x[None].repeat(
                    (repeat,) + (1,) * x.dim()), group)
        return caches

    def decode_step(self, params, caches, tokens, pos, *, rules=None,
                    window_override=None, mla_absorb: bool = True):
        """One autoregressive step.  tokens: (b, 1); pos: int index of the
        slot being written, or a (b,) tensor for continuous batching (each
        sequence at its own offset).  Returns (logits, new_caches)."""
        cfg = self.cfg
        h = constrain(self._embed(params, tokens),
                      ("batch", "seq", "act_embed"), rules)
        steps = torch.arange(h.shape[1], device=h.device)
        if getattr(pos, "ndim", 0) == 1:
            pos = torch.as_tensor(pos, device=h.device)
            positions = pos[:, None] + steps                     # (b, s)
        else:
            positions = int(pos) + steps                         # (s,)
        new_caches = {}

        for si, (mode, kinds, repeat) in enumerate(self.layout):
            seg_params = params["segments"][f"seg{si}"]
            seg_cache = caches[f"seg{si}"]
            per_layer = []
            for layer_p, layer_c in zip(_layers(mode, seg_params, repeat),
                                        _layers(mode, seg_cache, repeat),
                                        strict=True):
                new_c = {}
                for i, kind in enumerate(kinds):
                    h, nc, _ = block_apply(
                        cfg, kind, layer_p[f"b{i}"], h, positions=positions,
                        rules=rules, cache=layer_c[f"b{i}"], cache_pos=pos,
                        window_override=window_override,
                        mla_absorb=mla_absorb)
                    new_c[f"b{i}"] = nc
                per_layer.append(new_c)
            new_caches[f"seg{si}"] = (_stack(per_layer) if mode == "scan"
                                      else per_layer[0])

        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        return self._head(params, h, rules), new_caches


def build_model(cfg: ModelConfig) -> LanguageModel:
    return LanguageModel(cfg)
