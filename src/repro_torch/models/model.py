"""LanguageModel: config-driven decoder over the block stacks.

The port covers the text decoders of the dense (GQA/MQA) and SSM families
(gemma-2b, mamba2-370m and the other dense configs): the full-sequence
forward, whose attention and SSD run the ``local_attn`` and ``ssd_chunk``
kernels on CUDA, and the cached decode step.  Parameters keep the
reference's tree: a scan segment's leaves are stacked over a leading layer
axis (``segments/seg0/b0/...``), so JAX parameters load leaf for leaf
through ``utils.tree.params_from_numpy``; the port walks that axis in a
Python loop.  Frontends (audio, VLM), MTP and the MoE and hybrid families
raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import NOT_PORTED
from repro_torch.models.blocks import (
    block_apply,
    block_schema,
    init_block_cache,
    stack_layout,
)
from repro_torch.models.layers import einsum, rmsnorm, rmsnorm_schema
from repro_torch.sharding.logical import (
    ParamSpec,
    constrain,
    init_from_schema,
    schema_shapes,
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


class LanguageModel:
    def __init__(self, cfg: ModelConfig):
        if cfg.frontend is not None or cfg.mtp_depth:
            raise NotImplementedError(
                f"{cfg.name}: frontends and MTP are {NOT_PORTED}")
        self.cfg = cfg
        self.layout = stack_layout(cfg)

    # ------------------------------------------------------------------ schema
    def schema(self) -> dict:
        cfg = self.cfg
        sch: dict = {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                               init="embed", scale=0.02),
        }
        segs = {}
        for si, (_mode, kinds, repeat) in enumerate(self.layout):
            group = {f"b{i}": block_schema(cfg, k) for i, k in enumerate(kinds)}
            segs[f"seg{si}"] = stack_schema(group, repeat)
        sch["segments"] = segs
        sch["final_norm"] = rmsnorm_schema(cfg.d_model)
        if not cfg.tie_embeddings:
            sch["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                                    scale=0.02)
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

    # ------------------------------------------------------------- forward
    def _embed(self, params, tokens):
        table = params["embed"]
        tokens = torch.as_tensor(tokens, device=table.device).long()
        return table[tokens]

    def forward(self, params, *, tokens=None, embeds=None, mask=None,
                rules=None, window_override=None):
        """Full-sequence forward.  Returns (logits, aux)."""
        if embeds is not None or tokens is None:
            raise NotImplementedError(f"embedding inputs are {NOT_PORTED}")
        cfg = self.cfg
        h = constrain(self._embed(params, tokens),
                      ("batch", "seq", "act_embed"), rules)
        positions = torch.arange(h.shape[1], device=h.device)
        moe_loss = torch.zeros((), dtype=torch.float32, device=h.device)

        for si, (_mode, kinds, repeat) in enumerate(self.layout):
            seg_params = params["segments"][f"seg{si}"]
            for li in range(repeat):
                layer_p = _layer(seg_params, li)
                for i, kind in enumerate(kinds):
                    h, _, a = block_apply(
                        cfg, kind, layer_p[f"b{i}"], h, positions=positions,
                        rules=rules, window_override=window_override)
                    moe_loss = moe_loss + a

        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = self._head(params, h, rules)
        return logits, {"moe_loss": moe_loss, "hidden": h}

    def _head(self, params, h, rules):
        if self.cfg.tie_embeddings:
            logits = einsum("bsd,vd->bsv", h, params["embed"])
        else:
            logits = einsum("bsd,dv->bsv", h, params["head"])
        return constrain(logits, ("batch", "seq", "vocab"), rules)

    # ------------------------------------------------------------- decode
    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16,
                    device=None):
        dev = resolve_device(device)
        caches = {}
        for si, (_mode, kinds, repeat) in enumerate(self.layout):
            group = {f"b{i}": init_block_cache(self.cfg, k, batch, max_len,
                                               dtype, dev)
                     for i, k in enumerate(kinds)}
            caches[f"seg{si}"] = tree_map(
                lambda x, repeat=repeat: x[None].repeat(
                    (repeat,) + (1,) * x.dim()), group)
        return caches

    def decode_step(self, params, caches, tokens, pos, *, rules=None,
                    window_override=None):
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

        for si, (_mode, kinds, repeat) in enumerate(self.layout):
            seg_params = params["segments"][f"seg{si}"]
            seg_cache = caches[f"seg{si}"]
            per_layer = []
            for li in range(repeat):
                layer_p, layer_c = _layer(seg_params, li), _layer(seg_cache, li)
                new_c = {}
                for i, kind in enumerate(kinds):
                    h, nc, _ = block_apply(
                        cfg, kind, layer_p[f"b{i}"], h, positions=positions,
                        rules=rules, cache=layer_c[f"b{i}"], cache_pos=pos,
                        window_override=window_override)
                    new_c[f"b{i}"] = nc
                per_layer.append(new_c)
            new_caches[f"seg{si}"] = _stack(per_layer)

        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        return self._head(params, h, rules), new_caches


def build_model(cfg: ModelConfig) -> LanguageModel:
    return LanguageModel(cfg)
