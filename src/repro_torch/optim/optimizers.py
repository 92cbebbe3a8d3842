"""Optimizers of the reference (``repro.optim.optimizers``) on trees of
tensors: ``opt.init(params) -> state``; ``opt.update(grads, state,
params) -> (updates, state)``; ``apply_updates(params, updates)``.

The numerics are the reference's: updates are f32; ``apply_updates`` adds
in f32 and casts back to each leaf's dtype; moments are kept in
``moment_dtype`` (bf16 halves the optimizer's memory); the step counter
is an int32 tensor; AdamW's bias corrections ``1 - b1**step`` are f32
powers of the f32 step, as ``b1 ** step.astype(f32)`` is in JAX (a Python
float power would round otherwise).  Nothing is updated in place: every
call returns new tensors (clients, the store and anchors share them).
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

f32 = torch.float32


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _to_f32(x):
    """``x.astype(f32)`` as JAX promotes it: f32 for every float leaf."""
    return x.to(torch.promote_types(x.dtype, f32))


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.to(f32) + u).to(p.dtype), params, updates)


def clip_by_global_norm(grads, max_norm: float):
    """(grads * min(1, max_norm / max(norm, 1e-9)), norm): the norm is the
    sqrt of the f32 sums of squares added in leaf order, and the scaled
    leaves come out in f32 (a bf16 leaf times an f32 scalar array, as JAX
    promotes it)."""
    leaves = tree_leaves(grads)
    device = leaves[0].device if leaves else None
    norm = torch.sqrt(torch.as_tensor(
        sum(torch.sum(torch.square(g.to(f32))) for g in leaves), dtype=f32,
        device=device))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: _to_f32(g) * scale, grads), norm


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _step0(params):
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        state = {"step": _step0(params)}
        if momentum:
            state["mu"] = tree_map(lambda p: torch.zeros_like(p, dtype=f32),
                                   params)
        return state

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.to(f32), state["mu"],
                          grads)
            return (tree_map(lambda m: -lr_t * m, mu),
                    {"step": step, "mu": mu})
        return tree_map(lambda g: -lr_t * g.to(f32), grads), {"step": step}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, moment_dtype=f32) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def zeros(p):
        return torch.zeros_like(p, dtype=moment_dtype)

    def init(params):
        return {"step": _step0(params), "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        s = step.to(f32)
        bc1 = 1 - torch.tensor(b1, dtype=f32, device=s.device) ** s
        bc2 = 1 - torch.tensor(b2, dtype=f32, device=s.device) ** s

        m = tree_map(lambda m_, g: (b1 * m_.to(f32) + (1 - b1) * g.to(f32))
                     .to(moment_dtype), state["m"], grads)
        v = tree_map(lambda v_, g: (b2 * v_.to(f32)
                                    + (1 - b2) * torch.square(g.to(f32)))
                     .to(moment_dtype), state["v"], grads)

        def upd(m_, v_, p):
            mh = m_.to(f32) / bc1
            vh = v_.to(f32) / bc2
            u = -lr_t * mh / (torch.sqrt(vh) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.to(f32)
            return u

        return (tree_map(upd, m, v, params),
                {"step": step, "m": m, "v": v})

    return Optimizer(init, update)
