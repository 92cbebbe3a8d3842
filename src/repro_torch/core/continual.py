"""Continual learning (paper §II.E): L2-anchor / EWC regularization.

    L_total = L_task + (lambda/2) * sum_i F_i (theta_i - theta*_i)^2

With F_i = 1 this is plain L2-SP; with F_i = running Fisher diagonal it is
online EWC.  ``ewc_adjusted_gradient`` runs the fused penalty + gradient
through ``kernels.ewc_update`` (the CUDA kernel on CUDA tensors).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.ewc_update.ops import ewc_penalty_grad_flat
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class EWCState:
    anchor: object                    # theta* — params after previous task
    fisher: object | None = None      # diagonal Fisher; None -> L2-SP (F=1)
    lam: float = 1.0


def _leaf_terms(params, state: EWCState):
    """Per-leaf (F * d, d) with d = theta - theta*, in f32."""
    fishers = (tree_leaves(state.fisher) if state.fisher is not None
               else [None] * len(tree_leaves(params)))
    out = []
    for p, a, f in zip(tree_leaves(params), tree_leaves(state.anchor),
                       fishers, strict=True):
        d = p.to(torch.float32) - a.to(torch.float32)
        out.append((d if f is None else f.to(torch.float32) * d, d))
    return out


def ewc_penalty(params, state: EWCState):
    """Scalar penalty (lambda/2) * sum F (theta - theta*)^2."""
    return 0.5 * state.lam * sum(torch.sum(fd * d)
                                 for fd, d in _leaf_terms(params, state))


def ewc_penalty_and_grad(params, state: EWCState):
    """Closed-form penalty gradient: lambda * F * (theta - theta*)."""
    if state.fisher is None:
        grads = tree_map(lambda p, a: (state.lam * (p.to(torch.float32)
                                                    - a.to(torch.float32))
                                       ).to(p.dtype), params, state.anchor)
    else:
        grads = tree_map(lambda p, a, f: (state.lam * f.to(torch.float32)
                                          * (p.to(torch.float32)
                                             - a.to(torch.float32))
                                          ).to(p.dtype),
                         params, state.anchor, state.fisher)
    return ewc_penalty(params, state), grads


def fisher_diag_update(fisher, grads, decay: float = 0.95):
    """Online diagonal-Fisher estimate from task gradients (EMA of g^2), in
    f32; ``fisher=None`` returns the squares."""
    sq = tree_map(lambda g: torch.square(g.to(torch.float32)), grads)
    if fisher is None:
        return sq
    return tree_map(lambda f, s: decay * f + (1 - decay) * s, fisher, sq)


def make_anchor(params, fisher=None, lam: float = 1.0) -> EWCState:
    # No copy: the port never updates a parameter tensor in place (every
    # SGD step, fold and anchor builds new tensors), so holding the
    # caller's tree is as safe as the reference's copy of immutable arrays.
    return EWCState(anchor=params, fisher=fisher, lam=lam)


def ewc_adjusted_gradient(grads, params, state: EWCState):
    """Fused task-gradient + penalty-gradient through the ewc_update kernel.

    ``grads``/``params`` and ``state.anchor``/``state.fisher`` are flat 1-D
    tensors in the ``utils.tree.flatten_params`` layout.  Returns
    ``(adjusted_grads, penalty)`` where
    ``adjusted_grads = grads + lam * F * (params - anchor)`` and
    ``penalty = (lam/2) * sum F (params - anchor)^2``."""
    f32 = torch.float32
    return ewc_penalty_grad_flat(
        float(state.lam), grads.to(f32), params.to(f32),
        state.anchor.to(f32),
        None if state.fisher is None else state.fisher.to(f32))
