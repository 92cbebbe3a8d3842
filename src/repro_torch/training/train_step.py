"""Train and eval steps of the language models.

``build_train_step`` closes over (model, optimizer, rules) and returns
``train_step(state, batch) -> (state, metrics)``, as the reference's
(``repro.training.train_step``): the loss's gradient by autograd (through
the ``ssd_chunk`` and ``local_attn`` kernels' backward kernels on CUDA,
their plain versions on the CPU), optional microbatching, clipping by the
global norm, the optimizer's update.  Parameters are never updated in
place: each step returns a new tree.

With ``ewc=`` the anchor term ``(lam/2) sum F (theta - theta*)^2`` is not
differentiated by autograd: its gradient is added to the task gradient by
``core.continual.ewc_adjusted_gradient`` over the flat layout (one
``ewc_update`` launch a step on CUDA), which also returns the penalty, and
the reported loss is task + penalty, as the reference's autodiff of
``loss + ewc_penalty`` gives.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.continual import EWCState, ewc_adjusted_gradient
from repro_torch.optim.optimizers import (
    Optimizer,
    apply_updates,
    clip_by_global_norm,
)
from repro_torch.training.losses import loss_for_batch
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import (
    flatten_params,
    tree_leaves,
    tree_map,
    unflatten_params,
)

f32 = torch.float32


@dataclass
class TrainState:
    params: object
    opt_state: object


def _split(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches along the leading axis, as the reference's
    reshape to (n, b // n, ...)."""
    out = [{} for _ in range(n)]
    for key, x in batch.items():
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not split into "
                             f"{n} microbatches")
        for i, part in enumerate(x.reshape((n, x.shape[0] // n)
                                           + tuple(x.shape[1:]))):
            out[i][key] = part
    return out


def build_train_step(model, cfg: ModelConfig, optimizer: Optimizer, *,
                     rules=None, grad_clip: float = 1.0,
                     ewc: EWCState | None = None,
                     n_microbatches: int | None = None):
    """n_microbatches: gradient accumulation over n sequential microbatches
    (the reference's ``lax.scan``): f32 gradients summed and divided by n,
    loss and metrics averaged."""
    flat_anchor = None
    if ewc is not None:
        flat_anchor = EWCState(
            flatten_params(ewc.anchor),
            None if ewc.fisher is None else flatten_params(ewc.fisher),
            ewc.lam)

    def grads_of(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = loss_for_batch(model, cfg, live, batch, rules)
        # a leaf the loss does not reach (DeepSeek-V3's router_bias, which
        # only selects experts) gets zeros, as JAX's gradient gives it
        grads = _refill(params, iter(torch.autograd.grad(
            loss, tree_leaves(live), allow_unused=True,
            materialize_grads=True)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def train_step(state: TrainState, batch: dict):
        params = state.params
        n = n_microbatches or 1
        if n > 1:
            gsum = lsum = None
            stacks = {}
            for mb in _split(batch, n):
                loss, metrics, g = grads_of(params, mb)
                g = tree_map(lambda x: x.to(f32), g)
                gsum = g if gsum is None else tree_map(torch.add, gsum, g)
                lsum = loss if lsum is None else lsum + loss
                for k, v in metrics.items():
                    stacks.setdefault(k, []).append(v)
            grads = tree_map(lambda x: x / n, gsum)
            loss = lsum / n
            metrics = {k: torch.stack(v).mean() for k, v in stacks.items()}
        else:
            loss, metrics, grads = grads_of(params, batch)

        if flat_anchor is not None:
            g_flat, penalty = ewc_adjusted_gradient(
                torch.cat([g.reshape(-1).to(f32) for g in tree_leaves(grads)]),
                flatten_params(params), flat_anchor)
            grads = unflatten_params(g_flat, tree_map(
                lambda g: torch.empty(g.shape, dtype=f32, device="meta"),
                grads))
            loss = loss + penalty

        if grad_clip:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            metrics = dict(metrics, grad_norm=gnorm)
        updates, new_opt = optimizer.update(grads, state.opt_state, params)
        new_params = apply_updates(params, updates)
        metrics = dict(metrics, loss=loss)
        return TrainState(new_params, new_opt), metrics

    return train_step


def _refill(template, leaves):
    """``template``'s tree with its leaves replaced, in JAX's order, by
    ``leaves``; the template's key order kept."""
    if isinstance(template, dict):
        built = {k: _refill(template[k], leaves) for k in sorted(template)}
        return {k: built[k] for k in template}
    return next(leaves)


def build_eval_step(model, cfg: ModelConfig, *, rules=None):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_for_batch(model, cfg, params, batch, rules)
        return dict(metrics, loss=loss)

    return eval_step


def init_train_state(model, optimizer: Optimizer, generator: torch.Generator,
                     device=None) -> TrainState:
    """Random parameters from ``generator`` on ``device`` (CUDA unless the
    caller says) and the optimizer's initial state."""
    params = model.init(generator, resolve_device(device))
    return TrainState(params, optimizer.init(params))
