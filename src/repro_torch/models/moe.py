"""Mixture-of-Experts layer: shared + routed experts, top-k routing with a
capacity-based gather/scatter dispatch (GShard/Switch style).

Dispatch computes E × C × d × ff where E*C ≈ tokens * top_k *
capacity_factor, i.e. proportional to *active* compute, as in the
reference.  The expert products are batched matmuls (``torch.einsum``);
the reference computes them outside any Pallas kernel too.

Two points where the port spells out what XLA leaves to its scatter:

- The reference writes a dropped (token, k) to ``expert * C + C``, which
  for every expert but the last is the next expert's slot 0 (only the last
  expert's lands in the dump slot ``E * C``).  XLA applies duplicate
  scatter writes in update order, so the last write wins; the port picks
  the same winner (the largest flat index of the writers of each slot)
  with an order-free ``amax``, so the CPU and CUDA dispatch equal the
  reference's whether or not a slot collides.
- On a ``DeviceMesh`` (DTensor ids) the router's bookkeeping -- the
  per-expert count and ``dispatch`` -- runs under one ``local_map`` on
  replicated ids (``_bookkeeping_on_mesh``): every rank routes the whole
  batch, as the reference's.  DTensor has no sharding rule for
  ``bincount`` or ``searchsorted``; the count there is ``expert_counts``, a
  ``scatter_add`` of ones that also runs on the dry-run's ``meta`` shards
  and equals ``bincount`` bit for bit (integer sums are exact in f32 below
  2^24).
- The experts' outputs go back to their tokens by a gather of each
  token's K slots, summed one slot at a time in the order of their slot
  index (expert ascending), the order of the reference's scatter-add.  No
  ``index_add_``: its float atomics on CUDA would change the order of each
  token's sum from run to run.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation, einsum
from repro_torch.models.mlp import mlp_forward, mlp_schema
from repro_torch.sharding.logical import ParamSpec, constrain


def moe_schema(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    sch = {
        "router": ParamSpec((d, m.n_routed_experts), ("embed", "expert"), scale=0.02),
        "experts": {
            "w_gate": ParamSpec((m.n_routed_experts, d, m.moe_d_ff), ("expert", "embed", "expert_mlp")),
            "w_up": ParamSpec((m.n_routed_experts, d, m.moe_d_ff), ("expert", "embed", "expert_mlp")),
            "w_down": ParamSpec((m.n_routed_experts, m.moe_d_ff, d), ("expert", "expert_mlp", "embed")),
        },
    }
    if m.n_shared_experts:
        sch["shared"] = mlp_schema(d, m.moe_d_ff * m.n_shared_experts)
    if m.score_func == "sigmoid":
        sch["router_bias"] = ParamSpec((m.n_routed_experts,), ("expert",), init="zeros",
                                       dtype="float32")
    return sch


def _capacity(n_tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    cap = int(n_tokens * top_k * factor / n_experts)
    cap = max(cap, top_k, 4)
    return min(cap, n_tokens)


def route(cfg: ModelConfig, p: dict, xt):
    """Router of ``xt`` (T, d): (scores (T, E) f32, selected experts
    (T, K), gate weights (T, K) f32), as the reference's: top-k of the
    biased scores, gates from the unbiased ones."""
    m = cfg.moe
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    if m.score_func == "sigmoid":
        scores = torch.sigmoid(logits)
        sel_scores = scores + p["router_bias"]   # aux-loss-free biasing (DSv3)
    else:
        scores = torch.softmax(logits, dim=-1)
        sel_scores = scores
    _, top_e = torch.topk(sel_scores, m.top_k, dim=-1)        # (T, K)
    gate_w = torch.gather(scores, -1, top_e)     # gate from unbiased scores
    if m.score_func == "sigmoid":
        gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return scores, top_e, gate_w * m.routed_scaling


def dispatch(flat_e, n_experts: int, capacity: int):
    """The capacity dispatch of the flat (token, k) expert ids (T*K,):
    (kept mask, the slot each entry writes, the winning writer of each of
    the E*C slots or -1).  An entry's rank inside its expert's buffer comes
    from a stable sort, as the reference's."""
    n = flat_e.shape[0]
    dev = flat_e.device
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=dev), side="left")
    rank_sorted = torch.arange(n, device=dev) - group_start[sorted_e]
    pos_in_expert = torch.empty_like(rank_sorted)
    pos_in_expert[order] = rank_sorted
    keep = pos_in_expert < capacity                    # dropped beyond capacity
    # overflow -> "dump" slot expert * C + C (see the module docstring)
    slot = flat_e * capacity + torch.where(keep, pos_in_expert, capacity)
    winner = torch.full((n_experts * capacity + 1,), -1, dtype=torch.long,
                        device=dev)
    winner = winner.scatter_reduce(0, slot, torch.arange(n, device=dev),
                                   reduce="amax", include_self=True)
    return keep, slot, winner[:n_experts * capacity]


def expert_counts(flat_e, n_experts: int):
    """``torch.bincount(flat_e, minlength=n_experts)`` as f32, by a
    ``scatter_add`` of ones (an op ``meta`` tensors also run)."""
    ones = torch.ones(flat_e.shape, dtype=torch.float32, device=flat_e.device)
    return torch.zeros(n_experts, dtype=torch.float32,
                       device=flat_e.device).scatter_add_(0, flat_e, ones)


def _bookkeeping_on_mesh(flat_e, n_experts: int, capacity: int):
    """(counts, keep, slot, winner) of DTensor ids, replicated on every
    mesh dim and computed shard by shard through ``local_map``."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = flat_e.device_mesh
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    run = local_map(
        lambda e: (expert_counts(e, n_experts), *dispatch(e, n_experts,
                                                          capacity)),
        out_placements=(rep,) * 4, in_placements=(rep,), device_mesh=mesh)
    return run(flat_e.redistribute(mesh, rep))


def moe_forward(cfg: ModelConfig, p: dict, x, rules=None):
    """x: (b, s, d) -> (y, aux_loss)."""
    m = cfg.moe
    b, s, d = x.shape
    T = b * s
    E, K = m.n_routed_experts, m.top_k
    C = _capacity(T, K, E, m.capacity_factor)
    dev = x.device

    xt = x.reshape(T, d)
    scores, top_e, gate_w = route(cfg, p, xt)

    # ---- load-balance auxiliary loss (Switch-style) -----------------------
    flat_e = top_e.reshape(-1)                                     # (T*K,)
    if hasattr(flat_e, "device_mesh"):
        counts, keep, slot, winner = _bookkeeping_on_mesh(flat_e, E, C)
    else:
        counts = torch.bincount(flat_e, minlength=E).to(torch.float32)
        keep, slot, winner = dispatch(flat_e, E, C)
    tokens_per_expert = counts / (T * K)                           # fraction
    router_prob = scores.mean(0)
    aux_loss = m.router_aux_coef * E * torch.sum(tokens_per_expert * router_prob)

    # ---- capacity-based dispatch ------------------------------------------
    flat_w = gate_w.reshape(-1)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(K)
    src = torch.clamp(winner, min=0)
    dispatch_valid = (winner >= 0) & keep[src]
    dispatch_tok = torch.where(dispatch_valid, flat_tok[src], 0)
    dispatch_w = torch.where(dispatch_valid, flat_w[src], 0.0)

    xe = xt[dispatch_tok].reshape(E, C, d)                         # (E, C, d)
    xe = xe * dispatch_valid.reshape(E, C, 1).to(xe.dtype)
    xe = constrain(xe, ("expert", "cap", "embed"), rules)

    act = activation(cfg.mlp_activation)
    ew = p["experts"]
    h = act(einsum("ecd,edf->ecf", xe, ew["w_gate"])) * einsum(
        "ecd,edf->ecf", xe, ew["w_up"])
    h = constrain(h, ("expert", "cap", "expert_mlp"), rules)
    ye = einsum("ecf,efd->ecd", h, ew["w_down"])                   # (E, C, d)
    ye = (ye * dispatch_w.reshape(E, C, 1).to(ye.dtype)).reshape(E * C, d)

    # back to the tokens: each token's K slots, in slot order; an entry
    # whose slot another write took (or that was dropped) adds nothing, as
    # the reference's invalid slots add zeros
    slot_tk = slot.reshape(T, K)
    mine = (keep & (winner[torch.clamp(slot, max=E * C - 1)]
                    == torch.arange(T * K, device=dev))).reshape(T, K)
    slot_tk, by_slot = torch.sort(torch.where(mine, slot_tk, E * C), dim=-1)
    mine = torch.gather(mine, -1, by_slot)
    parts = ye[torch.clamp(slot_tk, max=E * C - 1)]              # (T, K, d)
    parts = torch.where(mine[..., None], parts, torch.zeros_like(parts))
    y = parts[:, 0]
    for j in range(1, K):
        y = y + parts[:, j]

    if m.n_shared_experts:
        y = y + mlp_forward(p["shared"], xt[None], cfg.mlp_activation, rules)[0]

    return y.reshape(b, s, d), aux_loss.to(torch.float32)
