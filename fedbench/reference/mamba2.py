"""Plain reference of a Mamba-2 language model's client update
(arXiv:2405.21060), in the parameter layout the program is given.

The model: token embedding; ``n_layers`` pre-norm residual blocks, each
``h + mixer(rmsnorm(h))``; a final RMSNorm; logits by the tied embedding.
The mixer: one input projection to [z, x, B, C, dt]; a depthwise causal
convolution (width ``conv_width``) with bias and SiLU over [x, B, C];
``dt = softplus(dt + dt_bias)``, ``A = -exp(a_log)``; the selective scan
``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t h_t``, computed
in the paper's chunked form (its Listing 1: the quadratic form inside a
chunk, the state passed between chunks), plus ``D x``; a gated RMSNorm
``rmsnorm(y * silu(z))``; the output projection.  The loss is the mean
next-token cross entropy.  A client's update is ``steps`` AdamW steps from
fresh moments, the gradient first clipped to global norm ``clip``, and the
parameters kept in their own dtypes (the update added in float32, then
rounded).

Plain PyTorch in float32 with TF32 off, one layer at a time under
``torch.utils.checkpoint`` so that a full-width model fits beside the
program's state; imports nothing of the program.  ``precision`` rounds
every product's operands (``reference.precision``) for the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fedbench.reference.precision import rounder

STACKED = "segments"
MIXER = ("a_log", "conv_b", "conv_w", "d_skip", "dt_bias", "norm", "w_in",
         "w_out")


def leaf_slices(tree: dict, n_layers: int) -> list:
    """``[(name, tensor)]``: the tree's leaves in sorted-key order, every
    leaf stacked over the layers split into its ``n_layers`` slices."""
    out = []

    def go(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                go(node[k], f"{path}/{k}" if path else k)
            return
        if path.startswith(STACKED):
            if node.shape[0] != n_layers:
                raise ValueError(f"{path}: {node.shape[0]} layers stacked, "
                                 f"expected {n_layers}")
            out.extend((f"{path}[{i}]", node[i]) for i in range(n_layers))
        else:
            out.append((path, node))

    go(tree, "")
    return out


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def _segsum(x):
    """(..., l) -> (..., l, l): sum of x[j+1..i] below the diagonal, -inf
    above it."""
    l = x.shape[-1]
    cs = torch.cumsum(x, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~keep, -math.inf)


def _ssd(x, dt, A, B, C, chunk, q):
    """x (b, l, h, p), dt (b, l, h), A (h,), B, C (b, l, g, n) ->
    y (b, l, h, p); l a multiple of ``chunk``."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    c = l // chunk
    rep = h // g
    xd = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    a = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)   # (b,h,c,L)
    a_cum = torch.cumsum(a, -1)
    Bc = B.reshape(b, c, chunk, g, n)
    Cc = C.reshape(b, c, chunk, g, n)
    # inside a chunk: (C_i . B_j) exp(a_{j+1} + ... + a_i) dt_j x_j, j <= i
    cb = torch.einsum("bclgn,bcsgn->bcgls", q(Cc), q(Bc))
    cb = cb.repeat_interleave(rep, dim=2)                     # (b,c,h,L,L)
    m = cb * torch.exp(_segsum(a)).permute(0, 2, 1, 3, 4)
    y = torch.einsum("bchls,bcshp->bclhp", q(m), q(xd))
    # each chunk's final state from its own inputs
    decay = torch.exp(a_cum[..., -1:] - a_cum)                 # (b,h,c,L)
    Bh = Bc.repeat_interleave(rep, dim=3)                      # (b,c,L,h,n)
    bw = Bh * decay.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bclhn,bclhp->bchpn", q(bw), q(xd))
    # the states carried between chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    ends = F.pad(a_cum[..., -1], (1, 0))                       # (b,h,c+1)
    carry = torch.exp(_segsum(ends))                           # (b,h,c+1,c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", q(carry), q(states))[:, :-1]
    Ch = Cc.repeat_interleave(rep, dim=3)                      # (b,c,L,h,n)
    y_off = torch.einsum("bclhn,bchpn->bclhp", q(Ch), q(states))
    y_off = y_off * torch.exp(a_cum).permute(0, 2, 3, 1)[..., None]
    return (y + y_off).reshape(b, l, h, p)


def _block(h, scale, lp, cfg, q):
    d_inner = cfg["expand"] * cfg["d_model"]
    nh = d_inner // cfg["head_dim"]
    g, n = cfg["n_groups"], cfg["d_state"]
    eps = cfg["norm_eps"]
    b, l, _ = h.shape
    x = _rmsnorm(h, scale, eps)
    zxbcdt = q(x) @ q(lp["w_in"])
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * g * n, nh], -1)
    w = lp["conv_w"]                                           # (cw, conv)
    cw = w.shape[0]
    xp = F.pad(xbc, (0, 0, cw - 1, 0))
    conv = sum(xp[:, i:i + l] * w[i] for i in range(cw))
    xbc = F.silu(conv + lp["conv_b"])
    xs, B, C = torch.split(xbc, [d_inner, g * n, g * n], -1)
    dt = F.softplus(dt + lp["dt_bias"])
    A = -torch.exp(lp["a_log"])
    xh = xs.reshape(b, l, nh, cfg["head_dim"])
    y = _ssd(xh, dt, A, B.reshape(b, l, g, n), C.reshape(b, l, g, n),
             cfg["chunk_size"], q)
    y = (y + xh * lp["d_skip"][:, None]).reshape(b, l, d_inner)
    y = _rmsnorm(y * F.silu(z), lp["norm"], eps)
    return h + q(y) @ q(lp["w_out"])


def loss_and_grads(leaves: list, tokens, labels, cfg, precision="float32"):
    """Mean next-token cross entropy and its gradient by every slice of
    ``leaves`` (``leaf_slices``' names and float32 tensors)."""
    q = rounder(precision)
    live = [(k, v.detach().float().requires_grad_()) for k, v in leaves]
    by = dict(live)
    n_layers = cfg["n_layers"]
    pre = f"{STACKED}/seg0/b0"
    tokens = torch.as_tensor(tokens, device=live[0][1].device).long()
    labels = torch.as_tensor(labels, device=tokens.device).long()
    h = by["embed"][tokens]
    for i in range(n_layers):
        lp = {k: by[f"{pre}/mixer/{k}[{i}]"] for k in MIXER}
        h = checkpoint(_block, h, by[f"{pre}/norm/scale[{i}]"], lp, cfg, q,
                       use_reentrant=False)
    h = _rmsnorm(h, by["final_norm/scale"], cfg["norm_eps"])
    logits = q(h) @ q(by["embed"]).T
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))
    grads = torch.autograd.grad(loss, [v for _, v in live])
    return loss.detach(), list(grads)


def client_update(leaves: list, batches: list, cfg: dict, lr: float,
                  clip: float, b1=0.9, b2=0.999, eps=1e-8,
                  precision="float32", half_batch=False):
    """AdamW steps from fresh moments over ``batches``.  ``leaves``:
    ``leaf_slices`` of the start parameters, each kept in its own dtype.
    Returns (losses, the first step's clipped gradient by slice, the final
    slices in their dtypes).  ``half_batch`` plants a fault: each step sees
    the first half of its rows, the mean taken over them."""
    dtypes = [v.dtype for _, v in leaves]
    p = [v.detach().float() for _, v in leaves]
    names = [k for k, _ in leaves]
    m = [torch.zeros_like(x) for x in p]
    v = [torch.zeros_like(x) for x in p]
    losses, first = [], None
    for t, (tokens, labels) in enumerate(batches, start=1):
        if half_batch:
            keep = max(1, len(tokens) // 2)
            tokens, labels = tokens[:keep], labels[:keep]
        loss, g = loss_and_grads(list(zip(names, p)), tokens, labels, cfg,
                                 precision)
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        scale = torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0)
        g = [x * scale for x in g]
        if first is None:
            first = g
        m = [b1 * mi + (1 - b1) * gi for mi, gi in zip(m, g)]
        v = [b2 * vi + (1 - b2) * gi * gi for vi, gi in zip(v, g)]
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        p = [(pi - lr * (mi / c1) / (torch.sqrt(vi / c2) + eps)).to(dt).float()
             for pi, mi, vi, dt in zip(p, m, v, dtypes)]
        losses.append(loss)
    return losses, first, [x.to(dt) for x, dt in zip(p, dtypes)]
