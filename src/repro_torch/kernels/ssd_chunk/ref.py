"""Plain PyTorch version of the ssd_chunk kernel (its oracle and CPU route).

``ssd_intra_chunk_ref`` computes what the kernel computes; the model-level
oracle of the whole chunked scan is ``repro_torch.models.ssm.ssd_chunked``
(the reference's ``ssd_ref``)."""

from __future__ import annotations

import torch

NEG_INF = -2.0**30


def ssd_intra_chunk_ref(xdt, dA, B, C):
    """xdt: (b,c,l,h,p); dA: (b,c,l,h); B, C: (b,c,l,h,n), head-broadcast.
    Returns (y_diag (b,c,l,h,p), states (b,c,h,n,p)) in f32, or in f64
    for f64 inputs (the exact answer the f32 routes are measured from)."""
    dtype = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    xdt, dA, B, C = (t.to(dtype) for t in (xdt, dA, B, C))
    l = dA.shape[2]
    dA_cum = torch.cumsum(dA, dim=2)                               # (b,c,l,h)
    diff = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]     # (b,c,i,j,h)
    tri = torch.ones(l, l, dtype=torch.bool, device=dA.device).tril()
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                              torch.full_like(diff, NEG_INF)))
    scores = torch.einsum("bcihn,bcjhn->bcijh", C, B)
    y = torch.einsum("bcijh,bcjhp->bcihp", scores * L, xdt)
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)        # (b,c,l,h)
    st = torch.einsum("bcjhn,bcjhp->bchnp", B, xdt * decay_states[..., None])
    return y, st
