"""Plain PyTorch version of the ssd_chunk kernel (its oracle and CPU route).

``ssd_intra_chunk_ref`` computes what the kernel computes; the model-level
oracle of the whole chunked scan is ``repro_torch.models.ssm.ssd_chunked``
(the reference's ``ssd_ref``)."""

from __future__ import annotations

import torch

NEG_INF = -2.0**30


def ssd_intra_chunk_ref(xdt, dA, B, C):
    """xdt: (b,c,l,h,p); dA: (b,c,l,h); B, C: (b,c,l,g,n), head hi reading
    group hi // (h // g) (g == h: the head-broadcast layout).
    Returns (y_diag (b,c,l,h,p), states (b,c,h,n,p)) in f32, or in f64
    for f64 inputs (the exact answer the f32 routes are measured from)."""
    dtype = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    xdt, dA, B, C = (t.to(dtype) for t in (xdt, dA, B, C))
    b, c, l, h, p = xdt.shape
    g, n = B.shape[3], B.shape[4]
    r = h // g
    dA_cum = torch.cumsum(dA, dim=2)                               # (b,c,l,h)
    diff = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]     # (b,c,i,j,h)
    tri = torch.ones(l, l, dtype=torch.bool, device=dA.device).tril()
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                              torch.full_like(diff, NEG_INF)))
    scores = torch.einsum("bcign,bcjgn->bcijg", C, B)              # per group
    scores = scores.repeat_interleave(r, dim=-1)                   # per head
    y = torch.einsum("bcijh,bcjhp->bcihp", scores * L, xdt)
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)        # (b,c,l,h)
    xs = (xdt * decay_states[..., None]).reshape(b, c, l, g, r, p)
    st = torch.einsum("bcjgn,bcjgrp->bcgrnp", B, xs)
    return y, st.reshape(b, c, h, n, p)
