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


def ssd_intra_chunk_bwd_ref(xdt, dA, B, C, dy, dstates):
    """The explicit VJP of ``ssd_intra_chunk_ref`` (the plain version of the
    backward kernel): given dy (b,c,l,h,p) and dstates (b,c,h,n,p), returns
    (dxdt, d(dA), dB, dC) in f32, or in f64 for f64 inputs.  Per (b, c,
    head) with cum = cumsum(dA), L_ij = exp(cum_i - cum_j) (i >= j),
    G_ij = C_i.B_j, D_ij = dy_i.xdt_j, w_j = exp(cum_last - cum_j):
      dxdt_j = sum_i L_ij G_ij dy_i + w_j (B_j . dstates)
      dC_i   = sum_j L_ij D_ij B_j
      dB_j   = sum_i L_ij D_ij C_i + w_j (dstates xdt_j)
    dC and dB summed over the heads of a group; M_ij = L_ij G_ij D_ij adds
    to d cum_i and takes from d cum_j, the decay term w_j u_j (u_j =
    xdt_j . (B_j . dstates)) takes from d cum_j and adds to d cum_last,
    and d(dA) is the reverse cumsum of d cum."""
    dtype = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    xdt, dA, B, C, dy, dstates = (t.to(dtype) for t in
                                  (xdt, dA, B, C, dy, dstates))
    b, c, l, h, p = xdt.shape
    g, n = B.shape[3], B.shape[4]
    r = h // g
    cum = torch.cumsum(dA, dim=2)                                  # (b,c,l,h)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]           # (b,c,i,j,h)
    tri = torch.ones(l, l, dtype=torch.bool, device=dA.device).tril()
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                              torch.full_like(diff, NEG_INF)))
    G = torch.einsum("bcign,bcjgn->bcijg", C, B).repeat_interleave(r, dim=-1)
    D = torch.einsum("bcihp,bcjhp->bcijh", dy, xdt)
    PG, PD = L * G, L * D
    w = torch.exp(cum[:, :, -1:, :] - cum)                         # (b,c,l,h)
    Bh = B.repeat_interleave(r, dim=3)                             # (b,c,l,h,n)
    E = torch.einsum("bcjhn,bchnp->bcjhp", Bh, dstates)
    dxdt = torch.einsum("bcijh,bcihp->bcjhp", PG, dy) + w[..., None] * E
    PDg = PD.reshape(b, c, l, l, g, r)
    dC = torch.einsum("bcijgr,bcjgn->bcign", PDg, B)
    dB = (torch.einsum("bcijgr,bcign->bcjgn", PDg, C)
          + (w[..., None] * torch.einsum("bchnp,bcjhp->bcjhn", dstates, xdt))
          .reshape(b, c, l, g, r, n).sum(dim=4))
    M = PG * D
    wu = w * torch.sum(xdt * E, dim=-1)                            # (b,c,l,h)
    dcum = M.sum(dim=3) - M.sum(dim=2) - wu
    dcum[:, :, -1] += wu.sum(dim=2)
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    return dxdt, ddA, dB, dC
