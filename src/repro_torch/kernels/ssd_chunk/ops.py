"""Public wrappers of the fused intra-chunk SSD.

``ssd_intra_chunk``: CUDA tensors launch ``csrc/ssd_chunk.cu``, CPU tensors
run ``ref.ssd_intra_chunk_ref``.  ``ssd_chunked_fused`` is the whole
chunked scan around it, with the signature and semantics of
``repro_torch.models.ssm.ssd_chunked``:
  x: (b, l, h, p), dt: (b, l, h), A: (h,), B/C: (b, l, g, n)
  -> (y (b, l, h, p), final_state (b, h, p, n))
Pipeline, as the reference's ``ssd_chunked_pallas``: pad to the chunk,
repeat B and C per head, the kernel for (y_diag, chunk states), then the
inter-chunk recurrence and the off-diagonal term in PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref

MAX_N = 128     # SSD_MAX_N in csrc/ssd_chunk.cu
MAX_P = 64      # SSD_MAX_P
launches = 0


def ssd_intra_chunk(xdt, dA, B, C):
    """xdt: (b,c,l,h,p); dA: (b,c,l,h); B, C: (b,c,l,h,n), all f32.
    Returns (y_diag (b,c,l,h,p), states (b,c,h,n,p))."""
    if not build.on_cuda("ssd_chunk", xdt, dA, B, C):
        return ssd_intra_chunk_ref(xdt, dA, B, C)
    global launches
    build.require_f32_contiguous("ssd_chunk", xdt=xdt, dA=dA, B=B, C=C)
    if xdt.dim() != 5:
        raise ValueError("ssd_chunk: xdt must be (b, c, l, h, p)")
    b, c, l, h, p = xdt.shape
    n = B.shape[-1]
    for name, t, want in (("dA", dA, (b, c, l, h)), ("B", B, (b, c, l, h, n)),
                          ("C", C, (b, c, l, h, n))):
        if tuple(t.shape) != want:
            raise ValueError(f"ssd_chunk: {name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
    if n > MAX_N or p > MAX_P:
        raise ValueError(f"ssd_chunk: the kernel takes d_state <= {MAX_N} and "
                         f"head_dim <= {MAX_P}, got n={n}, p={p}")
    y = torch.empty_like(xdt)
    states = torch.empty((b, c, h, n, p), dtype=torch.float32,
                         device=xdt.device)
    if y.numel() == 0:
        return y, states
    status = build.library().ssd_chunk_launch(
        xdt.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(), b, c, l, h,
        p, n, y.data_ptr(), states.data_ptr(), build.stream_handle(xdt.device))
    build.check(status, "ssd_chunk")
    launches += 1
    return y, states


def ssd_chunked_fused(x, dt, A, B, C, chunk: int, init_state=None):
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    L = l + pad
    c = L // chunk
    rep = h // g
    f32 = torch.float32

    xc = x.reshape(b, c, chunk, h, p).to(f32)
    dtc = dt.reshape(b, c, chunk, h).to(f32)
    Bh = B.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3).to(f32)
    Ch = C.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3).to(f32)
    xdt = xc * dtc[..., None]
    dA = dtc * A[None, None, None, :]

    y_diag, states = ssd_intra_chunk(xdt.contiguous(), dA.contiguous(),
                                     Bh.contiguous(), Ch.contiguous())
    states = states.transpose(3, 4)                        # (b,c,h,p,n)

    # inter-chunk recurrence (sequential over c)
    dA_cum = torch.cumsum(dA.permute(0, 3, 1, 2), dim=-1)  # (b,h,c,l)
    chunk_decay = torch.exp(dA_cum[..., -1])               # (b,h,c)
    carry = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for ci in range(c):
        prev.append(carry)                                 # state *before* chunk
        carry = carry * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                 # (b,c,h,p,n)

    # off-diagonal output: prior state flowing into each chunk position
    state_decay_out = torch.exp(dA_cum)                    # (b,h,c,l)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, prev_states,
                         state_decay_out)

    y = (y_diag + y_off).reshape(b, L, h, p)
    return y[:, :l].to(x.dtype), carry.to(x.dtype)
