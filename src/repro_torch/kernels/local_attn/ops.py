"""Public wrapper of the windowed flash attention: CUDA tensors launch
``csrc/local_attn.cu``, CPU tensors run ``ref.local_attention_ref``.

As the reference's ``local_flash_attention``, the wrapper pads S and T to
the kernel's tiles and passes the unpadded T as ``t_real``; the kernel
masks the padded keys and the wrapper drops the padded rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.local_attn.ref import local_attention_ref

BLK_Q = 32                      # LA_BQ in csrc/local_attn.cu
BLK_K = 32                      # LA_BK
HEAD_DIMS = (16, 32, 64, 256)   # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0


def local_flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float = 1.0):
    """q: (B, H, S, D); k/v: (B, KV, T, D), f32 or bf16 -> (B, H, S, D) in
    q's dtype.  Arbitrary S/T (padded here)."""
    if not build.on_cuda("local_attn", q, k, v):
        return local_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("local_attn: q, k, v must be (B, H|KV, S|T, D)")
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KV, T, D) or tuple(v.shape) != (B, KV, T, D):
        raise ValueError(f"local_attn: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be {(B, KV, T, D)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"local_attn: q, k, v must share one dtype of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"local_attn: head_dim {D} is not one of the "
                         f"kernel's {HEAD_DIMS}")
    if KV < 1 or H % KV:
        raise ValueError(f"local_attn: {H} query heads over {KV} kv heads")
    if window < 0:
        raise ValueError(f"local_attn: window {window} < 0")
    out_shape = (B, H, S, D)
    if B == 0 or H == 0 or S == 0:
        return q.new_empty(out_shape)
    if T == 0:
        raise ValueError("local_attn: no keys (T = 0)")
    pad_q, pad_k = (-S) % BLK_Q, (-T) % BLK_K
    qp = F.pad(q, (0, 0, 0, pad_q)) if pad_q else q
    kp = F.pad(k, (0, 0, 0, pad_k)) if pad_k else k
    vp = F.pad(v, (0, 0, 0, pad_k)) if pad_k else v
    qp, kp, vp = qp.contiguous(), kp.contiguous(), vp.contiguous()
    out = torch.empty_like(qp)
    status = build.library().local_attn_launch(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(), B, H, KV,
        S + pad_q, T + pad_k, T, D, float(scale), int(bool(causal)),
        int(window), _DTYPES[q.dtype], build.stream_handle(q.device))
    build.check(status, "local_attn")
    launches += 1
    return out[:, :, :S]
