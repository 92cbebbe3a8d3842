"""Shared low-level layers: RMSNorm, RoPE, activations, softcap.

``einsum`` promotes mixed operand dtypes as JAX does (bf16 with f32 gives
f32); ``torch.einsum`` itself refuses mixed dtypes.  An einsum with a
sharded DTensor operand goes to ``sharding.mesh_ops.einsum``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import mesh_ops
from repro_torch.sharding.logical import ParamSpec


def einsum(eq: str, *operands) -> torch.Tensor:
    dtype = operands[0].dtype
    for x in operands[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    operands = [x.to(dtype) for x in operands]
    if any(mesh_ops.is_sharded(x) for x in operands):
        return mesh_ops.einsum(eq, operands)
    return torch.einsum(eq, *operands)


def rmsnorm_schema(dim: int, name: str = "scale") -> dict:
    return {name: ParamSpec((dim,), ("embed",), init="ones", dtype="float32")}


def rmsnorm(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    raise ValueError(name)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (b, seq, heads, head_dim) or (b, seq, head_dim);
    positions: (seq,) shared, or (b, seq) per-sequence (continuous
    batching: each request at its own decode offset)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)              # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs
    if x.dim() == 4:                                           # heads axis present
        angles = angles[..., :, None, :]                       # (..., seq, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits, cap: float):
    if not cap:
        return logits
    return torch.tanh(logits / cap) * cap
