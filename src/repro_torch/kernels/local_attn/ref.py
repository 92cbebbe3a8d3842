"""Plain PyTorch version of the local_attn kernel (its oracle and CPU
route): dense masked softmax attention that materializes the scores."""

from __future__ import annotations

import torch

NEG_INF = -2.0**30


def local_attention_ref(q, k, v, *, causal: bool, window: int, scale: float):
    """q: (B, H, S, D); k/v: (B, KV, T, D) -> (B, H, S, D) in q's dtype."""
    H, S = q.shape[1], q.shape[2]
    KV, T = k.shape[1], k.shape[2]
    g = H // KV
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, v.to(torch.float32)).to(q.dtype)
