"""Plain PyTorch version of the local_attn kernel (its oracle and CPU
route): dense masked softmax attention that materializes the scores."""

from __future__ import annotations

import torch

NEG_INF = -2.0**30


def _allowed(S: int, T: int, causal: bool, window: int, device):
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(T, device=device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    return ok


def _probs(q, k, causal, window, scale, dtype):
    """Softmax weights (B, H, S, T) in ``dtype``, k repeated per head."""
    S, T = q.shape[2], k.shape[2]
    s = torch.einsum("bhsd,bhtd->bhst", q.to(dtype), k.to(dtype)) * scale
    s = torch.where(_allowed(S, T, causal, window, q.device), s,
                    torch.full_like(s, NEG_INF))
    return torch.softmax(s, dim=-1)


def _compute_dtype(q):
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def local_attention_ref(q, k, v, *, causal: bool, window: int, scale: float):
    """q: (B, H, S, D); k/v: (B, KV, T, D) -> (B, H, S, D) in q's dtype
    (computed in f32, or in f64 for f64 inputs)."""
    g = q.shape[1] // k.shape[1]
    dtype = _compute_dtype(q)
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    w = _probs(q, k, causal, window, scale, dtype)
    return torch.einsum("bhst,bhtd->bhsd", w, v.to(dtype)).to(q.dtype)


def local_attention_bwd_ref(q, k, v, dout, *, causal: bool, window: int,
                            scale: float):
    """The explicit VJP of ``local_attention_ref`` (the plain version of the
    backward kernels): returns (dq, dk, dv) in the inputs' dtypes, computed
    in f32 (f64 for f64 inputs).  With P the softmax weights,
      dv = sum_g P^T dO,  dP = dO V^T,  delta_s = sum_t P_st dP_st,
      dS = P (dP - delta),  dq = scale dS K,  dk = scale sum_g dS^T Q,
    the sums over a kv head's query heads (GQA) taken per group."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    g = H // KV
    dtype = _compute_dtype(q)
    kh = k.repeat_interleave(g, dim=1).to(dtype)
    vh = v.repeat_interleave(g, dim=1).to(dtype)
    P = _probs(q, kh, causal, window, scale, dtype)
    do = dout.to(dtype)
    dv = torch.einsum("bhst,bhsd->bhtd", P, do)
    dP = torch.einsum("bhsd,bhtd->bhst", do, vh)
    delta = torch.sum(P * dP, dim=-1, keepdim=True)
    dS = P * (dP - delta)
    dq = scale * torch.einsum("bhst,bhtd->bhsd", dS, kh)
    dk = scale * torch.einsum("bhst,bhsd->bhtd", dS, q.to(dtype))
    T = k.shape[2]
    dk = dk.reshape(B, KV, g, T, D).sum(dim=2)
    dv = dv.reshape(B, KV, g, T, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
