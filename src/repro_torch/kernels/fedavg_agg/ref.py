"""Plain PyTorch version of the fedavg_agg kernel (its oracle and CPU route)."""

from __future__ import annotations

import torch


def agg_ref(stacked: torch.Tensor, weights) -> torch.Tensor:
    """stacked: (N, T); weights: N floats -> (T,) f32 weighted sum, added in
    row order 0..N-1 like the kernel."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    x = stacked.to(torch.float32)
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[0]):
        acc = acc + x[i] * w[i]
    return acc
