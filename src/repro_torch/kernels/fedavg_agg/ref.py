"""Plain PyTorch versions of the fedavg_agg kernels (their oracles and CPU
routes): the fold of a stack, and the fold of N trees' leaves."""

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


def agg_leaves_ref(leaves: list, weights) -> torch.Tensor:
    """leaves[i]: set i's leaves in JAX order; weights: N floats -> the
    weighted sum as one flat f32 vector, leaf by leaf in that order, each
    added in set order 0..N-1 like the kernel (the same sums as ``agg_ref``
    of the flattened stack)."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    out = []
    for l, leaf in enumerate(leaves[0]):
        acc = torch.zeros(leaf.numel(), dtype=torch.float32,
                          device=leaf.device)
        for i, ls in enumerate(leaves):
            acc = acc + ls[l].reshape(-1).to(torch.float32) * w[i]
        out.append(acc)
    if not out:
        return torch.zeros(0, dtype=torch.float32)
    return torch.cat(out)
