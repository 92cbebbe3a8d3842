"""Plain PyTorch version of the ewc_update kernel (its oracle and CPU route)."""

from __future__ import annotations

import torch


def ewc_ref(lam, grads, params, anchor, fisher=None):
    """Returns (g + lam*F*(p - a), 0.5*lam*sum F*(p - a)^2); F = 1 when
    ``fisher`` is None."""
    d = params.to(torch.float32) - anchor.to(torch.float32)
    fd = d if fisher is None else fisher.to(torch.float32) * d
    g_out = grads.to(torch.float32) + lam * fd
    loss = 0.5 * lam * torch.sum(fd * d)
    return g_out, loss
