"""Plain PyTorch version of the dp_clip_noise kernel (its oracle and CPU
route)."""

from __future__ import annotations

import torch


def dp_clip_noise_ref(delta: torch.Tensor, noise: torch.Tensor, clip,
                      noise_multiplier) -> torch.Tensor:
    """delta, noise: flat (T,).  Clip delta to global L2 norm ``clip``, then
    add Gaussian noise with std ``noise_multiplier * clip``; all in f32:
    ``delta * min(1, clip / max(||delta||, 1e-12)) + noise * sigma``."""
    delta = delta.to(torch.float32)
    clip_t = torch.tensor(clip, dtype=torch.float32, device=delta.device)
    norm = torch.sqrt(torch.sum(delta * delta))
    scale = torch.clamp(clip_t / torch.clamp(norm, min=1e-12), max=1.0)
    sigma = torch.tensor(noise_multiplier, dtype=torch.float32,
                         device=delta.device) * clip_t
    return delta * scale + noise.to(torch.float32) * sigma
