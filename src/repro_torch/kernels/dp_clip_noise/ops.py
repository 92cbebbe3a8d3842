"""Public wrapper of the DP clip + noise release: CUDA tensors launch
``csrc/dp_clip_noise.cu``, CPU tensors run ``ref.dp_clip_noise_ref``.

This is the client-side privatization step: ``repro_torch.privacy.dp``
flattens an update delta, privatizes it here with caller-supplied
standard-normal noise, and unflattens it back into the parameter tree.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dp_clip_noise.ref import dp_clip_noise_ref

MAX_BLOCKS = 1024    # DP_MAX_BLOCKS in csrc/dp_clip_noise.cu (partials)
launches = 0


def privatize_flat(delta: torch.Tensor, noise: torch.Tensor, clip,
                   noise_multiplier) -> torch.Tensor:
    """delta, noise: flat (T,) f32 on one device; returns the privatized
    (T,) f32 ``delta * min(1, clip/||delta||) + (noise_multiplier * clip) *
    noise``.  On CUDA the norm and both scalars stay on the device, so
    nothing waits for the card."""
    if not build.on_cuda("dp_clip_noise", delta, noise):
        return dp_clip_noise_ref(delta, noise, clip, noise_multiplier)
    global launches
    build.require_f32_contiguous("dp_clip_noise", delta=delta, noise=noise)
    if delta.dim() != 1 or noise.shape != delta.shape:
        raise ValueError(f"dp_clip_noise: delta {tuple(delta.shape)} and "
                         f"noise {tuple(noise.shape)} must be the same flat "
                         "(T,) shape")
    out = torch.empty_like(delta)
    t = delta.numel()
    if t == 0:
        return out
    scratch = torch.empty(MAX_BLOCKS + 2, dtype=torch.float32,
                          device=delta.device)
    status = build.library().dp_clip_noise_launch(
        delta.data_ptr(), noise.data_ptr(), float(clip),
        float(noise_multiplier), t, out.data_ptr(), scratch.data_ptr(),
        build.stream_handle(delta.device))
    build.check(status, "dp_clip_noise")
    launches += 1
    return out
