"""Public wrapper of the DP clip + noise release: CUDA tensors launch
``csrc/dp_clip_noise.cu`` (one launch a call), CPU tensors run
``ref.dp_clip_noise_ref``.

This is the client-side privatization step: ``repro_torch.privacy.dp``
flattens an update delta, privatizes it here with caller-supplied
standard-normal noise, and unflattens it back into the parameter tree.

Up to ``CLUSTER_CAP`` values the kernel is one thread-block cluster and
needs no scratch; above it, one cooperative launch whose partials, ticket
and epoch flag live in a scratch zeroed once per (device, stream) and kept.
``route`` and ``cluster_shape`` mirror the C launcher's choice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dp_clip_noise.ref import dp_clip_noise_ref

CTA_THREADS, MAX_CLUSTER, MAX_PER_THREAD = 1024, 16, 12   # DP_* in the .cu
CLUSTER_CAP = CTA_THREADS * MAX_CLUSTER * MAX_PER_THREAD  # 196,608
WIDE_MAX_BLOCKS = 256          # DP_WIDE_MAX_BLOCKS: partials of the wide route
launches = 0
_workspaces: dict[tuple[int, int], torch.Tensor] = {}


def route(t: int) -> str:
    """The kernel's route for ``t`` values: "cluster" or "wide"."""
    return "cluster" if t <= CLUSTER_CAP else "wide"


def cluster_shape(t: int) -> tuple[int, int]:
    """(CTAs of the cluster, values a thread) of the cluster route: the
    CTAs a power of two up to 16, the values at most 12, both functions of
    ``t`` alone."""
    rows = -(-t // CTA_THREADS)
    n = 1
    while n < MAX_CLUSTER and n < rows:
        n *= 2
    return n, -(-rows // n)


def privatize_flat(delta: torch.Tensor, noise: torch.Tensor, clip,
                   noise_multiplier) -> torch.Tensor:
    """delta, noise: flat (T,) f32 on one device; returns the privatized
    (T,) f32 ``delta * min(1, clip/||delta||) + (noise_multiplier * clip) *
    noise``.  On CUDA the norm and both scalars stay on the device, so
    nothing waits for the card."""
    if not build.on_cuda("dp_clip_noise", delta, noise):
        return dp_clip_noise_ref(delta, noise, clip, noise_multiplier)
    build.require_f32_contiguous("dp_clip_noise", delta=delta, noise=noise)
    if delta.dim() != 1 or noise.shape != delta.shape:
        raise ValueError(f"dp_clip_noise: delta {tuple(delta.shape)} and "
                         f"noise {tuple(noise.shape)} must be the same flat "
                         "(T,) shape")
    out = torch.empty_like(delta)
    t = delta.numel()
    if t == 0:
        return out
    stream = build.stream_handle(delta.device)
    work = (None if t <= CLUSTER_CAP else build.workspace(
        _workspaces, delta.device, stream, WIDE_MAX_BLOCKS + 3).data_ptr())
    status = build.library().dp_clip_noise_launch(
        delta.data_ptr(), noise.data_ptr(), float(clip),
        float(noise_multiplier), t, out.data_ptr(), work, stream)
    build.check(status, "dp_clip_noise")
    build.count(__name__, "launches")
    return out
