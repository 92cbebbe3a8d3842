"""Public wrapper of the fused anchor update: CUDA tensors launch
``csrc/ewc_update.cu`` (one launch a call), CPU tensors run
``ref.ewc_ref``.

The kernel's scratch (a partial sum per block and the ticket that elects
the block adding them up) is allocated and zeroed once per (device,
stream) and kept: the kernel leaves the ticket at 0, and two streams never
share one."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ewc_update.ref import ewc_ref

MAX_BLOCKS = 1024    # EWC_MAX_BLOCKS in csrc/ewc_update.cu
launches = 0
_workspaces: dict[tuple[int, int], torch.Tensor] = {}


def workspace(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's scratch on ``device`` for ``stream``: MAX_BLOCKS
    partials, then the ticket (four floats, zero bits)."""
    return build.workspace(_workspaces, device, stream, MAX_BLOCKS + 4)


def ewc_penalty_grad_flat(lam, grads, params, anchor, fisher=None):
    """Flat (T,) tensors; ``fisher=None`` means L2-SP (F = 1).
    Returns ``(g_out, penalty)``; on CUDA the penalty stays a 0-d device
    tensor, so nothing waits for the card."""
    if not build.on_cuda("ewc_update", grads, params, anchor, fisher):
        return ewc_ref(lam, grads, params, anchor, fisher)
    build.require_f32_contiguous("ewc_update", grads=grads, params=params,
                                 anchor=anchor, fisher=fisher)
    for name, t in (("params", params), ("anchor", anchor),
                    ("fisher", fisher)):
        if t is not None and t.shape != grads.shape:
            raise ValueError(f"ewc_update: {name} has shape "
                             f"{tuple(t.shape)}, grads {tuple(grads.shape)}")
    if grads.dim() != 1:
        raise ValueError("ewc_update: tensors must be flat (T,)")
    g_out = torch.empty_like(grads)
    loss = torch.empty((), dtype=torch.float32, device=grads.device)
    t = grads.numel()
    if t == 0:
        return g_out, loss.zero_()
    stream = build.stream_handle(grads.device)
    status = build.library().ewc_update_launch(
        float(lam), grads.data_ptr(), params.data_ptr(), anchor.data_ptr(),
        None if fisher is None else fisher.data_ptr(), t, g_out.data_ptr(),
        workspace(grads.device, stream).data_ptr(), loss.data_ptr(), stream)
    build.check(status, "ewc_update")
    build.count(__name__, "launches")
    return g_out, loss
