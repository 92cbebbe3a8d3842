"""Public wrappers of the fused LSTM step.

``lstm_step`` is the raw step: CUDA tensors launch ``csrc/lstm_cell.cu``,
CPU tensors run ``ref.lstm_cell_ref``.  ``LSTMCellFn`` makes it
differentiable: its backward recomputes the gates from the saved inputs and
is written out in PyTorch ops (the JAX package has no backward kernel for
this cell either; it differentiates its jnp cell).  ``lstm_cell_fused``
takes the model's params dict (wx/wh/b) and is the step of
``models.lstm.lstm_scan``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

launches = 0


def _check_shapes(x, h, c, wx, wh, b):
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError("lstm_cell: x and h must be 2-D (B, I) and (B, H)")
    batch, in_dim = x.shape
    hidden = h.shape[1]
    want = {"h": (batch, hidden), "c": (batch, hidden),
            "wx": (in_dim, 4 * hidden), "wh": (hidden, 4 * hidden)}
    got = {"h": h.shape, "c": c.shape, "wx": wx.shape, "wh": wh.shape}
    for name, shape in want.items():
        if tuple(got[name]) != shape:
            raise ValueError(f"lstm_cell: {name} has shape "
                             f"{tuple(got[name])}, expected {shape}")
    if b.numel() != 4 * hidden:
        raise ValueError(f"lstm_cell: b has {b.numel()} elements, expected "
                         f"{4 * hidden}")
    return batch, in_dim, hidden


def lstm_step(x, h, c, wx, wh, b):
    """x: (B, I), h/c: (B, H), wx: (I, 4H), wh: (H, 4H), b: (4H,) or
    (1, 4H) -> (h', c').  Not differentiable; see ``LSTMCellFn``."""
    if not build.on_cuda("lstm_cell", x, h, c, wx, wh, b):
        return lstm_cell_ref(x, h, c, wx, wh, b)
    global launches
    build.require_f32_contiguous("lstm_cell", x=x, h=h, c=c, wx=wx, wh=wh,
                                 b=b)
    batch, in_dim, hidden = _check_shapes(x, h, c, wx, wh, b)
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    if batch == 0:
        return h_out, c_out
    status = build.library().lstm_cell_launch(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
        wh.data_ptr(), b.data_ptr(), batch, in_dim, hidden, h_out.data_ptr(),
        c_out.data_ptr(), build.stream_handle(x.device))
    build.check(status, "lstm_cell")
    launches += 1
    return h_out, c_out


class LSTMCellFn(torch.autograd.Function):
    """One differentiable LSTM step: forward through ``lstm_step`` (the
    kernel on CUDA), backward in PyTorch ops from the recomputed gates."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        ctx.save_for_backward(x, h, c, wx, wh, b)
        return lstm_step(x, h, c, wx, wh, b)

    @staticmethod
    def backward(ctx, dh_new, dc_new):
        # With s = sigmoid and a_* the gate pre-activations:
        #   dc_t = dc' + dh' * o * (1 - tanh(c')^2)
        #   da_i = dc_t * g * i(1-i)    da_f = dc_t * c * f(1-f)
        #   da_g = dc_t * i * (1-g^2)   da_o = dh' * tanh(c') * o(1-o)
        # written with as few tensor ops as possible: a step's backward
        # runs 768 times per training step.
        x, h, c, wx, wh, b = ctx.saved_tensors
        hidden = h.shape[1]
        pre = torch.addmm(torch.addmm(b.reshape(-1), x, wx), h, wh)
        pre[:, hidden:2 * hidden] += 1.0              # forget-gate bias
        s = torch.sigmoid(pre)
        i, f, _, o = s.chunk(4, dim=1)
        g = torch.tanh(pre[:, 2 * hidden:3 * hidden])
        tc = torch.tanh(torch.addcmul(f * c, i, g))
        dc_t = torch.addcmul(dc_new, dh_new * o, 1.0 - tc * tc)
        up = torch.cat([dc_t * g, dc_t * c, dc_t * i, dh_new * tc], dim=1)
        slope = s - s * s                             # s'(a) for i, f, o
        slope[:, 2 * hidden:3 * hidden] = 1.0 - g * g  # tanh'(a) for g
        da = up * slope
        need = ctx.needs_input_grad
        dx = da @ wx.T if need[0] else None
        dh = da @ wh.T if need[1] else None
        dc = dc_t * f if need[2] else None
        dwx = x.T @ da if need[3] else None
        dwh = h.T @ da if need[4] else None
        db = da.sum(0).reshape(b.shape) if need[5] else None
        return dx, dh, dc, dwx, dwh, db


def lstm_cell_fused(p: dict, x, h, c):
    """Differentiable step with the model's params dict (wx, wh, b)."""
    return LSTMCellFn.apply(x, h, c, p["wx"], p["wh"], p["b"])
