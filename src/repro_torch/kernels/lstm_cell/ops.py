"""Public wrappers of the LSTM cell kernels: one step, and a whole sequence.

``lstm_step`` is the raw step: CUDA tensors launch ``csrc/lstm_cell.cu``,
CPU tensors run ``ref.lstm_cell_ref``.  ``LSTMCellFn`` makes it
differentiable: its backward recomputes the gates from the saved inputs and
is written out in PyTorch ops (the JAX package has no backward kernel for
this cell either; it differentiates its jnp cell).  ``lstm_cell_fused``
takes the model's params dict (wx/wh/b).  Together they are the
single-step API.

``lstm_seq_fwd`` / ``lstm_seq_bwd`` run all T steps of a sequence in one
launch each (``csrc/lstm_seq.cu``: a forward scan, and the reverse scan of
its backward, on a thread-block cluster); CPU tensors run
``ref.lstm_seq_ref`` / ``ref.lstm_seq_bwd_ref``.  ``LSTMSeqFn`` joins them
into the differentiable scan that ``models.lstm.lstm_scan`` takes where
``seq_fits`` finds a launch shape; elsewhere it chains ``LSTMCellFn``.

``launches`` counts every launch of the three kernels; ``launches_seq_fwd``
and ``launches_seq_bwd`` count the sequence route alone and stay out of
``kernels.launch_counts()``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lstm_cell.ref import (
    lstm_cell_ref,
    lstm_seq_bwd_ref,
    lstm_seq_ref,
)

launches = 0
launches_seq_fwd = 0
launches_seq_bwd = 0

# batch rows per cluster (csrc/lstm_seq.cu takes up to 8; 4 ran fastest at
# B 8 and B 256 on an H100, tools/lstm_seq_bench.py), and the kernels'
# threads and dynamic shared memory a block
SEQ_MAX_TILE, SEQ_MAX_THREADS, SEQ_MAX_SMEM = 4, 256, 232_448
SEQ_XRING = 4       # x_t buffers of the forward's cp.async ring
SEQ_BWD_ROWS = 2    # batch rows a thread of the backward
CLUSTER_ORDER = (8, 4, 2, 1)    # cluster sizes in order of preference


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
    build.count(__name__, "launches")
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
        # written with as few tensor ops as possible (the whole-sequence
        # route, LSTMSeqFn, runs these formulas in csrc/lstm_seq.cu).
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


# ----------------------------------------------------------- the sequence
def seq_tile(batch: int) -> int:
    """Batch rows per cluster: the fewest clusters of at most
    ``SEQ_MAX_TILE`` rows, with the rows spread evenly over them."""
    n = -(-batch // SEQ_MAX_TILE)
    return -(-batch // n)


def seq_threads(hidden: int, cluster: int, tile: int) -> tuple[int, int]:
    """Threads a CTA of the forward and of the backward kernel, as
    ``csrc/lstm_seq.cu``'s ``seq_threads`` counts them: the forward takes
    one batch row a thread where that fits a block, else two; the backward
    two, with every cell thread and as many partial products as fit."""
    cols, pad = hidden // cluster, tile + tile % 2
    fwd = cols * pad if cols * pad <= SEQ_MAX_THREADS else cols * pad // 2
    pairs = pad // SEQ_BWD_ROWS
    bwd = max(cols * pairs, min(hidden // 4 * pairs, SEQ_MAX_THREADS))
    return fwd, bwd


def seq_smem(hidden: int, in_dim: int, cluster: int,
             tile: int) -> tuple[int, int]:
    """Dynamic shared memory (bytes) of one CTA of the forward and of the
    backward kernel, as ``csrc/lstm_seq.cu``'s launchers size it."""
    cols, pad = hidden // cluster, tile + tile % 2
    fwd = (16 + 16 * (hidden + in_dim) * cols
           + 4 * (2 * hidden + SEQ_XRING * in_dim) * pad)
    bwd = 16 + 16 * cols * hidden + 16 * cols * pad + 8 * cluster * pad * cols
    return fwd, bwd


def seq_fits(hidden: int, in_dim: int) -> int | None:
    """CTAs per cluster of the sequence kernels at (hidden, in_dim): the
    first of ``CLUSTER_ORDER`` that divides the hidden columns into groups
    of four and whose threads and slices of Wh and Wx fit a block (8 at the
    forecaster's width); None where none does, and ``models.lstm.lstm_scan``
    then takes the step route."""
    for cs in CLUSTER_ORDER:
        if (hidden % (4 * cs) == 0
                and max(seq_threads(hidden, cs, SEQ_MAX_TILE))
                <= SEQ_MAX_THREADS
                and max(seq_smem(hidden, in_dim, cs, SEQ_MAX_TILE))
                <= SEQ_MAX_SMEM):
            return cs
    return None


def seq_cluster(hidden: int, in_dim: int) -> int:
    """``seq_fits``, raising where no cluster shape fits."""
    cs = seq_fits(hidden, in_dim)
    if cs is None:
        raise ValueError(f"lstm_seq: no cluster shape for hidden {hidden}, "
                         f"input {in_dim} (hidden must be a multiple of 4, "
                         "and a slice of Wh must fit a block's shared "
                         "memory)")
    return cs


def _seq_shapes(xs, h0, c0, wx, wh, b):
    if xs.dim() != 3 or h0.dim() != 2:
        raise ValueError("lstm_seq: xs must be (T, B, I) and h0 (B, H)")
    steps, batch, in_dim = xs.shape
    hidden = h0.shape[1]
    want = {"h0": (batch, hidden), "c0": (batch, hidden),
            "wx": (in_dim, 4 * hidden), "wh": (hidden, 4 * hidden)}
    got = {"h0": h0.shape, "c0": c0.shape, "wx": wx.shape, "wh": wh.shape}
    for name, shape in want.items():
        if tuple(got[name]) != shape:
            raise ValueError(f"lstm_seq: {name} has shape "
                             f"{tuple(got[name])}, expected {shape}")
    if b.numel() != 4 * hidden:
        raise ValueError(f"lstm_seq: b has {b.numel()} elements, expected "
                         f"{4 * hidden}")
    return steps, batch, in_dim, hidden


def lstm_seq_fwd(xs, h0, c0, wx, wh, b, save: bool = True):
    """xs: (T, B, I) time-major; h0, c0: (B, H) -> (ys (T, B, H), c sequence
    (T, B, H), gate activations (T, B, 4H), hT, cT).  The two saved tensors
    are None unless ``save``.  Not differentiable; see ``LSTMSeqFn``."""
    if not build.on_cuda("lstm_seq", xs, h0, c0, wx, wh, b):
        ys, cseq, gates, h, c = lstm_seq_ref(xs, h0, c0, wx, wh, b)
        return ys, cseq if save else None, gates if save else None, h, c
    build.require_f32_contiguous("lstm_seq", xs=xs, h0=h0, c0=c0, wx=wx,
                                 wh=wh, b=b)
    steps, batch, in_dim, hidden = _seq_shapes(xs, h0, c0, wx, wh, b)
    ys = xs.new_empty((steps, batch, hidden))
    cseq = xs.new_empty((steps, batch, hidden)) if save else None
    gates = xs.new_empty((steps, batch, 4 * hidden)) if save else None
    h_t, c_t = torch.empty_like(h0), torch.empty_like(c0)
    if batch == 0:
        return ys, cseq, gates, h_t, c_t
    status = build.launch_sized(
        "lstm_seq_fwd_launch",
        xs.data_ptr(), h0.data_ptr(), c0.data_ptr(), wx.data_ptr(),
        wh.data_ptr(), b.data_ptr(), steps, batch, in_dim, hidden,
        seq_cluster(hidden, in_dim), seq_tile(batch), ys.data_ptr(),
        cseq.data_ptr() if save else None,
        gates.data_ptr() if save else None, h_t.data_ptr(), c_t.data_ptr(),
        build.stream_handle(xs.device))
    build.check(status, "lstm_seq_fwd")
    build.count(__name__, "launches", "launches_seq_fwd")
    return ys, cseq, gates, h_t, c_t


def lstm_seq_bwd(dys, dh_t, dc_t, gates, cseq, c0, wh):
    """The reverse scan: dys (T, B, H) or None, dh_t, dc_t (B, H), the
    forward's saved ``gates`` and ``cseq``, c0, wh -> (da (T, B, 4H), dh0,
    dc0).  The weight gradients are products of ``da`` (see
    ``LSTMSeqFn.backward``)."""
    if not build.on_cuda("lstm_seq", dys, dh_t, dc_t, gates, cseq, c0, wh):
        return lstm_seq_bwd_ref(dys, dh_t, dc_t, gates, cseq, c0, wh)
    build.require_f32_contiguous("lstm_seq", dys=dys, dh_t=dh_t, dc_t=dc_t,
                                 gates=gates, cseq=cseq, c0=c0, wh=wh)
    steps, batch, hidden = cseq.shape
    want = {"gates": (steps, batch, 4 * hidden), "c0": (batch, hidden),
            "dh_t": (batch, hidden), "dc_t": (batch, hidden),
            "wh": (hidden, 4 * hidden)}
    if dys is not None:
        want["dys"] = (steps, batch, hidden)
    got = {"gates": gates, "c0": c0, "dh_t": dh_t, "dc_t": dc_t, "wh": wh,
           "dys": dys}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"lstm_seq: {name} has shape "
                             f"{tuple(got[name].shape)}, expected {shape}")
    da = gates.new_empty(gates.shape)
    dh0, dc0 = torch.empty_like(c0), torch.empty_like(c0)
    if batch == 0:
        return da, dh0, dc0
    status = build.launch_sized(
        "lstm_seq_bwd_launch",
        dys.data_ptr() if dys is not None else None, dh_t.data_ptr(),
        dc_t.data_ptr(), gates.data_ptr(), cseq.data_ptr(), c0.data_ptr(),
        wh.data_ptr(), steps, batch, hidden, seq_cluster(hidden, 1),
        seq_tile(batch), da.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        build.stream_handle(c0.device))
    build.check(status, "lstm_seq_bwd")
    build.count(__name__, "launches", "launches_seq_bwd")
    return da, dh0, dc0


class LSTMSeqFn(torch.autograd.Function):
    """The differentiable scan: forward through ``lstm_seq_fwd``, backward
    through ``lstm_seq_bwd`` (the two kernels on CUDA) and three products
    over the T*B axis for the weights.

    apply(xs (T, B, I), h0, c0, wx, wh, b) -> (ys (T, B, H), hT, cT)."""

    @staticmethod
    def forward(ctx, xs, h0, c0, wx, wh, b):
        save = any(ctx.needs_input_grad)
        ys, cseq, gates, h_t, c_t = lstm_seq_fwd(xs, h0, c0, wx, wh, b, save)
        if save:
            ctx.save_for_backward(xs, h0, c0, wx, wh, b, ys, cseq, gates)
        ctx.set_materialize_grads(False)
        return ys, h_t, c_t

    @staticmethod
    def backward(ctx, dys, dh_t, dc_t):
        xs, h0, c0, wx, wh, b, ys, cseq, gates = ctx.saved_tensors
        need = ctx.needs_input_grad
        if dh_t is None:
            dh_t = torch.zeros_like(h0)
        if dc_t is None:
            dc_t = torch.zeros_like(c0)
        da, dh0, dc0 = lstm_seq_bwd(
            dys.contiguous() if dys is not None else None,
            dh_t.contiguous(), dc_t.contiguous(), gates, cseq, c0, wh)
        steps, batch, in_dim = xs.shape
        da2 = da.reshape(steps * batch, -1)
        dx = (da2 @ wx.T).reshape(xs.shape) if need[0] else None
        dwx = xs.reshape(-1, in_dim).T @ da2 if need[3] else None
        dwh = None
        if need[4]:
            h_prev = torch.cat([h0[None], ys[:-1]]).reshape(steps * batch, -1)
            dwh = h_prev.T @ da2
        db = da2.sum(0).reshape(b.shape) if need[5] else None
        return (dx, dh0 if need[1] else None, dc0 if need[2] else None, dwx,
                dwh, db)
