"""Plain PyTorch versions of the lstm_cell kernels (their oracles and CPU
routes): the step, the whole-sequence forward and its reverse scan.  They
work in any float dtype, so the backward can be gradchecked in float64."""

from __future__ import annotations

import torch


def _cell(x, h, c, wx, wh, b):
    """(i, f, g, o activations, c', h') of one step."""
    gates = x @ wx + h @ wh + b.reshape(-1)
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.tanh(g),
                  torch.sigmoid(o))
    c_new = f * c + i * g
    return i, f, g, o, c_new, o * torch.tanh(c_new)


def lstm_cell_ref(x, h, c, wx, wh, b):
    *_, c_new, h_new = _cell(x, h, c, wx, wh, b)
    return h_new, c_new


def lstm_seq_ref(xs, h0, c0, wx, wh, b):
    """The loop of ``lstm_cell_ref`` over a time-major sequence.

    xs: (T, B, I); h0, c0: (B, H) -> ys (T, B, H), the c sequence (T, B, H),
    the gate activations i, f, g, o (T, B, 4H), hT, cT: the kernel's outputs
    and the layout it saves for the backward."""
    h, c = h0, c0
    ys, cs, acts = [], [], []
    for x in xs:
        i, f, g, o, c, h = _cell(x, h, c, wx, wh, b)
        ys.append(h)
        cs.append(c)
        acts.append(torch.cat([i, f, g, o], dim=-1))
    if not ys:
        empty = h0.new_empty((0, *h0.shape))
        return (empty, empty, h0.new_empty((0, h0.shape[0], 4 * h0.shape[1])),
                h0, c0)
    return torch.stack(ys), torch.stack(cs), torch.stack(acts), h, c


def lstm_seq_bwd_ref(dys, dh_t, dc_t, gates, cseq, c0, wh):
    """The reverse scan of ``lstm_seq_ref``'s backward, with the formulas of
    ``LSTMCellFn.backward`` (a sigmoid's slope rounded as (1 - s) * s, as
    autograd rounds it: s - s*s cancels near 1) and the kernel's
    saved-tensor layout.

    dys: (T, B, H) or None (the encoder's outputs are discarded); dh_t,
    dc_t: (B, H), the gradients reaching hT and cT; gates, cseq: the
    forward's saved activations and c sequence -> da (T, B, 4H), the gate
    pre-activation gradients, and dh0, dc0 (B, H)."""
    hidden = c0.shape[-1]
    dh, dc = dh_t, dc_t
    da = gates.new_empty(gates.shape)
    for t in range(gates.shape[0] - 1, -1, -1):
        if dys is not None:
            dh = dh + dys[t]
        i, f, g, o = gates[t].split(hidden, dim=-1)
        c_prev = cseq[t - 1] if t > 0 else c0
        tc = torch.tanh(cseq[t])
        dct = dc + (dh * o) * (1.0 - tc * tc)
        da[t] = torch.cat([(dct * g) * ((1.0 - i) * i),
                           (dct * c_prev) * ((1.0 - f) * f),
                           (dct * i) * (1.0 - g * g),
                           (dh * tc) * ((1.0 - o) * o)], dim=-1)
        dc = dct * f
        dh = da[t] @ wh.T
    return da, dh, dc
