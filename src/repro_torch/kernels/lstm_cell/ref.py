"""Plain PyTorch version of the lstm_cell kernel (its oracle and CPU route).
Works in any float dtype, so the backward can be gradchecked in float64."""

from __future__ import annotations

import torch


def lstm_cell_ref(x, h, c, wx, wh, b):
    gates = x @ wx + h @ wh + b.reshape(-1)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new
