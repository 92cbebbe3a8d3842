"""Plain reference of the solar client's training (FedCCL paper §II.E, §III).

The forecaster: a one-layer LSTM encoder over the 7-day history (10
channels), its final state seeding an LSTM decoder over the next day's
weather forecast (9 channels), a linear head and ``sigmoid(y - 2.5)`` for
96 quarter-hour productions normalised to kWp.  Gates are [i, f, g, o] in
one fused weight, the forget gate with a constant bias of +1.  The loss is
the mean squared error; a client's update is plain SGD on the loss plus
the L2 anchor ``(lam / 2) * sum (p - anchor)^2``, one epoch over its
training windows in batches of 8 in the order its generator's
``permutation`` gives.

Plain PyTorch, float32, explicit gate arithmetic, TF32 off; imports
nothing of the program.  ``precision`` rounds every product's operands
(``reference.precision``) for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from fedbench.reference.precision import rounder

LEAF_ORDER = ("decoder/b", "decoder/wh", "decoder/wx", "encoder/b",
              "encoder/wh", "encoder/wx", "head_b", "head_w")


def leaves(tree: dict) -> list:
    """The tree's tensors in ``LEAF_ORDER`` (sorted keys, depth first)."""
    out = []
    for path in LEAF_ORDER:
        node = tree
        for k in path.split("/"):
            node = node[k]
        out.append(node)
    return out


def _scan(p, xs, h, c, q):
    """xs (B, T, I) -> outputs (B, T, H), final (h, c)."""
    xw = (q(xs) @ q(p["wx"]))                       # (B, T, 4H), all steps
    ys = []
    for t in range(xs.shape[1]):
        gates = xw[:, t] + q(h) @ q(p["wh"]) + p["b"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1), h, c


def predict(params, history, forecast, q=lambda x: x):
    b = history.shape[0]
    hidden = params["encoder"]["wh"].shape[0]
    h = history.new_zeros((b, hidden))
    _, h, c = _scan(params["encoder"], history, h, h.clone(), q)
    ys, _, _ = _scan(params["decoder"], forecast, h, c, q)
    y = q(ys) @ q(params["head_w"]) + params["head_b"]
    return torch.sigmoid(y[..., 0] - 2.5)


def loss_and_grads(params, batch, q):
    live = {k: ({kk: vv.detach().float().requires_grad_()
                 for kk, vv in v.items()} if isinstance(v, dict)
                else v.detach().float().requires_grad_())
            for k, v in params.items()}
    pred = predict(live, batch["history"], batch["forecast"], q)
    loss = torch.mean(torch.square(pred - batch["target"]))
    grads = torch.autograd.grad(loss, leaves(live))
    return loss.detach(), list(grads)


def _rebuild(flat: list) -> dict:
    it = iter(flat)
    vals = {path: next(it) for path in LEAF_ORDER}
    out = {}
    for path, v in vals.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def client_update(params, anchor, lam, lr, windows, rng_state, batch_size,
                  epochs, device, precision="float32", half_batch=False):
    """The client's ``epochs`` of anchored SGD from ``params`` (a tree of
    tensors), ``anchor`` (a tree or None), over ``windows`` (numpy arrays),
    with batches ordered by a numpy generator restored to ``rng_state``.
    Returns (losses, the first step's gradient as the update applied it
    (``(p0 - p1) / lr`` in float32), per leaf, the final parameters as a
    list in ``LEAF_ORDER``).  ``half_batch`` plants a fault: each step
    sees the first half of its batch, the mean taken over it."""
    q = rounder(precision)
    rng = np.random.default_rng()
    rng.bit_generator.state = rng_state
    p = [x.detach().float() for x in leaves(params)]
    a = None if anchor is None else [x.detach().float()
                                     for x in leaves(anchor)]
    n = len(windows["target"])
    losses, first_grad = [], None
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n, batch_size):
            sel = order[i:i + batch_size]
            if half_batch:
                sel = sel[:max(1, len(sel) // 2)]
            batch = {k: torch.from_numpy(windows[k][sel]).to(device)
                     for k in ("history", "forecast", "target")}
            loss, g = loss_and_grads(_rebuild(p), batch, q)
            if a is not None:
                g = [gi + lam * (pi - ai) for gi, pi, ai in zip(g, p, a)]
            new = [pi - lr * gi for pi, gi in zip(p, g)]
            if first_grad is None:
                # as the update applied it: read back from the float32
                # parameters, as the program's is
                first_grad = [(a - b) / lr for a, b in zip(p, new)]
            p = new
            losses.append(loss)
    return losses, first_grad, p
