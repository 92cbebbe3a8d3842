"""``einsum`` and ``reshape`` of sharded DTensors, where DTensor's own
rules stop.

``torch.einsum`` on DTensors lowers to reshapes and a ``bmm`` whose output
placement DTensor picks; the final view back to the einsum's letters can
then be one DTensor refuses (a projection to 8 heads whose flattened
columns DTensor sharded 16 ways), and its backward views local shards
that are not contiguous.  ``einsum`` here contracts pair by pair through
one ``bmm`` each, with reshapes of its own; where DTensor still refuses
one of those reshapes, the mesh dims that shard the dims it changes are
gathered first.  Those gathers are this module's, not the sharding plan's:
they run inside ``fallback()``, and ``launch.roofline.CollectiveCounter``
files the collectives issued there apart from the plan's.

The model reaches this module only through ``models.layers.einsum``, and
only with a sharded DTensor operand; plain tensors and DTensors that are
replicated everywhere never come here.
"""

from __future__ import annotations

import contextlib

import torch

_fallback_depth = 0


@contextlib.contextmanager
def fallback():
    """Mark the collectives issued inside as this module's gathers."""
    global _fallback_depth
    _fallback_depth += 1
    try:
        yield
    finally:
        _fallback_depth -= 1


def in_fallback() -> bool:
    return _fallback_depth > 0


def is_sharded(x) -> bool:
    """A DTensor sharded or pending a sum on some mesh dim."""
    return hasattr(x, "device_mesh") and any(not p.is_replicate()
                                             for p in x.placements)


def einsum(eq: str, operands) -> torch.Tensor:
    """``torch.einsum(eq, *operands)`` of DTensors (no ellipsis), operands
    of one dtype: contracted left to right, each pair through one
    ``bmm``."""
    lhs, out_letters = eq.replace(" ", "").split("->")
    letters = lhs.split(",")
    x, lx = operands[0], letters[0]
    for i in range(1, len(operands)):
        keep = out_letters + "".join(letters[i + 1:])
        x, lx = _pair(x, lx, operands[i], letters[i], keep)
    x, lx = _sum_lone(x, lx, "", out_letters)
    return x.permute([lx.index(c) for c in out_letters])


def _sum_lone(x, lx: str, other: str, keep: str):
    """Sum out the letters of ``x`` no other operand or the result has."""
    lone = [i for i, c in enumerate(lx) if c not in other and c not in keep]
    if not lone:
        return x, lx
    return x.sum(dim=lone), "".join(c for i, c in enumerate(lx)
                                    if i not in lone)


def _pair(a, la: str, b, lb: str, keep: str):
    """Contract DTensors ``a`` (letters ``la``) and ``b`` over the letters
    not in ``keep``, through one ``bmm``; returns (result, its letters)."""
    a, la = _sum_lone(a, la, lb, keep)
    b, lb = _sum_lone(b, lb, la, keep)
    batch = [c for c in la if c in lb and c in keep]
    contract = [c for c in la if c in lb and c not in keep]
    left = [c for c in la if c not in lb]
    right = [c for c in lb if c not in la]
    size = {c: a.shape[la.index(c)] for c in la}
    size.update({c: b.shape[lb.index(c)] for c in lb})

    def prod(cs):
        n = 1
        for c in cs:
            n *= size[c]
        return n

    a = a.permute([la.index(c) for c in batch + left + contract])
    b = b.permute([lb.index(c) for c in batch + contract + right])
    out = torch.bmm(_reshape(a, (prod(batch), prod(left), prod(contract))),
                    _reshape(b, (prod(batch), prod(contract), prod(right))))
    letters = batch + left + right
    return _reshape(out, tuple(size[c] for c in letters)), "".join(letters)


def _reshape(x, shape: tuple):
    """``x.reshape(shape)``; on a sharded DTensor the view and its gradient
    go through ``_Reshape``."""
    if not is_sharded(x):
        return x.reshape(shape)
    return _Reshape.apply(x, shape)


def _reshape_dt(x, shape: tuple):
    """A DTensor reshaped; where DTensor refuses the view (a shard it
    cannot split or merge), the mesh dims that shard the dims the view
    changes are gathered first, inside ``fallback()``."""
    try:                      # a view refused by DTensor raises before it runs
        return x.reshape(shape)
    except RuntimeError:
        pass
    from torch.distributed.tensor import Replicate

    old, new = list(x.shape), list(shape)
    lo = 0
    while lo < min(len(old), len(new)) and old[lo] == new[lo]:
        lo += 1
    hi = 0
    while (hi < min(len(old), len(new)) - lo
           and old[len(old) - 1 - hi] == new[len(new) - 1 - hi]):
        hi += 1
    touched = range(lo, len(old) - hi)
    pl = [Replicate() if p.is_shard() and p.dim in touched else p
          for p in x.placements]
    with fallback():
        x = x.redistribute(x.device_mesh, pl)
    return x.reshape(shape)


class _Reshape(torch.autograd.Function):
    """``_reshape_dt`` forward, and backward on the gradient, whose
    placements DTensor chose and may not be viewable back either."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _reshape_dt(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape_dt(g, ctx.in_shape), None
