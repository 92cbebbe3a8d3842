"""``einsum`` and ``reshape`` of sharded DTensors, where DTensor's own
rules stop.

``torch.einsum`` on DTensors lowers to reshapes and a ``bmm`` whose output
placement DTensor picks: it shards the result on a mesh dim that shards
neither operand where that costs no communication (a projection to 8
heads whose flattened columns it sharded 16 ways), and the view back to
the einsum's letters is then one DTensor refuses.  The reference's rules
keep such a dim replicated (``sharding/logical.py``: a mapping whose dim
does not divide the axis is dropped).  ``einsum`` here contracts pair by
pair through one ``bmm`` each (``_bmm``), whose result takes its
placements from the operands', mesh dim by mesh dim: replicated where
neither is sharded, sharded on a batch or free dim where an operand
shards it, a pending sum where both shard the contracted dim; operands
that shard different roles on one mesh dim are reconciled first by the
redistribution the plan needs (the smaller one gathered: the FSDP gather
of a weight).  Reshapes keep the shards of the dims they do not change,
and views of local shards that are not contiguous (a gradient's permuted
layout) are taken on contiguous ones.  Where DTensor still refuses a
reshape, the mesh dims that shard the dims it changes are gathered first.
Those gathers are this module's, not the sharding plan's: they run inside
``fallback()``, and ``launch.roofline.CollectiveCounter`` files the
collectives issued there apart from the plan's (a guard: no config of the
repo reaches one on the production meshes).

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
    out = _bmm(_reshape(a, (prod(batch), prod(left), prod(contract))),
               _reshape(b, (prod(batch), prod(contract), prod(right))))
    letters = batch + left + right
    return _reshape(out, tuple(size[c] for c in letters)), "".join(letters)


# a bmm operand's roles by the dim a mesh dim shards: a (n, m, k), b (n, k, p)
_ROLES_A, _ROLES_B = ("n", "m", "k"), ("n", "k", "p")
# compatible roles on one mesh dim -> the result's placement there (Shard
# dim, "sum" or None) and each operand's gradient's
_PAIRS = {
    (None, None): (None, None, None),
    ("n", "n"): (0, 0, 0),
    ("m", None): (1, 1, "sum"),
    (None, "p"): (2, "sum", 2),
    ("k", "k"): ("sum", 2, 1),
    ("sum", None): ("sum", None, "sum"),
    (None, "sum"): ("sum", "sum", None),
}


def _role(pl, roles):
    if pl.is_shard():
        return roles[pl.dim]
    return "sum" if pl.is_partial() else None


def _placement(tag):
    from torch.distributed.tensor import Partial, Replicate, Shard

    if tag is None:
        return Replicate()
    return Partial() if tag == "sum" else Shard(tag)


def _bmm(a, b):
    """``torch.bmm`` of ``a`` (n, m, k) and ``b`` (n, k, p), either a
    DTensor, on each rank's shards, placed from the operands' placements
    mesh dim by mesh dim (``_PAIRS``).  An operand replicated where the
    other shards n or k is sliced to match (no communication) where the
    dim divides the mesh dim evenly; any other pair of roles (m against
    p, n or k; a pending sum against a shard) gathers the operand with
    fewer elements there first."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = (a if hasattr(a, "device_mesh") else b).device_mesh
    a, b = (x if hasattr(x, "device_mesh") else DTensor.from_local(
        x, mesh, [Replicate()] * mesh.ndim, run_check=False) for x in (a, b))
    n, m, k = a.shape
    p = b.shape[2]
    pa, pb = list(a.placements), list(b.placements)
    out, ga, gb = [], [], []
    for i in range(mesh.ndim):
        even = {"n": n % mesh.size(i) == 0, "k": k % mesh.size(i) == 0}

        def matched(ra, rb):
            """A replicated side sliced to the other's n or k, where the
            dim divides evenly."""
            if ra is None and rb in ("n", "k") and even[rb]:
                return rb, rb
            if rb is None and ra in ("n", "k") and even[ra]:
                return ra, ra
            return ra, rb

        ra, rb = matched(_role(pa[i], _ROLES_A), _role(pb[i], _ROLES_B))
        if (ra, rb) not in _PAIRS:
            ra, rb = (matched(None, rb) if a.numel() < b.numel()
                      else matched(ra, None))
        if (ra, rb) not in _PAIRS:           # a sliced dim does not divide
            ra = rb = None
        pa[i] = _placement(_ROLES_A.index(ra) if ra in _ROLES_A else ra)
        pb[i] = _placement(_ROLES_B.index(rb) if rb in _ROLES_B else rb)
        o, da, db = _PAIRS[(ra, rb)]
        out.append(_placement(o))
        ga.append(_placement(da))
        gb.append(_placement(db))
    a = a.redistribute(mesh, pa)
    b = b.redistribute(mesh, pb)
    y = torch.bmm(a.to_local(grad_placements=tuple(ga)),
                  b.to_local(grad_placements=tuple(gb)))
    return DTensor.from_local(y, mesh, tuple(out), run_check=False,
                              shape=torch.Size((n, m, p)),
                              stride=(m * p, p, 1))


def _reshape(x, shape: tuple):
    """``x.reshape(shape)``; on a sharded DTensor the view and its gradient
    go through ``_Reshape``."""
    if not is_sharded(x):
        return x.reshape(shape)
    return _Reshape.apply(x, shape)


def _groups(old: list, new: list) -> list:
    """The reshape's dim groups, right to left: (i0, i1, j0, j1) where old
    dims [i0, i1) and new dims [j0, j1) hold the same elements."""
    out, i, j = [], 0, 0
    while i < len(old) or j < len(new):
        i0, j0, po, pn = i, j, 1, 1
        if i < len(old):
            po, i = old[i], i + 1
        if j < len(new):
            pn, j = new[j], j + 1
        while po != pn:
            if po < pn:
                po, i = po * old[i], i + 1
            else:
                pn, j = pn * new[j], j + 1
        out.append((i0, i, j0, j))
    return out[::-1]


def _dense_shards(x):
    """``x`` with contiguous local shards (DTensor's ``contiguous`` looks
    at the global strides only)."""
    from torch.distributed.tensor import DTensor

    loc = x.to_local()
    if loc.is_contiguous():
        return x
    return DTensor.from_local(loc.contiguous(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _reshape_dt(x, shape: tuple):
    """A DTensor reshaped.  A view DTensor refuses on the local shards as
    they lie (not contiguous) is taken on contiguous ones; else the view
    goes group by group (``_groups``), and only a group DTensor still
    refuses (a shard it cannot split or merge) has the mesh dims that
    shard its dims gathered first, inside ``fallback()``."""
    try:                      # a view refused by DTensor raises before it runs
        return x.reshape(shape)
    except RuntimeError:
        pass
    x = _dense_shards(x)
    try:
        return x.reshape(shape)
    except RuntimeError:
        pass
    from torch.distributed.tensor import Replicate

    new = list(shape)
    for i0, i1, j0, j1 in _groups(list(x.shape), new):
        dims = list(x.shape)
        if dims[i0:i1] == new[j0:j1]:
            continue
        target = dims[:i0] + new[j0:j1] + dims[i1:]
        try:
            x = x.reshape(target)
            continue
        except RuntimeError:
            pass
        pl = [Replicate() if p.is_shard() and i0 <= p.dim < i1 else p
              for p in x.placements]
        with fallback():
            x = x.redistribute(x.device_mesh, pl)
        x = x.reshape(target)
    return x


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
