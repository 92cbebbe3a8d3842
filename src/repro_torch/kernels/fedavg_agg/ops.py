"""Public wrappers of the N-way fold.

Every weighted sum of ``core/aggregation.py`` goes through
``aggregate_pytrees``: on CUDA tensors it folds the trees' leaves where they
lie into views of one output vector, one launch of ``csrc/fedavg_agg.cu``'s
leaf kernel for up to 64 trees of up to 16 leaves (the forecaster has 8;
``pack_leaf_folds`` builds the pointer tables); on CPU tensors it runs
``ref.agg_leaves_ref``.  ``aggregate_flat`` folds a stack a caller already
holds (the stacked kernel, or ``ref.agg_ref``).  Both kernels add in set
order with the same FMAs, so the routes agree bit for bit.

The stacked route's host path is what its launch needs: up to ``MAX_N``
sets go straight to one launch (``fold_chunks`` only past that), the
weights travel as bytes packed by a ``struct.Struct`` kept for each count
(no ctypes array a call), the checks are the device, dtype, rank and
layout tests the kernel relies on, and the output comes from
``new_empty`` (``tools/fold_wrapper_split.py`` times each piece on the
card).

``launches`` counts both kernels' launches, ``launches_leaves`` the leaf
kernel alone and ``launches_stacked`` the stacked one (both kept out of
``kernels.launch_counts()``).
"""

from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fedavg_agg.ref import agg_leaves_ref, agg_ref
from repro_torch.utils.tree import tree_leaves, unflatten_params

MAX_N = 64          # FEDAVG_MAX_N in csrc/fedavg_agg.cu (weights by value)
MAX_PTRS = 1024     # FOLD_MAX_PTRS: leaf pointers in one LeafFold table
MAX_LEAVES = 16     # FOLD_MAX_LEAVES
launches = 0
launches_leaves = 0
launches_stacked = 0
# the weights of a stacked launch as n packed f32 (the C side's float*)
_PACKS = tuple(struct.Struct(f"{n}f") for n in range(MAX_N + 1))


class LeafFold(ctypes.Structure):
    """``struct LeafFold`` of ``csrc/fedavg_agg.cu``, passed by value."""
    _fields_ = [("x", ctypes.c_void_p * MAX_PTRS),
                ("out", ctypes.c_void_p * MAX_LEAVES),
                ("len", ctypes.c_longlong * MAX_LEAVES),
                ("block_start", ctypes.c_longlong * (MAX_LEAVES + 1)),
                ("w", ctypes.c_float * MAX_N),
                ("n", ctypes.c_int),
                ("n_leaves", ctypes.c_int)]


def fold_chunks(stacked: torch.Tensor, ws: list, fold) -> torch.Tensor:
    """``sum_i ws[i] * stacked[i]`` through ``fold(rows, weights)``, which
    takes at most ``MAX_N`` sets: the first ``MAX_N`` sets, then ``MAX_N - 1``
    at a time behind the running sum as set 0 at weight 1.0.  Since
    ``1 * acc + 0 == acc``, a fold that adds in row order gives the flat
    loop's sum over all N sets."""
    out = fold(stacked[:MAX_N], ws[:MAX_N])
    for lo in range(MAX_N, len(ws), MAX_N - 1):
        hi = lo + MAX_N - 1
        out = fold(torch.cat([out[None], stacked[lo:hi]]), [1.0] + ws[lo:hi])
    return out


def _launch(stacked: torch.Tensor, ws: list) -> torch.Tensor:
    n, t = stacked.shape
    out = stacked.new_empty(t)
    status = build.library().fedavg_agg_launch(
        stacked.data_ptr(), _PACKS[n].pack(*ws), n, t, out.data_ptr(),
        build.stream_handle(stacked.device))
    if status:
        build.check(status, "fedavg_agg")
    build.count(__name__, "launches", "launches_stacked")
    return out


def aggregate_flat(stacked: torch.Tensor, weights) -> torch.Tensor:
    """stacked: (N, T) f32; weights: N floats -> (T,) f32 weighted sum.
    On CUDA, up to ``MAX_N`` sets are one launch; more fold in ordered
    chunks (one launch each, see ``fold_chunks``)."""
    if not stacked.is_cuda:
        build.on_cuda("fedavg_agg", stacked)        # raises off the CPU
        return agg_ref(stacked, weights)
    if stacked.dtype != torch.float32 or stacked.dim() != 2 \
            or not stacked.is_contiguous():
        raise ValueError(f"fedavg_agg: stacked must be a contiguous (N, T) "
                         f"float32 tensor, got {stacked.dtype} "
                         f"{tuple(stacked.shape)}")
    n, t = stacked.shape
    ws = [float(w) for w in weights]
    if len(ws) != n:
        raise ValueError(f"fedavg_agg: {n} rows vs {len(ws)} weights")
    if n < 1:
        raise ValueError("fedavg_agg: needs at least one row")
    if t == 0:
        return stacked.new_empty(0)
    if n > MAX_N:
        return fold_chunks(stacked, ws, _launch)
    return _launch(stacked, ws)


def pack_leaf_folds(ptrs: list, outs: list, lengths: list,
                    weights: list) -> list[dict]:
    """The launches of one fold by leaves, in order, as plain dicts with the
    fields of ``LeafFold`` (``x``: the pointer table, set-major).

    ptrs[i][l] is set i's leaf l (leaves in JAX order), outs[l] and
    lengths[l] the output leaf.  Leaves go in groups of at most
    ``MAX_LEAVES`` whose table fits ``MAX_PTRS`` pointers; within a group
    the sets fold as ``fold_chunks`` folds them: the first ``MAX_N``, then
    ``MAX_N - 1`` at a time behind the running sum, read from the output
    as set 0 at weight 1.0."""
    n, n_leaves = len(ptrs), len(outs)
    first = min(n, MAX_N)
    per = max(1, min(MAX_LEAVES, MAX_PTRS // first))
    folds = []
    for lo in range(0, n_leaves, per):
        ls = range(lo, min(lo + per, n_leaves))
        chunks = [(list(range(first)), [float(w) for w in weights[:first]])]
        for c in range(MAX_N, n, MAX_N - 1):
            idx = list(range(c, min(c + MAX_N - 1, n)))
            chunks.append(([None] + idx, [1.0] + [float(weights[i])
                                                  for i in idx]))
        for sets, ws in chunks:
            folds.append({
                "x": [outs[l] if i is None else ptrs[i][l]
                      for i in sets for l in ls],
                "out": [outs[l] for l in ls],
                "len": [lengths[l] for l in ls],
                "w": ws, "n": len(sets), "n_leaves": len(ls)})
    return folds


def _launch_leaves(fold: dict, device) -> None:
    lib = build.library()
    if ctypes.sizeof(LeafFold) != lib.fedavg_leaf_fold_size():
        raise RuntimeError("fedavg_agg: LeafFold differs from the kernel's "
                           "struct")
    f = LeafFold()      # copied by value into the launch
    f.x[:len(fold["x"])] = fold["x"]
    f.out[:fold["n_leaves"]] = fold["out"]
    f.len[:fold["n_leaves"]] = fold["len"]
    f.w[:fold["n"]] = fold["w"]
    f.n, f.n_leaves = fold["n"], fold["n_leaves"]
    status = lib.fedavg_agg_leaves_launch(ctypes.byref(f),
                                          build.stream_handle(device))
    build.check(status, "fedavg_agg_leaves")
    build.count(__name__, "launches", "launches_leaves")


def aggregate_leaves(leaves: list, weights: list) -> torch.Tensor:
    """leaves[i]: set i's leaves in JAX order (same shapes across sets);
    weights: N floats -> the weighted sum as one flat f32 vector in that
    order.  On CUDA the leaves are read where they lie (f32 and contiguous;
    others are converted first), in ``pack_leaf_folds``'s launches."""
    n = len(leaves)
    if n < 1:
        raise ValueError("fedavg_agg: needs at least one set")
    if len(weights) != n:
        raise ValueError(f"fedavg_agg: {n} sets vs {len(weights)} weights")
    shapes = [x.shape for x in leaves[0]]
    for ls in leaves[1:]:
        # RuntimeError, as torch.stack of the flattened sets raised it
        if [x.shape for x in ls] != shapes:
            raise RuntimeError("fedavg_agg: the sets have other leaf shapes")
    if not build.on_cuda("fedavg_agg", *(x for ls in leaves for x in ls)):
        return agg_leaves_ref(leaves, weights)
    lengths = [x.numel() for x in leaves[0]]
    out = torch.empty(sum(lengths), dtype=torch.float32,
                      device=leaves[0][0].device)
    base, ptrs, outs, lens, keep = out.data_ptr(), [], [], [], []
    for l, m in enumerate(lengths):
        if m:
            outs.append(base)
            lens.append(m)
            keep.append(l)
        base += 4 * m
    if not keep:
        return out
    held = []           # converted leaves stay alive until their launch
    for ls in leaves:
        row = []
        for l in keep:
            x = ls[l]
            if x.dtype != torch.float32 or not x.is_contiguous():
                x = x.to(torch.float32).contiguous()
                held.append(x)
            row.append(x.data_ptr())
        ptrs.append(row)
    for fold in pack_leaf_folds(ptrs, outs, lens, weights):
        _launch_leaves(fold, out.device)
    return out


def aggregate_pytrees(trees: list, weights: list):
    """Weighted sum of N identically-structured parameter trees."""
    if not trees:
        raise ValueError("aggregate_pytrees needs at least one pytree")
    if len(trees) != len(weights):
        raise ValueError(f"{len(trees)} pytrees vs {len(weights)} weights")
    if len(trees) == 1 and float(weights[0]) == 1.0:
        return trees[0]         # identity combination: skip the round trip
    flat = aggregate_leaves([tree_leaves(t) for t in trees], weights)
    return unflatten_params(flat, trees[0])
