"""Public wrappers of the N-way fold: flatten parameter trees, stack, fold,
unflatten.  Every weighted sum of ``core/aggregation.py`` goes through
``aggregate_pytrees``: CUDA tensors launch ``csrc/fedavg_agg.cu``, CPU
tensors run ``ref.agg_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fedavg_agg.ref import agg_ref
from repro_torch.utils.tree import flatten_params, unflatten_params

MAX_N = 64          # FEDAVG_MAX_N in csrc/fedavg_agg.cu (weights by value)
launches = 0


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
    global launches
    n, t = stacked.shape
    out = torch.empty(t, dtype=torch.float32, device=stacked.device)
    status = build.library().fedavg_agg_launch(
        stacked.data_ptr(), (ctypes.c_float * n)(*ws), n, t, out.data_ptr(),
        build.stream_handle(stacked.device))
    build.check(status, "fedavg_agg")
    launches += 1
    return out


def aggregate_flat(stacked: torch.Tensor, weights) -> torch.Tensor:
    """stacked: (N, T) f32; weights: N floats -> (T,) f32 weighted sum.
    On CUDA, more than ``MAX_N`` sets fold in ordered chunks (one launch
    each, see ``fold_chunks``)."""
    if not build.on_cuda("fedavg_agg", stacked):
        return agg_ref(stacked, weights)
    build.require_f32_contiguous("fedavg_agg", stacked=stacked)
    if stacked.dim() != 2:
        raise ValueError(f"fedavg_agg: stacked must be (N, T), got "
                         f"{tuple(stacked.shape)}")
    n, t = stacked.shape
    ws = [float(w) for w in weights]
    if len(ws) != n:
        raise ValueError(f"fedavg_agg: {n} rows vs {len(ws)} weights")
    if n < 1:
        raise ValueError("fedavg_agg: needs at least one row")
    if t == 0:
        return torch.empty(0, dtype=torch.float32, device=stacked.device)
    return fold_chunks(stacked, ws, _launch)


def aggregate_pytrees(trees: list, weights: list):
    """Weighted sum of N identically-structured parameter trees."""
    if not trees:
        raise ValueError("aggregate_pytrees needs at least one pytree")
    if len(trees) != len(weights):
        raise ValueError(f"{len(trees)} pytrees vs {len(weights)} weights")
    if len(trees) == 1 and float(weights[0]) == 1.0:
        return trees[0]         # identity combination: skip the round trip
    stacked = torch.stack([flatten_params(t) for t in trees])
    return unflatten_params(aggregate_flat(stacked, weights), trees[0])
