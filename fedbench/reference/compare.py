"""The numbers that decide ``correct`` for a training update.

For each update sampled from a run: the relative gap of each step's loss,
and, leaf by leaf, the gap between the program's norm and the reference's
of the first step's gradient (as the update applied it) and of the
parameters' whole change.  A leaf's gap is measured against the larger of
its own reference norm and the median leaf's, since some gradients are all
but zero.  Leaves whose reference gradient is under a thousandth of the
median leaf's are left out of the change: they move by round-off alone.
"""

from __future__ import annotations

import statistics

import torch

QUIET_LEAF = 1e-3


def norms(leaves: list) -> list:
    return [float(torch.linalg.vector_norm(x.detach().double()))
            for x in leaves]


def loss_gap(prog: list, ref: list) -> float:
    """max over steps of |prog - ref| / |ref|."""
    return max(abs(float(p) - float(r)) / max(abs(float(r)), 1e-30)
               for p, r in zip(prog, ref, strict=True))


def norm_gap(prog: list, ref: list, keep: list | None = None) -> float:
    """Worst leaf of |norm_prog - norm_ref| / max(norm_ref, median norm_ref)
    over the leaves ``keep`` marks (all where None); norms as floats."""
    med = statistics.median(ref)
    worst = 0.0
    for i, (p, r) in enumerate(zip(prog, ref, strict=True)):
        if keep is not None and not keep[i]:
            continue
        worst = max(worst, abs(p - r) / max(r, med, 1e-30))
    return worst


def moving_leaves(ref_grad_norms: list) -> list:
    """The leaves whose reference gradient is at least ``QUIET_LEAF`` of the
    median leaf's."""
    med = statistics.median(ref_grad_norms)
    return [g >= QUIET_LEAF * med for g in ref_grad_norms]
