"""Plain reference of the server's fold (FedCCL paper Algorithm 2).

``AggregateModels(base, update)``: where the update was trained on the
model's current round (``update.round == base.round + 1``) it replaces the
model; otherwise the model becomes the sample-weighted average
``(s_base * base + s_upd * update) / (s_base + s_upd)``.  Either way the
metadata accumulates the update's delta (samples, epochs, rounds).  A
queue of updates folds one after another in arrival order.

Float64 sums of the given tensors, leaf by leaf, cast to each leaf's
dtype at the end; imports nothing of the program.  ``precision`` rounds
every term before the sum, for the control.

A program's fold is judged element by element against the error bound of
a correct fold: a float32 weighted sum of N sets (N + 1 roundings, the
weights rounded to float32 among them) stored in the leaf's type.  An
element lies outside where it departs from the float64 fold by more than
twice that bound; the fold moves an element where the float64 fold lies
outside the bound around the base.  A fold that leaves the base as it was
puts every element that the fold moves outside.
"""

from __future__ import annotations

import statistics

import torch

from fedbench.reference.precision import rounder


def fold(base: list, base_meta: tuple, updates: list, precision="float64",
         cast: bool = True):
    """``base``: leaves; ``base_meta``: (samples, epochs, round);
    ``updates``: [(leaves, (samples, epochs, round), (d_samples, d_epochs,
    d_rounds))] in arrival order.  Returns (leaves, meta), the leaves in
    float64 where ``cast`` is False."""
    q = (lambda x: x) if precision == "float64" else rounder(precision)
    dtypes = [x.dtype for x in base]
    acc = [x.detach().double() for x in base]
    s, e, r = base_meta
    for leaves, (u_s, _, u_r), (d_s, d_e, d_r) in updates:
        upd = [x.detach().double() for x in leaves]
        if u_r == r + 1 or s + u_s <= 0:
            acc = upd
        else:
            w = s / (s + u_s)
            acc = [q(w * a) + q((1.0 - w) * u) for a, u in zip(acc, upd)]
        s, e, r = s + d_s, e + d_e, r + d_r
    if not cast:
        return acc, (s, e, r)
    return [a.to(dt) for a, dt in zip(acc, dtypes)], (s, e, r)


def sums(base_meta: tuple, update_metas: list) -> bool:
    """Whether the fold's result is a weighted sum of two parameter sets or
    more, and not one update taken whole (``update_metas``: [((samples,
    epochs, round), (d_samples, d_epochs, d_rounds))] in fold order)."""
    s, _, r = base_meta
    summed = False
    for (u_s, _, u_r), (d_s, _, d_r) in update_metas:
        summed = not (u_r == r + 1 or s + u_s <= 0)
        s, r = s + d_s, r + d_r
    return summed


def bound(want, magnitude, n_sets: int, dtype) -> torch.Tensor:
    """Twice the error bound of a correct fold, element by element:
    ``want`` the float64 fold, ``magnitude`` the same fold of the sets'
    absolute values (the sum of |weight x value|), ``dtype`` the leaf's."""
    fi = torch.finfo(dtype)
    return (fi.eps * want.abs() + 2 * (n_sets + 2) * 2.0 ** -24 * magnitude
            + fi.tiny)


def leaf_counts(got, want, base, bnd) -> tuple[int, int]:
    """(elements of ``got`` outside ``bnd`` around the float64 fold
    ``want``, elements that the fold moves beyond ``bnd`` from ``base``)."""
    outside = (got.detach().double() - want).abs().gt(bnd)
    moving = (want - base.detach().double()).abs().gt(bnd)
    return int(outside.sum()), int(moving.sum())


def worst_share(counts: list) -> float:
    """max over leaves of outside / max(moving, 1): 0 for a correct fold,
    1 for one that leaves the base as it was."""
    return max((o / max(m, 1) for o, m in counts), default=0.0)
