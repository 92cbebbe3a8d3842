"""The comparison that decides ``correct``, shared by every cell.

Each reading is taken for "program" (what the run produced) and, for the
control, for the reference computed in a lower precision put in the
program's place; both against the float32 (float64 for the fold)
reference:

- ``loss_gap``, ``grad_gap``, ``change_gap``: over the sampled client
  updates (``reference/compare.py``);
- ``meta_mismatches``: models whose metadata is not the sum of the deltas
  submitted to them, and sampled folds whose metadata is not Algorithm 2's
  (exact);
- ``fold_gap``: over a sample of the folds that the store made in the
  window and that sum (``Recorder.tap_folds``: their base, their updates
  in fold order and their result), the worst leaf's share of the elements
  that the fold moves which lie outside the error bound of a correct
  float32 fold around Algorithm 2's result in float64
  (``reference/fold.py``): 0 for a sound fold, 1 for a fold that leaves the
  base as it was.
"""

from __future__ import annotations

from fedbench import harness
from fedbench.reference import compare, fold

PROGRAM = "program"
HALF_BATCH = "half_batch"       # a fault planted in the reference in place
DROPPED_FOLD = "dropped_fold"   # the same: the fold leaves the base as it was


def _meta(m) -> tuple:
    return (m.samples_learned, m.epochs_learned, m.round)


def fold_readings(store, rec: harness.Recorder, precisions) -> dict:
    """``precisions`` may name ``PROGRAM``, a precision or ``DROPPED_FOLD``."""
    if not rec.folds:
        raise RuntimeError(
            f"no fold of the window was captured ({rec.fold_seen} seen): "
            f"the store folded nowhere that tap_folds reaches")
    if store.batch_aggregation:
        store.drain_all()       # what the window left queued
    bad = 0
    for (level, key), sums in rec.meta_sums.items():
        bad += list(_meta(store.meta(level, key))) != sums
    out = {p: {"meta_mismatches": float(bad), "fold_gap": 0.0}
           for p in precisions}
    for base, bmeta, ups, got, gmeta in rec.folds:
        b_leaves, u_leaves = harness.tree_leaves(base), [
            harness.tree_leaves(p) for p, _, _ in ups]
        g_leaves = harness.tree_leaves(got)
        metas = [(_meta(m), (d.samples_learned, d.epochs_learned, d.rounds))
                 for _, m, d in ups]
        counts = {p: [] for p in precisions}
        wmeta = None
        for i, b in enumerate(b_leaves):      # leaf by leaf: float64 fits
            args = ([b], _meta(bmeta),
                    [([u[i]], *mt) for u, mt in zip(u_leaves, metas)])
            (want,), wmeta = fold.fold(*args, cast=False)
            (mag,), _ = fold.fold(
                [b.abs()], _meta(bmeta),
                [([u[i].abs()], *mt) for u, mt in zip(u_leaves, metas)],
                cast=False)
            bnd = fold.bound(want, mag, 1 + len(ups), b.dtype)
            del mag
            for prec in precisions:
                leaf = (g_leaves[i] if prec == PROGRAM
                        else b if prec == DROPPED_FOLD
                        else fold.fold(*args, precision=prec)[0][0])
                counts[prec].append(fold.leaf_counts(leaf, want, b, bnd))
            del want, bnd
        for prec in precisions:
            o = out[prec]
            o["fold_gap"] = max(o["fold_gap"],
                                fold.worst_share(counts[prec]))
            o["meta_mismatches"] += (prec == PROGRAM
                                     and _meta(gmeta) != wmeta)
    return out


def update_readings(samples: list, start_of, program_of, reference_of,
                    precisions) -> dict:
    """``start_of(s)``: the sample's starting leaves; ``program_of(s)`` and
    ``reference_of(s, precision, half_batch=False)``: (losses, first-step
    gradient norms by leaf, final leaves).  ``precisions`` may name
    ``PROGRAM``, a precision, or ``HALF_BATCH``."""
    out = {p: {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
           for p in precisions}
    for s in samples:
        p0 = [x.float() for x in start_of(s)]
        w_loss, w_grad, w_final = reference_of(s, "float32")
        keep = compare.moving_leaves(w_grad)
        w_change = compare.norms([w.float() - a for w, a in zip(w_final, p0)])
        del w_final
        for prec in precisions:
            loss, grad, final = (
                program_of(s) if prec == PROGRAM else
                reference_of(s, "float32", True) if prec == HALF_BATCH
                else reference_of(s, prec))
            change = compare.norms([g.float() - a
                                    for g, a in zip(final, p0)])
            o = out[prec]
            o["loss_gap"] = max(o["loss_gap"], compare.loss_gap(loss, w_loss))
            o["grad_gap"] = max(o["grad_gap"], compare.norm_gap(grad, w_grad))
            o["change_gap"] = max(o["change_gap"],
                                  compare.norm_gap(change, w_change, keep))
    return out


def readings(cell, precisions) -> dict:
    """Every reading of ``cell`` (a driver's ``Cell``) for each of
    ``precisions``: the folds' first, while the store lives; then the
    program's state is freed and the sampled updates are recomputed."""
    fold_part = fold_readings(cell.fed.store, cell.rec,
                              [p for p in precisions if p != HALF_BATCH])
    cell.free()
    samples = [cell.rec.start_sample] + [s for s in cell.rec.samples
                                         if s is not None]
    upd = update_readings(samples, cell.start_of, cell.program_of,
                          cell.reference_of,
                          [p for p in precisions if p != DROPPED_FOLD])
    return {p: {**upd.get(p, {}), **fold_part.get(p, {})}
            for p in precisions}
