"""FedCCL model aggregation — paper Algorithm 2, verbatim semantics.

``AggregateModels(w_base, w_updated, delta_new)``:
  * sequential fast path: if ``w_updated.round == w_base.round + 1`` the
    update was computed against the current base — return it unchanged;
  * otherwise layer-wise weighted average with weights proportional to
    ``samples_learned`` of each side, then metadata accumulation.

The metadata arithmetic (``ModelMeta``, ``plan_coalesce``, ``_pad_pow2``)
is the reference's, exactly.  Every weighted sum goes through
``kernels.fedavg_agg.ops.aggregate_pytrees``: one fold kernel launch on
CUDA tensors, the plain version on CPU tensors.  Sums build new tensors;
nothing here updates a parameter in place.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.kernels.fedavg_agg.ops import aggregate_pytrees


@dataclass(frozen=True)
class ModelMeta:
    """Server-side metadata ridden along with every model (paper §II.D)."""

    samples_learned: int = 0
    epochs_learned: int = 0
    round: int = 0

    def accumulate(self, delta: "UpdateDelta") -> "ModelMeta":
        return ModelMeta(
            samples_learned=self.samples_learned + delta.samples_learned,
            epochs_learned=self.epochs_learned + delta.epochs_learned,
            round=self.round + delta.rounds,
        )


@dataclass(frozen=True)
class UpdateDelta:
    """ComputeModelMetaDelta() result: what the client *added* this round."""

    samples_learned: int
    epochs_learned: int = 1
    rounds: int = 1


@dataclass(frozen=True)
class AggregationConfig:
    sequential_fast_path: bool = True


def _pad_pow2(sets, ws):
    """Pad an N-way weighted sum to the next power-of-two arity with
    zero-weight copies of the first set.  A zero-weight term contributes an
    exact ``0.0f`` to the f32 accumulation, so the result is unchanged.
    Kept so the port folds the same N-way sums as the reference."""
    n = len(sets)
    bucket = 1 << (n - 1).bit_length()
    if bucket == n:
        return list(sets), list(ws)
    pad = bucket - n
    return list(sets) + [sets[0]] * pad, list(ws) + [0.0] * pad


def aggregate_models(base_params, base_meta: ModelMeta, updated_params,
                     updated_meta: ModelMeta, delta: UpdateDelta,
                     cfg: AggregationConfig = AggregationConfig()):
    """Returns (params, meta) — Algorithm 2."""
    if cfg.sequential_fast_path and updated_meta.round == base_meta.round + 1:
        return updated_params, base_meta.accumulate(delta)

    samples_total = base_meta.samples_learned + updated_meta.samples_learned
    if samples_total <= 0:
        return updated_params, base_meta.accumulate(delta)
    ratio_base = base_meta.samples_learned / samples_total
    agg = aggregate_pytrees([base_params, updated_params],
                            [ratio_base, 1.0 - ratio_base])
    return agg, base_meta.accumulate(delta)


def multi_aggregate(param_sets, sample_counts,
                    cfg: AggregationConfig = AggregationConfig()):
    """N-way sample-weighted average (synchronous-FedAvg baseline and the
    server catch-up path when several updates queued behind one lock)."""
    if not param_sets:
        raise ValueError("multi_aggregate needs at least one parameter set")
    if len(param_sets) != len(sample_counts):
        raise ValueError(
            f"{len(param_sets)} parameter sets vs {len(sample_counts)} counts")
    total = float(sum(sample_counts))
    if total <= 0:
        # fresh clients with empty datasets: no sample mass, uniform weights
        ws = [1.0 / len(sample_counts)] * len(sample_counts)
    else:
        ws = [c / total for c in sample_counts]
    if len(param_sets) == 1:
        return param_sets[0]
    sets, ws = _pad_pow2(list(param_sets), ws)
    return aggregate_pytrees(sets, ws)


@dataclass(frozen=True)
class CoalesceResult:
    params: object
    meta: ModelMeta
    n_folded: int        # queued updates consumed
    n_param_sets: int    # parameter sets in the final weighted sum
    n_fast_path: int     # updates that hit the sequential fast path
    n_partials: int = 0  # shard partial sums feeding the two-level merge


@dataclass(frozen=True)
class CoalescePlan:
    """The scalar half of a coalesced fold: the telescoped convex weight each
    parameter set carries in the final sum, separated from the tree
    arithmetic so the sums can be computed in one flat N-way call or
    partitioned across shards (``two_level_coalesced_aggregate``).

    ``weights[0]`` belongs to the base; ``weights[1 + i]`` to update ``i`` in
    fold order.  A sequential-fast-path or zero-sample reset zeroes every
    weight before it — exactly the "discard and restart" of the pairwise
    Algorithm-2 fold.
    """

    weights: tuple      # len(updates) + 1 convex coefficients, resets zeroed
    meta: ModelMeta     # fully accumulated metadata
    n_fast_path: int


def plan_coalesce(base_meta: ModelMeta, meta_deltas,
                  cfg: AggregationConfig = AggregationConfig()) -> CoalescePlan:
    """Walk the fold's metadata only: ``meta_deltas`` is a sequence of
    ``(meta, delta)`` pairs in fold order.  Float operations replicate the
    incremental ``f *= ratio_base`` telescoping of the sequential fold so the
    planned weights are bit-identical to the ones the flat fold would use."""
    meta = base_meta
    weights = [1.0]
    active = [0]          # indices in `weights` still contributing
    n_fast = 0
    for i, (upd_meta, delta) in enumerate(meta_deltas):
        if cfg.sequential_fast_path and upd_meta.round == meta.round + 1:
            for j in active:
                weights[j] = 0.0
            weights.append(1.0)
            active = [i + 1]
            n_fast += 1
        else:
            total = meta.samples_learned + upd_meta.samples_learned
            if total <= 0:
                for j in active:
                    weights[j] = 0.0
                weights.append(1.0)
                active = [i + 1]
            else:
                rb = meta.samples_learned / total
                for j in active:
                    weights[j] *= rb
                weights.append(1.0 - rb)
                active.append(i + 1)
        meta = meta.accumulate(delta)
    return CoalescePlan(tuple(weights), meta, n_fast)


def coalesced_aggregate(base_params, base_meta: ModelMeta, updates,
                        cfg: AggregationConfig = AggregationConfig()) -> CoalesceResult:
    """Fold N queued updates (FIFO order) into at most one N-way weighted sum.

    Equivalent to folding each update through ``aggregate_models`` in
    arrival order: the pairwise sample-weighted averages of Algorithm 2
    telescope, so the whole batch costs one ``multi_aggregate`` call (one
    kernel launch on CUDA).  ``updates`` is a sequence of
    ``(params, meta, delta)`` triples.
    """
    updates = list(updates)      # consumed twice; accept one-shot iterables
    plan = plan_coalesce(base_meta, [(m, d) for _, m, d in updates], cfg)
    all_params = [base_params] + [p for p, _, _ in updates]
    sets = [p for p, w in zip(all_params, plan.weights, strict=True) if w != 0.0]
    fracs = [w for w in plan.weights if w != 0.0]
    if len(sets) == 1:
        return CoalesceResult(sets[0], plan.meta, len(updates), 1,
                              plan.n_fast_path)
    return CoalesceResult(multi_aggregate(sets, fracs, cfg), plan.meta,
                          len(updates), len(sets), plan.n_fast_path)


def chunked_convex_reduce(entries, max_width: int,
                          cfg: AggregationConfig = AggregationConfig()):
    """Reduce a ``(params, mass)`` list so every fused sum is at most
    ``max_width`` wide; returns a (possibly shorter) ``(params, mass)``
    list.  Nested mass-weighted convex averages recombine exactly (the same
    telescoping the flat fold relies on), so chunk boundaries are free.
    ``max_width <= 0`` disables chunking (the list is returned unchanged).
    Each chunk of more than one entry is one ``multi_aggregate`` call: one
    fold kernel launch on CUDA."""
    # chunks of one entry never shrink the list — a width of 1 must still
    # fold pairs to make progress
    width = max(max_width, 2) if max_width > 0 else 0
    if width <= 0 or len(entries) <= width:
        return list(entries)
    out = []
    for i in range(0, len(entries), width):
        chunk = entries[i:i + width]
        mass = sum(m for _, m in chunk)
        if mass == 0.0:
            continue
        p = (chunk[0][0] if len(chunk) == 1 else
             multi_aggregate([p for p, _ in chunk],
                             [m for _, m in chunk], cfg))
        out.append((p, mass))
    return chunked_convex_reduce(out, max_width, cfg)


def two_level_coalesced_aggregate(base_params, base_meta: ModelMeta,
                                  shard_batches,
                                  cfg: AggregationConfig = AggregationConfig(),
                                  *, seqs=None,
                                  max_width: int = 0) -> CoalesceResult:
    """Sharded two-level fold: per-shard coalesced partials reduced by a
    sample-weighted cross-shard merge.

    ``shard_batches[k]`` is shard *k*'s FIFO batch of ``(params, meta,
    delta)`` triples; ``seqs[k]`` (optional, parallel structure) carries
    global arrival sequence numbers.  The fold order is the seq-sorted
    concatenation (shard-index concatenation when ``seqs`` is None).

    The flat telescoped fold ends at ``w0·base + Σ wi·pi`` with
    coefficients that depend only on the metadata sequence
    (``plan_coalesce``).  The plan is computed once over the full fold
    order; each shard reduces its own members to a convex partial
    ``P_k = Σ_{i∈k} (wi/W_k)·pi`` of mass ``W_k = Σ_{i∈k} wi``, and the
    merge ``w0·base + Σ_k W_k·P_k`` restores the flat sum: equal in real
    arithmetic, within float-summation reorder in f32.  Resets (fast path
    / zero-sample) zero coefficients across shard boundaries through the
    shared plan.  ``max_width`` > 0 bounds every fused sum's arity.

    The lone-survivor passthrough returns the client's own tree: safe
    because nothing in the port updates a tensor in place.
    """
    flat = []            # (order_key, shard_idx, params, meta, delta)
    for k, batch in enumerate(shard_batches):
        for j, (p, m, d) in enumerate(batch):
            key = seqs[k][j] if seqs is not None else (k, j)
            flat.append((key, k, p, m, d))
    flat.sort(key=lambda e: e[0])
    if not flat:
        return CoalesceResult(base_params, base_meta, 0, 1, 0)
    plan = plan_coalesce(base_meta, [(m, d) for _, _, _, m, d in flat], cfg)

    # gather each shard's surviving (params, weight) members in fold order
    per_shard: dict[int, list] = {}
    for (_, k, p, _, _), w in zip(flat, plan.weights[1:], strict=True):
        if w != 0.0:
            per_shard.setdefault(k, []).append((p, w))

    base_w = plan.weights[0]
    if not per_shard:    # no surviving updates => the base carries weight 1
        return CoalesceResult(base_params, plan.meta, len(flat), 1,
                              plan.n_fast_path)
    if base_w == 0.0 and sum(len(v) for v in per_shard.values()) == 1:
        # lone fast-path / replace survivor: exact passthrough, no float math
        (p, _), = next(iter(per_shard.values()))
        return CoalesceResult(p, plan.meta, len(flat), 1, plan.n_fast_path)

    partials = []        # (partial_params, mass) — convex within, mass to merge
    for k in sorted(per_shard):
        for p, mass in chunked_convex_reduce(per_shard[k], max_width, cfg):
            if mass != 0.0:
                partials.append((p, mass))
    # the merge is arity-bounded the same way (the base rides along as a
    # mass-weighted entry, so deep multi-shard backlogs never widen one sum)
    entries = ([(base_params, base_w)] if base_w != 0.0 else []) + partials
    n_sets = len(entries)
    width = max(max_width, 2) if max_width > 0 else 0
    while len(entries) > 1:
        if width <= 0 or len(entries) <= width:
            entries = [(multi_aggregate([p for p, _ in entries],
                                        [m for _, m in entries], cfg),
                        sum(m for _, m in entries))]
        else:
            entries = chunked_convex_reduce(entries, max_width, cfg)
    return CoalesceResult(entries[0][0], plan.meta, len(flat), n_sets,
                          plan.n_fast_path, n_partials=len(partials))


def secure_coalesced_aggregate(base_params, base_meta: ModelMeta,
                               masked_updates,
                               cfg: AggregationConfig = AggregationConfig(),
                               correction=None) -> CoalesceResult:
    """Secure-aggregation drain: fold one full round of masked updates.

    ``masked_updates`` is a sequence of ``(masked_weighted_delta, delta)``
    pairs where ``masked_weighted_delta = s_i * delta_i + pairwise masks``
    (see ``repro_torch.privacy.secure_agg``).  The result is

        base + (sum_i y_i - correction) / sum_i s_i

    computed as ONE fused N-way weighted sum (weights ``[1, 1/S, ..., 1/S,
    -1/S]``, one fold kernel launch on CUDA), so the pairwise masks cancel
    inside the sum and no individual update is ever unmasked.
    ``correction`` is the reconstructed stray-mask sum for dropped clients
    (None when the round is complete).
    """
    meta = base_meta
    total = 0
    for _, delta in masked_updates:
        meta = meta.accumulate(delta)
        total += delta.samples_learned
    if not masked_updates or total <= 0:
        # zero sample mass: no delta information to fold, keep the base
        # (masks only ever enter scaled by 1/total, so nothing leaks)
        return CoalesceResult(base_params, meta, len(masked_updates), 1, 0)
    inv = 1.0 / total
    sets = [base_params] + [y for y, _ in masked_updates]
    ws = [1.0] + [inv] * len(masked_updates)
    if correction is not None:
        sets.append(correction)
        ws.append(-inv)
    n_sets = len(sets)
    sets, ws = _pad_pow2(sets, ws)
    return CoalesceResult(aggregate_pytrees(sets, ws), meta,
                          len(masked_updates), n_sets, 0)
