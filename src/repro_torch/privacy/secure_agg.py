"""Mask-based secure aggregation (Bonawitz et al.-style pairwise masking).

Each ordered client pair (i, j) of a round shares a mask seed; client i adds
``+m_ij`` and client j adds ``-m_ij`` to its submission, so the masks cancel
*inside* the server's single fused N-way sum (``secure_coalesced_aggregate``)
when every round participant is present — the server only ever sees masked
individual updates, never an unmasked one.

Because Algorithm-2 weights are server-side sample ratios the clients cannot
know, the masked quantity is the *weighted delta*: client i submits

    y_i = s_i * privatized_delta_i + sum_j sign(i,j) * m_ij

and the drain computes ``base + (sum_i y_i) / (sum_i s_i)`` — a plain sum in
which the masks cancel, divided by publicly known sample counts.

Dropout recovery: masks are derived from per-pair seeds w.r.t. the
*expected* member set, so when a client drops mid-round the survivors'
stray masks no longer cancel.  The dealer reconstructs exactly those stray
masks from the pair seeds (``reconstruct``) and the drain subtracts them
inside the same fused sum.

The masks are drawn with numpy, in the JAX package's dtype arithmetic, so
they come out bit-identical to the reference's; only the final masked sum
is a tensor on the delta's device.  ``PairwiseMasker`` plays the trusted
dealer that real deployments replace with pairwise Diffie-Hellman key
agreement plus Shamir-shared seed recovery.  Masks are f32 Gaussians
(``mask_scale`` std); ``mask_scale=0`` degrades to the unmasked secure path.
A fixed-std mask only hides the weighted delta if ``mask_scale`` is set
commensurate with ``n_samples * dp_clip``; the default 1.0 is a correctness
setting for the cancellation arithmetic, not a calibrated hiding guarantee.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from repro_torch.utils.tree import flatten_params, tree_leaves, unflatten_params


def _pair_seed(master: int, a: str, b: str, round_id: int, model_key: str):
    """Deterministic seed sequence for the (a, b) pair's round mask; both
    sides derive the identical sequence (ids are sorted)."""
    lo, hi = sorted((a, b))
    return [master, zlib.crc32(lo.encode()), zlib.crc32(hi.encode()),
            round_id, zlib.crc32(model_key.encode())]


class PairwiseMasker:
    """Pairwise mask generator + dropout-recovery reconstructor."""

    def __init__(self, seed: int = 0, mask_scale: float = 1.0):
        self.seed = int(seed)
        self.mask_scale = float(mask_scale)

    def _pair_mask(self, a: str, b: str, round_id: int, model_key: str,
                   t: int) -> np.ndarray:
        rng = np.random.default_rng(
            _pair_seed(self.seed, a, b, round_id, model_key))
        return rng.standard_normal(t, dtype=np.float32) * \
            np.float32(self.mask_scale)

    def mask_flat(self, client_id: str, participants, round_id: int,
                  model_key: str, t: int) -> np.ndarray:
        """Sum of this client's signed pairwise masks w.r.t. ``participants``
        (the round's expected member set, dropouts included)."""
        total = np.zeros(t, np.float32)
        if self.mask_scale == 0.0:
            return total
        for other in participants:
            if other == client_id:
                continue
            sign = 1.0 if client_id < other else -1.0
            total += sign * self._pair_mask(client_id, other, round_id,
                                            model_key, t)
        return total

    def mask_delta_flat(self, delta_flat: torch.Tensor, client_id: str,
                        participants, round_id: int, model_key: str,
                        weight: float) -> torch.Tensor:
        """Client-side masking in the flat domain:
        ``weight * delta + signed masks``, on the delta's device."""
        mask = self.mask_flat(client_id, participants, round_id, model_key,
                              delta_flat.shape[0])
        return delta_flat * float(weight) + \
            torch.from_numpy(mask).to(delta_flat.device)

    def mask_update(self, base_params, new_params, client_id: str,
                    participants, round_id: int, model_key: str,
                    weight: float):
        """Tree convenience over ``mask_delta_flat``: masks
        ``weight * (new - base)``, returned shaped like ``base_params``."""
        delta = flatten_params(new_params) - flatten_params(base_params)
        return unflatten_params(
            self.mask_delta_flat(delta, client_id, participants, round_id,
                                 model_key, weight), base_params)

    def reconstruct_flat(self, t: int, missing_ids, survivor_ids,
                         round_id: int, model_key: str) -> np.ndarray:
        """Seed-reconstruction recovery: the sum of every stray mask the
        survivors included w.r.t. the dropped clients.  The drain subtracts
        it inside the same fused sum to restore exact cancellation.  Mask
        seeds are keyed by ``(pair, round, model_key)``, so one model's
        recovery never touches another model's round."""
        total = np.zeros(t, np.float32)
        if self.mask_scale != 0.0:
            for dropped in missing_ids:
                for survivor in survivor_ids:
                    sign = 1.0 if survivor < dropped else -1.0
                    total += sign * self._pair_mask(survivor, dropped,
                                                    round_id, model_key, t)
        return total

    def reconstruct(self, template_params, missing_ids, survivor_ids,
                    round_id: int, model_key: str):
        """Tree convenience over ``reconstruct_flat``, shaped like
        ``template_params`` and on its device."""
        leaves = tree_leaves(template_params)
        t = sum(x.numel() for x in leaves)
        flat = torch.from_numpy(self.reconstruct_flat(
            t, missing_ids, survivor_ids, round_id, model_key))
        return unflatten_params(flat.to(leaves[0].device), template_params)
