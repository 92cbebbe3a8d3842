"""The language-model traffic: Zipfian token rows with a copy pattern.

A frozen copy of the port's ``repro_torch.data.lm_synth.lm_batch``, kept
beside the benchmark so that a change to the program cannot change what
the benchmark feeds it.  With ``structure=1.0`` every row carries the copy
pattern ``t[i] = t[i - seq // 8]``, so the model has something to learn.
"""

from __future__ import annotations

import numpy as np


def zipf_probs(vocab: int, alpha: float = 1.2) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -alpha
    return p / p.sum()


def lm_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int,
             structure: float = 1.0, probs: np.ndarray | None = None) -> dict:
    """tokens (batch, seq) and next-token labels, int32.  ``probs`` (from
    ``zipf_probs``) may be passed to skip recomputing them; the draws are
    the same either way."""
    p = zipf_probs(vocab) if probs is None else probs
    toks = rng.choice(vocab, size=batch * (seq + 1), p=p).astype(np.int32)
    toks = toks.reshape(batch, seq + 1)
    period = max(2, seq // 8)
    for b in range(batch):
        if rng.random() < structure:
            toks[b, period:] = toks[b, :-period]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}
