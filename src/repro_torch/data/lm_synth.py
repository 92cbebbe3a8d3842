"""Synthetic token / embedding data for the assigned-architecture smoke

tests, examples and the federated-LLM demo.  Token streams are Zipfian with
injected n-gram structure (so small models can measurably learn); audio/VLM
stubs hand back frame/patch embeddings per the harness carve-out.
"""

from __future__ import annotations

import numpy as np


def zipf_tokens(rng: np.random.Generator, n: int, vocab: int,
                alpha: float = 1.2) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -alpha
    p /= p.sum()
    return rng.choice(vocab, size=n, p=p).astype(np.int32)


def lm_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int,
             structure: float = 0.5) -> dict:
    """tokens + next-token labels; `structure` blends in a copy pattern so
    there is learnable signal (t[i] = t[i - period])."""
    toks = zipf_tokens(rng, batch * (seq + 1), vocab).reshape(batch, seq + 1)
    period = max(2, seq // 8)
    for b in range(batch):
        if rng.random() < structure:
            toks[b, period:] = toks[b, :-period]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}


def audio_batch(rng: np.random.Generator, batch: int, seq: int, embed_dim: int,
                vocab: int, mask_prob: float = 0.15) -> dict:
    """HuBERT-style masked-prediction batch: frame embeddings with latent
    cluster structure; labels are the latent codes."""
    codes = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    codebook = rng.standard_normal((vocab, embed_dim)).astype(np.float32)
    embeds = codebook[codes] + 0.3 * rng.standard_normal(
        (batch, seq, embed_dim)).astype(np.float32)
    mask = rng.random((batch, seq)) < mask_prob
    return {"embeds": embeds, "mask": mask, "labels": codes}


def vlm_batch(rng: np.random.Generator, batch: int, seq: int, n_patches: int,
              patch_dim: int, vocab: int) -> dict:
    """VLM batch: stub patch embeddings + text tokens; loss on text only."""
    text_len = seq - n_patches
    toks = zipf_tokens(rng, batch * (text_len + 1), vocab).reshape(batch, text_len + 1)
    return {
        "patches": rng.standard_normal((batch, n_patches, patch_dim)).astype(np.float32),
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:].astype(np.int32),
    }
