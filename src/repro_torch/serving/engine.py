"""Serving engine: prefill + batched autoregressive decode.

``build_decode_step`` returns the single-token step.  ``ServeEngine`` is
the example-scale driver: prefill by replaying prompt tokens through the
decode step (correct for every family, including SSM and RG-LRU states and
rolling local caches), then greedy or temperature sampling.  As in the
reference, serving runs neither kernel of the full-sequence forward: decode
attends over the cache with the einsum ``_sdpa`` (MLA over its latent
cache) and steps the SSM and RG-LRU recurrences.  Greedy decoding matches
the reference token for token; temperature sampling draws from a
``torch.Generator`` and does not reproduce JAX's PRNG.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def build_decode_step(model, *, rules=None, window_override=None,
                      mla_absorb: bool = True):
    @torch.no_grad()
    def decode_step(params, caches, tokens, pos):
        return model.decode_step(params, caches, tokens, pos, rules=rules,
                                 window_override=window_override,
                                 mla_absorb=mla_absorb)

    return decode_step


def _merge(*xs):
    # scan-stacked leaves: (layers, 1, ...) -> concat axis 1; unrolled
    # leaves: (1, ...) -> axis 0
    ax = 1 if (xs[0].dim() >= 3 and xs[0].shape[1] == 1) else 0
    return torch.cat(xs, dim=ax)


@dataclass
class ServeEngine:
    model: object
    params: object
    max_len: int = 512
    temperature: float = 0.0
    cache_dtype: torch.dtype = torch.float32
    mla_absorb: bool = True

    def __post_init__(self):
        self._step = build_decode_step(self.model, mla_absorb=self.mla_absorb)
        self.device = self.params["embed"].device

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).long()

    def _sample(self, logits, gen):
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32) / self.temperature, -1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def generate(self, prompts, n_new: int, seed: int = 0) -> np.ndarray:
        """prompts: (b, p) ints.  Returns (b, n_new) generated int32 tokens."""
        toks = self._tokens(prompts)
        b, p = toks.shape
        caches = self.model.init_caches(b, self.max_len, self.cache_dtype,
                                        self.device)
        logits = None
        for t in range(p):                      # prefill by replay
            logits, caches = self._step(self.params, caches, toks[:, t:t + 1], t)
        gen = self._generator(seed)
        out = []
        tok = self._sample(logits[:, -1], gen)
        for i in range(n_new):
            out.append(tok)
            logits, caches = self._step(self.params, caches, tok[:, None], p + i)
            tok = self._sample(logits[:, -1], gen)
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)

    # ------------------------------------------------------ continuous batch
    def generate_ragged(self, prompts: list, n_new: int) -> np.ndarray:
        """Continuous batching: prompts of different lengths decode together,
        each at its own cache offset (pos is a (b,) vector).  Prefill per
        request (decode-step replay), merge caches, batched ragged decode."""
        caches_list, last_logits = [], []
        for prompt in prompts:
            toks = self._tokens(prompt)[None]
            c = self.model.init_caches(1, self.max_len, self.cache_dtype,
                                       self.device)
            lg = None
            for t in range(toks.shape[1]):
                lg, c = self._step(self.params, c, toks[:, t:t + 1], t)
            caches_list.append(c)
            last_logits.append(lg[:, -1])

        caches = tree_map(_merge, *caches_list)
        pos = torch.as_tensor([len(p) for p in prompts], device=self.device)
        gen = self._generator(0)
        tok = self._sample(torch.cat(last_logits, 0), gen)
        out = []
        for i in range(n_new):
            out.append(tok)
            logits, caches = self._step(self.params, caches, tok[:, None],
                                        pos + i)
            tok = self._sample(logits[:, -1], gen)
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
