"""Client-side DP update privatization (clip-by-global-norm + Gaussian noise).

The client never ships its trained parameters directly: the update delta
``new_params - fetched_params`` is clipped to L2 norm ``clip`` and perturbed
with noise of std ``noise_multiplier * clip`` (the Abadi et al. DP-SGD
recipe, applied at update granularity as in DP-FedAvg).  The privatized
parameters the server sees are ``fetched_params + privatized_delta``.

The arithmetic is ``kernels.dp_clip_noise.ops.privatize_flat``: the CUDA
kernel for CUDA tensors, its plain version for CPU tensors.

Noise is drawn on the CPU by ``DPPrivatizer._noise`` from a
``torch.Generator`` seeded from ``(seed, step)`` through numpy's
``SeedSequence``, then moved to the delta's device, so runs are
deterministic given ``FedCCLConfig.seed`` and the CPU and CUDA routes add
identical noise.  The draws differ from the JAX package's PRNG by design;
tests that compare the two packages replace ``_noise`` with JAX's draw.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.dp_clip_noise.ops import privatize_flat
from repro_torch.utils.tree import flatten_params, unflatten_params


@dataclass(frozen=True)
class DPConfig:
    clip: float                      # L2 sensitivity of one update delta
    noise_multiplier: float = 1.0    # noise std = noise_multiplier * clip


def noise_seed(seed: int, step: int) -> int:
    """The 64-bit generator seed of release ``step`` of privatizer
    ``seed`` (``seed`` and ``step`` non-negative)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


class DPPrivatizer:
    """Per-client privatization hook plugged into ``Client.train_update``."""

    def __init__(self, cfg: DPConfig, client_id: str, seed: int = 0,
                 accountant=None):
        if cfg.clip <= 0:
            raise ValueError(f"dp clip must be positive, got {cfg.clip}")
        self.cfg = cfg
        self.client_id = client_id
        self.accountant = accountant
        self.seed = int(seed)
        self._step = 0

    def _noise(self, t: int) -> torch.Tensor:
        """Standard-normal (t,) f32 noise of the current release, on the
        CPU."""
        gen = torch.Generator().manual_seed(noise_seed(self.seed, self._step))
        return torch.randn(t, generator=gen, dtype=torch.float32)

    def privatize_delta(self, delta_flat: torch.Tensor,
                        model_key: str = "__global__") -> torch.Tensor:
        """Clip + noise one flat update delta and record the release with
        the accountant.  The flat form is the secure-aggregation fast path:
        masking happens in the same flat domain, so no tree round trip."""
        noise = self._noise(delta_flat.shape[0]).to(delta_flat.device)
        self._step += 1
        priv = privatize_flat(delta_flat, noise, self.cfg.clip,
                              self.cfg.noise_multiplier)
        if self.accountant is not None:
            self.accountant.record(self.client_id, model_key,
                                   self.cfg.noise_multiplier)
        return priv

    def privatize(self, fetched_params, new_params,
                  model_key: str = "__global__"):
        """Returns ``fetched_params + clip_noise(new_params - fetched_params)``
        as new tensors and records the release with the accountant."""
        fetched_flat = flatten_params(fetched_params)
        delta = flatten_params(new_params) - fetched_flat
        priv = self.privatize_delta(delta, model_key)
        return unflatten_params(fetched_flat + priv, fetched_params)
