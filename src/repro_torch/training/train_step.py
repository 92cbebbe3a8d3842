"""Evaluation step of the language models (batched scoring).

The training step waits for backward kernels of ``ssd_chunk`` and
``local_attn`` (the reference's kernels have none either) and ``optim/``;
see ``ROADMAP.md`` §1.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.training.losses import loss_for_batch


def build_eval_step(model, cfg: ModelConfig, *, rules=None):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_for_batch(model, cfg, params, batch, rules)
        return dict(metrics, loss=loss)

    return eval_step
