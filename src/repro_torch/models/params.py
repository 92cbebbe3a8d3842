"""Analytic parameter counts (for MODEL_FLOPS = 6*N*D roofline terms).

Counts are derived from the *schema*, so they are exact by construction and
allocate nothing; ``active_only`` subtracts non-activated routed experts
(MoE) for the 6*N_active*D convention.
"""

from __future__ import annotations

import numpy as np


def _schema_count(schema) -> int:
    total = 0
    for v in schema.values():
        if isinstance(v, dict):
            total += _schema_count(v)
        else:
            total += int(np.prod(v.shape))
    return total


def count_params_analytic(cfg, active_only: bool = False,
                          include_embed: bool = False) -> int:
    from repro_torch.models.model import LanguageModel

    model = LanguageModel(cfg)
    sch = model.schema()
    total = _schema_count(sch)
    embed = int(np.prod(sch["embed"].shape))
    head = int(np.prod(sch["head"].shape)) if "head" in sch else 0
    if not include_embed:
        total -= embed + head

    if active_only and cfg.is_moe:
        m = cfg.moe
        # each routed expert: 3 matrices d x moe_ff
        per_expert = 3 * cfg.d_model * m.moe_d_ff
        n_moe_layers = cfg.n_layers - m.first_k_dense
        inactive = (m.n_routed_experts - m.top_k) * per_expert * n_moe_layers
        total -= inactive
    return total
