"""Cache shape declarations (``meta`` tensors) for the decode dry-runs and
sharding-spec derivation for cache trees.  Specs are keyed off the cache
leaf *names* (k/v/c_kv/k_rope/conv/ssm/h), which is robust across families;
a leading scan-layers axis is detected by rank.
"""

from __future__ import annotations

import torch

from repro_torch.sharding.logical import PartitionSpec, Rules, logical_to_spec

# leaf name -> logical axes after the batch axis
_CACHE_LOGICAL = {
    "k": ("kv_seq", "kv_heads", "head_dim"),
    "v": ("kv_seq", "kv_heads", "head_dim"),
    "c_kv": ("kv_seq", "rank"),
    "k_rope": ("kv_seq", "head_dim"),
    "conv": ("state", "ssm_inner"),
    "ssm": ("heads", "head_dim", "state"),
    "h": ("lru",),
}


def cache_shapes(model, batch: int, max_len: int, dtype=torch.bfloat16):
    """``meta`` tensors matching ``model.init_caches`` (no allocation)."""
    return model.init_caches(batch, max_len, dtype, device="meta")


def cache_specs(cache_tree, rules: Rules):
    """PartitionSpec tree for a cache tree (shapes or tensors)."""

    def go(node, name):
        if isinstance(node, dict):
            return {k: go(v, k) for k, v in node.items()}
        logical = ("batch",) + _CACHE_LOGICAL.get(name, ())
        shp = tuple(node.shape)
        if len(shp) == len(logical) + 1:
            logical = ("layers",) + logical       # scanned segment stacking
        if len(shp) != len(logical):
            return PartitionSpec()
        return logical_to_spec(logical, rules, shp)

    return go(cache_tree, "")
