"""Parameter schemas: shape + logical axis names + init kind per leaf.

The port keeps the schema, its initializer, the scan-over-layers stacking
and the shapes; the mesh rules of the JAX package (``PartitionSpec`` trees)
arrive with the distribution slice, so ``constrain`` is the identity.
Draws are made on the given ``torch.Generator``'s own device (a CUDA
generator fills a full-width model on the card), in schema order, then
cast and placed on the target device; they do not reproduce JAX's PRNG, so
parity runs pass JAX-initialised params through the weights bridge
(``utils.tree.params_from_numpy``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float | None = None    # stddev override
    dtype: str | None = None


def _init_leaf(ps: ParamSpec, generator: torch.Generator,
               default_dtype: torch.dtype) -> torch.Tensor:
    dtype = getattr(torch, ps.dtype) if ps.dtype else default_dtype
    shape = tuple(ps.shape)
    if ps.init == "zeros":
        return torch.zeros(shape, dtype=dtype)
    if ps.init == "ones":
        return torch.ones(shape, dtype=dtype)
    if ps.init == "embed":
        std = ps.scale if ps.scale is not None else 1.0
    else:
        fan_in = (int(np.prod(shape[:-1])) if len(shape) >= 2
                  else max(1, shape[0] if shape else 1))
        std = ps.scale if ps.scale is not None else \
            1.0 / max(1.0, np.sqrt(fan_in))
    # drawn on the generator's own device: a CUDA generator fills a
    # multi-billion-parameter model on the card
    draw = torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
    return (draw * std).to(dtype)


def init_from_schema(schema: dict, generator: torch.Generator, device,
                     default_dtype: torch.dtype = torch.float32) -> dict:
    def go(node):
        return {k: (go(v) if isinstance(v, dict) else
                    _init_leaf(v, generator, default_dtype).to(device))
                for k, v in node.items()}

    return go(schema)


def schema_shapes(schema: dict, default_dtype: torch.dtype = torch.float32) -> dict:
    """The schema as ``meta`` tensors: shapes and dtypes, no storage."""
    def go(node):
        return {k: (go(v) if isinstance(v, dict) else
                    torch.empty(tuple(v.shape), device="meta",
                                dtype=getattr(torch, v.dtype) if v.dtype
                                else default_dtype))
                for k, v in node.items()}

    return go(schema)


def stack_schema(schema: dict, n: int) -> dict:
    """Prepend a scanned 'layers' axis to every leaf (scan-over-layers).
    The initializer's fan-in of a stacked matrix then includes the layer
    axis (``prod(shape[:-1])``), as in the reference."""

    def go(node):
        return {
            k: (go(v) if isinstance(v, dict) else
                ParamSpec((n,) + tuple(v.shape), ("layers",) + tuple(v.logical),
                          v.init, v.scale, v.dtype))
            for k, v in node.items()
        }

    return go(schema)


def constrain(x, logical: tuple, rules=None):
    """Sharding constraint by logical axes: the identity until the port has
    a device mesh."""
    return x
