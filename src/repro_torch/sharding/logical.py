"""Parameter schemas: shape + logical axis names + init kind per leaf.

The port keeps the schema and its initializer; the mesh rules of the JAX
package (``PartitionSpec`` trees) arrive with the distribution slice.
Draws come from a ``torch.Generator`` on the CPU, in schema order, and are
then moved to the target device; they do not reproduce JAX's PRNG, so
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
    draw = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (draw * std).to(dtype)


def init_from_schema(schema: dict, generator: torch.Generator, device,
                     default_dtype: torch.dtype = torch.float32) -> dict:
    def go(node):
        return {k: (go(v) if isinstance(v, dict) else
                    _init_leaf(v, generator, default_dtype).to(device))
                for k, v in node.items()}

    return go(schema)
