"""Rounding of a product's operands, for the references and their controls.

The references compute in float32 with TF32 off.  A control computes the
same function in the precision just below the configuration's: TF32 for a
float32 configuration, fp8 (e4m3) for a bfloat16 one.  The rounding is
emulated on the operands of every product, so a control reads the same on
any device.  Autograd sees the rounding as the identity (straight-through),
so a control's backward runs on the rounded forward's values.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32", "bfloat16", "fp8")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 with its mantissa rounded to TF32's 10 bits (to nearest)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return _tf32(x)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision == "fp8":
        return x.float().clamp(-448.0, 448.0).to(
            torch.float8_e4m3fn).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def rounder(precision: str):
    """``q(x)``: ``x`` rounded to ``precision`` in the forward, its gradient
    passed through unchanged; the identity for float32."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; known: "
                         f"{PRECISIONS}")
    if precision == "float32":
        return lambda x: x

    def q(x):
        return x + (_round(x.detach(), precision) - x.detach())

    return q


def exact_matmuls():
    """TF32 off for the process: a float32 product stays float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
