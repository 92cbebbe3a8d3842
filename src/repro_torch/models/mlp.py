"""Gated MLPs (SwiGLU / GeGLU)."""

from __future__ import annotations

from repro_torch.models.layers import activation, einsum
from repro_torch.sharding.logical import ParamSpec, constrain


def mlp_schema(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_forward(p: dict, x, act: str = "silu", rules=None):
    a = activation(act)
    h = a(einsum("bsd,df->bsf", x, p["w_gate"])) * einsum("bsd,df->bsf", x, p["w_up"])
    h = constrain(h, ("batch", "seq", "mlp"), rules)
    y = einsum("bsf,fd->bsd", h, p["w_down"])
    return constrain(y, ("batch", "seq", "embed"), rules)
