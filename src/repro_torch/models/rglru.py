"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), with
a_t = exp(-c * softplus(Lambda) * r_t), r/i input-dependent sigmoid gates.
The full-sequence path is a log-depth scan in plain torch: the pairs (a, b)
compose as (a1*a2, a2*b1 + b2), doubled ceil(log2 L) times (a Hillis-Steele
scan; the reference's ``jax.lax.associative_scan`` computes the same
prefixes in another order of the same products); decode is a single-step
update with a constant-size state.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation, einsum
from repro_torch.sharding.logical import ParamSpec, constrain

_C = 8.0  # Griffin's gate sharpness constant


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = _lru_width(cfg)
    cw = cfg.rglru.conv_width
    return {
        "w_x": ParamSpec((d, w), ("embed", "lru")),
        "w_gate_branch": ParamSpec((d, w), ("embed", "lru")),
        "conv_w": ParamSpec((cw, w), ("conv", "lru"), scale=0.5),
        "conv_b": ParamSpec((w,), ("lru",), init="zeros"),
        "w_a": ParamSpec((w, w), ("lru", "lru"), scale=0.02),
        "b_a": ParamSpec((w,), ("lru",), init="zeros"),
        "w_i": ParamSpec((w, w), ("lru", "lru"), scale=0.02),
        "b_i": ParamSpec((w,), ("lru",), init="zeros"),
        "lamb": ParamSpec((w,), ("lru",), init="ones", dtype="float32"),
        "w_out": ParamSpec((w, d), ("lru", "embed")),
    }


def _conv1d(p, x, state=None):
    w = p["conv_w"].to(x.dtype)
    cw = w.shape[0]
    pad = (x.new_zeros((x.shape[0], cw - 1, x.shape[-1])) if state is None
           else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(cw))
    return out + p["conv_b"].to(out.dtype), xp[:, -(cw - 1):]


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(p, x):
    """a_t (log-space) and gated input."""
    f32 = torch.float32
    r = torch.sigmoid(einsum("bsw,wv->bsv", x, p["w_a"]).to(f32) + p["b_a"])
    i = torch.sigmoid(einsum("bsw,wv->bsv", x, p["w_i"]).to(f32) + p["b_i"])
    log_a = -_C * _softplus(p["lamb"]) * r                        # (b,s,w) <= 0
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-8)) * (
        i * x.to(f32))
    return a, gated_x


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0 along axis 1, in
    ceil(log2 L) doubling steps: after the step of stride d each position
    holds the composition of the d (then 2d) pairs ending there."""
    n = a.shape[1]
    d = 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < n:                   # the last step needs no products of a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_forward(cfg: ModelConfig, p: dict, x, *, rules=None,
                  state: dict | None = None):
    """x: (b, l, d_model) -> (y, new_state). state = {"conv", "h"}."""
    gate_branch = activation("gelu")(einsum("bsd,dw->bsw", x,
                                             p["w_gate_branch"]))
    u = einsum("bsd,dw->bsw", x, p["w_x"])
    u = constrain(u, ("batch", "seq", "lru"), rules)

    if state is None:
        u, _ = _conv1d(p, u)
        a, gx = _gates(p, u)
        h = linear_scan(a, gx)
        new_state = None
    else:
        u, conv_state = _conv1d(p, u, state["conv"])
        a, gx = _gates(p, u)
        h = a * state["h"].to(torch.float32)[:, None] + gx      # l == 1
        new_state = {"conv": conv_state, "h": h[:, -1].to(state["h"].dtype)}

    y = h.to(x.dtype) * gate_branch
    out = einsum("bsw,wd->bsd", y, p["w_out"])
    return constrain(out, ("batch", "seq", "embed"), rules), new_state


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    w = _lru_width(cfg)
    return {
        "conv": torch.zeros((batch, cfg.rglru.conv_width - 1, w), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, w), dtype=dtype, device=device),
    }
