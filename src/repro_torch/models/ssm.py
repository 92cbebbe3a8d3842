"""Mamba-2 block via State-Space Duality (SSD), arXiv:2405.21060.

Training/prefill uses the chunked SSD algorithm (intra-chunk attention-like
products + inter-chunk recurrence) — O(L * chunk) memory; its intra-chunk
part is the ``ssd_chunk`` kernel on CUDA (``kernels/ssd_chunk``) and the
kernel's plain version on the CPU.  Decode keeps a constant-size recurrent
state per layer.  ``ssd_chunked`` here is the plain whole-scan oracle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_chunk.ops import ssd_chunked_fused
from repro_torch.models.layers import einsum
from repro_torch.sharding.logical import ParamSpec, constrain


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads


def ssm_schema(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nh = _dims(cfg)
    g, n = s.n_groups, s.d_state
    conv_dim = d_inner + 2 * g * n
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "w_in": ParamSpec((d, 2 * d_inner + 2 * g * n + nh), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((s.conv_width, conv_dim), ("conv", "ssm_inner"), scale=0.5),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((nh,), ("heads",), init="zeros", dtype="float32"),
        "dt_bias": ParamSpec((nh,), ("heads",), init="zeros", dtype="float32"),
        "d_skip": ParamSpec((nh,), ("heads",), init="ones", dtype="float32"),
        "norm": ParamSpec((d_inner,), ("ssm_inner",), init="ones", dtype="float32"),
        "w_out": ParamSpec((d_inner, d), ("ssm_inner", "embed")),
    }


def _segsum(x):
    """x: (..., l) -> cumulative-sum differences (..., l, l), lower-tri."""
    l = x.shape[-1]
    xc = torch.cumsum(x, -1)
    diff = xc[..., :, None] - xc[..., None, :]
    mask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, torch.full_like(diff, -torch.inf))


def _gated_rmsnorm(y, z, scale, eps=1e-6):
    yf = (y * F.silu(z)).to(torch.float32)
    var = torch.mean(torch.square(yf), -1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _split_proj(cfg, zxbcdt):
    s = cfg.ssm
    d_inner, nh = _dims(cfg)
    g, n = s.n_groups, s.d_state
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * g * n, nh], dim=-1)


def _causal_conv(cfg, p, xBC, conv_state=None):
    """Depthwise causal conv1d over sequence.  Returns (out, new_state).
    The taps are summed in the reference's order (``sum`` from tap 0)."""
    w = p["conv_w"].to(xBC.dtype)                              # (cw, conv_dim)
    cw = w.shape[0]
    if conv_state is None:
        pad = xBC.new_zeros((xBC.shape[0], cw - 1, xBC.shape[-1]))
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                          # (b, l+cw-1, cd)
    out = sum(xp[:, i:i + xBC.shape[1]] * w[i] for i in range(cw))
    out = F.silu(out + p["conv_b"].to(out.dtype))
    new_state = xp[:, -(cw - 1):]
    return out, new_state


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """Plain SSD chunked scan (the reference's oracle).  x: (b,l,h,p),
    dt: (b,l,h), A: (h,), B,C: (b,l,g,n).  Returns (y, final_state
    (b,h,p,n))."""
    b, l, h, pdim = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    L = l + pad
    c = L // chunk
    rep = h // g

    xc = x.reshape(b, c, chunk, h, pdim)
    dtc = dt.reshape(b, c, chunk, h)
    Bh = B.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3)

    dA = dtc * A[None, None, None, :]                           # (b,c,l,h)
    dA_t = dA.permute(0, 3, 1, 2)                               # (b,h,c,l)
    dA_cum = torch.cumsum(dA_t, -1)

    # 1) intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(dA_t))                             # (b,h,c,l,l)
    xdt = xc * dtc[..., None]
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Ch, Bh, Lmat, xdt)

    # 2) chunk states
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)         # (b,h,c,l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay_states, xdt)

    # 3) inter-chunk recurrence over c
    chunk_decay = torch.exp(dA_cum[..., -1])                    # (b,h,c)
    carry = (x.new_zeros((b, h, pdim, n)) if init_state is None
             else init_state)
    prev = []
    for ci in range(c):
        prev.append(carry)                                      # state *before* chunk
        carry = carry * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                      # (b,c,h,p,n)

    # 4) state -> output contribution
    state_decay_out = torch.exp(dA_cum)                         # (b,h,c,l)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, prev_states,
                         state_decay_out)

    y = (y_diag + y_off).reshape(b, L, h, pdim)
    return y[:, :l], carry


def ssm_forward(cfg: ModelConfig, p: dict, x, *, rules=None,
                state: dict | None = None):
    """Mamba-2 mixer.  state=None: full-sequence (chunked SSD, the
    ``ssd_chunk`` kernel on CUDA).  state given: single-step recurrent
    decode; returns (y, new_state)."""
    s = cfg.ssm
    d_inner, nh = _dims(cfg)
    g, n = s.n_groups, s.d_state
    b, l, _ = x.shape
    f32 = torch.float32

    zxbcdt = einsum("bsd,de->bse", x, p["w_in"])
    zxbcdt = constrain(zxbcdt, ("batch", "seq", "ssm_inner"), rules)
    z, xBC, dt_raw = _split_proj(cfg, zxbcdt)
    A = -torch.exp(p["a_log"])                                  # (h,) negative
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])              # (b,l,h)

    if state is None:
        xBC, _ = _causal_conv(cfg, p, xBC)
        xs, B, C = torch.split(xBC, [d_inner, g * n, g * n], dim=-1)
        xh = xs.reshape(b, l, nh, s.head_dim)
        Bm = B.reshape(b, l, g, n).to(f32)
        Cm = C.reshape(b, l, g, n).to(f32)
        y, _ = ssd_chunked_fused(xh.to(f32), dt, A, Bm, Cm, s.chunk_size)
        new_state = None
    else:
        xBC, conv_state = _causal_conv(cfg, p, xBC, state["conv"])
        xs, B, C = torch.split(xBC, [d_inner, g * n, g * n], dim=-1)
        xh = xs.reshape(b, l, nh, s.head_dim).to(f32)
        Bm = B.reshape(b, l, g, n).to(f32)
        Cm = C.reshape(b, l, g, n).to(f32)
        # single-step recurrence (l == 1)
        dA = torch.exp(dt[:, 0] * A[None, :])                   # (b,h)
        Bh = Bm[:, 0].repeat_interleave(nh // g, dim=1)         # (b,h,n)
        Ch = Cm[:, 0].repeat_interleave(nh // g, dim=1)
        dBx = torch.einsum("bh,bhn,bhp->bhpn", dt[:, 0], Bh, xh[:, 0])
        ssm_state = state["ssm"].to(f32) * dA[..., None, None] + dBx
        y = torch.einsum("bhpn,bhn->bhp", ssm_state, Ch)[:, None]  # (b,1,h,p)
        new_state = {"conv": conv_state,
                     "ssm": ssm_state.to(state["ssm"].dtype)}

    y = y + xh.to(f32) * p["d_skip"][None, None, :, None]
    y = y.reshape(b, l, d_inner).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm"])
    out = einsum("bse,ed->bsd", y, p["w_out"])
    return constrain(out, ("batch", "seq", "embed"), rules), new_state


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> dict:
    s = cfg.ssm
    d_inner, nh = _dims(cfg)
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=dtype,
                           device=device),
    }
