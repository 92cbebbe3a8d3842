"""The tensor-core route of ``local_attn`` (``csrc/local_attn_tc.cu``) on
the CPU: its numerical scheme, its choice and its strides.

The card is the only place the kernel runs, so its arithmetic is emulated
here in plain PyTorch, as the kernel rounds: bf16 q, k and v; S an f32 sum
of products that are exact in f32, scaled after the product (by scale x
log2 e, for exp2); an online softmax over the kernel's key tiles (64 keys,
32 at D 256), visiting the tiles the kernel visits per 64-row query tile;
P split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), both multiplied by
V into one f32 accumulator; l from the f32 P; the output divided by
max(l, 1e-30) and rounded to bf16.  The emulation is held against the same
function in f64 (the plain version on f64 copies of the bf16 inputs): it
may sit at most twice as far from it as the plain version's bf16 output,
the limit ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the
kernel to on the card.  It is also held to the JAX package's plain version
at the reference's bf16 tolerance, 2e-2.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.local_attn.ref import local_attention_ref as jax_local_attn_ref
from repro_torch.kernels.local_attn.ops import (
    HEAD_DIMS,
    TC_HEAD_DIMS,
    local_flash_attention,
    route,
    tma_strides,
)
from repro_torch.kernels.local_attn.ref import NEG_INF, local_attention_ref

BLOCK_Q = 64                             # TC_BM in csrc/local_attn_tc.cu
BLOCK_K = {64: 64, 128: 64, 256: 32}     # TcShape<D>::BN
F64_FACTOR = 2.0   # the route's distance to f64 over the plain version's


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def emulate_tc(q, k, v, *, causal: bool, window: int, scale: float):
    """What the tensor-core kernel computes, rounding where it rounds."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    bn = BLOCK_K[D]
    nk = -(-T // bn)
    g = H // KV
    qf = q.float()
    # TMA reads the keys past T as zeros
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, nk * bn - T))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, nk * bn - T))
    kf, vf = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    out = torch.empty(B, H, S, D, dtype=torch.float32)
    for q0 in range(0, S, BLOCK_Q):
        rows = slice(q0, min(q0 + BLOCK_Q, S))
        q_pos = torch.arange(q0, rows.stop)[:, None]
        kt_hi = min(nk, (q0 + BLOCK_Q - 1) // bn + 1) if causal else nk
        x0 = q0 - window + 1
        kt_lo = x0 // bn if window and x0 > 0 else 0
        m = torch.full((B, H, rows.stop - q0), NEG_INF)
        lsum = torch.zeros(B, H, rows.stop - q0)
        acc = torch.zeros(B, H, rows.stop - q0, D)
        for kt in range(kt_lo, kt_hi):
            keys = slice(kt * bn, (kt + 1) * bn)
            s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            x = s * scale_log2
            k_pos = torch.arange(keys.start, keys.stop)[None, :]
            ok = k_pos < T
            if causal:
                ok = ok & (k_pos <= q_pos)
            if window:
                ok = ok & (k_pos > q_pos - window)
            x = torch.where(ok, x, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            m = m_new
            lsum = lsum * corr + p.sum(-1)
            p_hi = p.to(torch.bfloat16).float()
            p_lo = (p - p_hi).to(torch.bfloat16).float()
            acc = acc * corr[..., None] + p_hi @ vf[:, :, keys]
            acc = acc + p_lo @ vf[:, :, keys]
        out[:, :, rows] = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.to(torch.bfloat16)


def f64_distance(got, exact):
    """max|got - exact| / max|exact|."""
    return ((got.double() - exact).abs().max() / exact.abs().max()).item()


def bf16_case(rng, b, h, kv, s, d):
    return tuple(torch.from_numpy(rng.standard_normal((b, n, s, d))
                                  .astype(np.float32)).to(torch.bfloat16)
                 for n in (h, kv, kv))


@pytest.mark.parametrize("D,H,KV,S,causal,window", [
    (256, 8, 1, 256, True, 0),        # gemma-2b's heads, cut in S
    (256, 8, 1, 256, True, 96),       # a window that cuts key tiles
    (128, 4, 2, 200, True, 0),        # S not a multiple of either tile
    (64, 2, 2, 130, False, 0),        # bidirectional
])
def test_tc_scheme_is_as_close_to_f64_as_the_plain_version(D, H, KV, S, causal,
                                                           window, rng):
    q, k, v = bf16_case(rng, 1, H, KV, S, D)
    kw = dict(causal=causal, window=window, scale=D ** -0.5)
    got = emulate_tc(q, k, v, **kw)
    plain = local_attention_ref(q, k, v, **kw)
    exact = local_attention_ref(q.double(), k.double(), v.double(), **kw)
    d_tc, d_plain = f64_distance(got, exact), f64_distance(plain, exact)
    assert d_tc <= F64_FACTOR * d_plain, (d_tc, d_plain)
    torch.testing.assert_close(got.float(), plain.float(), rtol=0, atol=2e-2)
    jplain = jax_local_attn_ref(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                  for t in (q, k, v)), **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jplain, np.float32), atol=2e-2)


def test_tc_scheme_row_whose_first_tile_is_masked(rng):
    """A window narrower than a key tile: a row's first visited tile can be
    wholly outside its window; the next tile's correction wipes the
    exp2(0) weights, as in the plain version."""
    q, k, v = bf16_case(rng, 1, 2, 1, 192, 64)
    kw = dict(causal=True, window=20, scale=0.125)
    got = emulate_tc(q, k, v, **kw)
    exact = local_attention_ref(q.double(), k.double(), v.double(), **kw)
    plain = local_attention_ref(q, k, v, **kw)
    assert f64_distance(got, exact) <= F64_FACTOR * f64_distance(plain, exact)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_is_a_function_of_dtype_and_head_dim(dtype, D):
    want = "tc" if dtype == torch.bfloat16 and D >= 64 else "tf32"
    assert route(dtype, D) == want
    assert TC_HEAD_DIMS == (64, 128, 256)


def test_tma_strides_reads_views_in_place():
    x = torch.empty(2, 40, 8, 64, dtype=torch.bfloat16)       # (b, s, H, D)
    assert tma_strides(x.transpose(1, 2)) == (40 * 8 * 64, 64, 8 * 64)
    assert tma_strides(x.permute(0, 2, 1, 3).contiguous()) == (
        8 * 40 * 64, 40 * 64, 64)
    one = torch.empty(1, 1, 40, 64, dtype=torch.bfloat16)     # size-1 dims
    assert tma_strides(one) == (64, 64, 64)
    wide = torch.empty(1, 2, 40, 68, dtype=torch.bfloat16)[..., :64]
    assert tma_strides(wide) is None                           # 136-byte rows
    assert tma_strides(x.transpose(2, 3)) is None              # D not contiguous
    flat = torch.empty(1 + 2 * 40 * 64, dtype=torch.bfloat16)
    assert tma_strides(flat[1:].view(1, 2, 40, 64)) is None   # 2-byte offset


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_route_takes_strided_views(dtype, rng):
    """q, k, v as the model hands them over (transposed (b, s, heads, D)
    views) give the answer of their contiguous copies."""
    b, s, h, kv, d = 2, 48, 4, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d))
                                .astype(np.float32)).to(dtype)
               for n in (h, kv, kv))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    kw = dict(causal=True, window=16, scale=0.125)
    got = local_flash_attention(*views, **kw)
    want = local_flash_attention(*(t.contiguous() for t in views), **kw)
    assert torch.equal(got, want)
