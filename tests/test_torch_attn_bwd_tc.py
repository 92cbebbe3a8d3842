"""The tensor-core route of ``local_attn``'s gradient
(``csrc/local_attn_bwd_tc.cu``) on the CPU: its numerical scheme, and the
plain VJP on CPU tensors.  The route is the forward's (``ops.route``,
held by ``tests/test_torch_attn_tc.py``).

The card is the only place the kernels run, so their arithmetic is
emulated here in plain PyTorch, as they round: bf16 q, k, v and dout;
S = Q Kᵀ and dP = dO Vᵀ f32 sums of products that are exact in f32;
P = exp2(scale log2(e) S - log2(e) lse) in f32 and 0 where masked; delta
the f32 sum of P dP over the dq kernel's key tiles in order (its first
pass, not the bf16 output); dS = P (dP - delta); wherever P or dS is a
product's operand it enters as P_hi = bf16(P) and P_lo = bf16(P - P_hi),
both multiplied into one f32 accumulator, tile after tile in the kernels'
order (keys for dq, queries for dk and dv); dq = bf16(scale acc); each
query head's dk and dv partial in f32, folded over a kv head's query heads
in order in f64, scaled (dk) and rounded to bf16.  The emulation is held
two ways: at most twice as far from the VJP evaluated in f64 as the plain
version's bf16 gradient (the limit ``chip_smoke.py`` and
``tests/test_torch_cuda_train.py`` hold the kernels to on the card), and
within the reference's bf16 tolerance, 2e-2 x max(1, max|g|), of the JAX
package's gradient (``jax.vjp`` of its plain attention).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.local_attn.ref import local_attention_ref as jax_local_attn_ref
from repro_torch.kernels.local_attn import ops
from repro_torch.kernels.local_attn.ref import NEG_INF, local_attention_bwd_ref

F64_FACTOR = 2.0
BF16_TOL = 2e-2
BLOCK_N = {64: 64, 128: 64, 256: 32}     # TbShape<D>::BN: streamed tile rows


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def allowed(S, T, causal, window):
    s = torch.arange(S)[:, None]
    t = torch.arange(T)[None, :]
    ok = torch.ones(S, T, dtype=torch.bool)
    if causal:
        ok &= t <= s
    if window:
        ok &= t > s - window
    return ok


def split(x):
    """The hi/lo pair a kernel feeds wgmma for an f32 operand."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def forward_lse(q, k, *, causal, window, scale):
    """Each row's log-sum-exp of the scaled scores in f32 (the forward
    kernel's statistics)."""
    g = q.shape[1] // k.shape[1]
    s = q.float() @ k.float().repeat_interleave(g, 1).transpose(-1, -2)
    s = torch.where(allowed(q.shape[2], k.shape[2], causal, window),
                    s * scale, torch.tensor(NEG_INF))
    return torch.logsumexp(s, dim=-1)


def emulate_bwd_tc(q, k, v, dout, lse, *, causal, window, scale):
    """What the three kernels and the fold compute, rounding where they
    round, in their tile order."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    g = H // KV
    bn = BLOCK_N[D]
    qf, of = q.float(), dout.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    c = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    lz = lse * torch.tensor(math.log2(math.e), dtype=torch.float32)
    ok = allowed(S, T, causal, window)
    s = qf @ kf.transpose(-1, -2)
    dp = of @ vf.transpose(-1, -2)
    p = torch.where(ok, torch.exp2(s * c - lz[..., None]), torch.tensor(0.0))
    key_tiles = [slice(t0, min(t0 + bn, T)) for t0 in range(0, T, bn)]
    query_tiles = [slice(s0, min(s0 + bn, S)) for s0 in range(0, S, bn)]
    # the dq kernel: delta over its key tiles, then dq += dS K
    delta = torch.zeros(B, H, S)
    for kt in key_tiles:
        delta = delta + (p[..., kt] * dp[..., kt]).sum(-1)
    ds = p * (dp - delta[..., None])
    ds_hi, ds_lo = split(ds)
    p_hi, p_lo = split(p)
    acc = torch.zeros(B, H, S, D)
    for kt in key_tiles:
        acc = acc + ds_hi[..., kt] @ kf[:, :, kt]
        acc = acc + ds_lo[..., kt] @ kf[:, :, kt]
    dq = (scale * acc).to(torch.bfloat16)
    # the dv and dk passes: a query head's partial over its query tiles
    dk_h = torch.zeros(B, H, T, D)
    dv_h = torch.zeros(B, H, T, D)
    for qt in query_tiles:
        for hi, lo, x, part in ((p_hi, p_lo, of, dv_h),
                                (ds_hi, ds_lo, qf, dk_h)):
            part += hi[:, :, qt].transpose(-1, -2) @ x[:, :, qt]
            part += lo[:, :, qt].transpose(-1, -2) @ x[:, :, qt]
    # the fold: a kv head's query heads in order, in f64
    fold = [part.double().reshape(B, KV, g, T, D).sum(2).float()
            for part in (dk_h, dv_h)]
    return (dq, (scale * fold[0]).to(torch.bfloat16),
            fold[1].to(torch.bfloat16))


def f64_distance(got, exact):
    """max|got - exact| / max|exact|."""
    return ((got.double() - exact).abs().max() / exact.abs().max()).item()


def bf16_case(rng, b, h, kv, s, d):
    return tuple(torch.from_numpy(rng.standard_normal((b, n, s, d))
                                  .astype(np.float32)).to(torch.bfloat16)
                 for n in (h, kv, kv, h))


def jax_grads(q, k, v, dout, **kw):
    """The JAX package's gradient of its plain attention, bf16 in."""
    def as_jax(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    _, vjp = jax.vjp(lambda a, b, c: jax_local_attn_ref(a, b, c, **kw),
                     as_jax(q), as_jax(k), as_jax(v))
    return [np.asarray(g, np.float32) for g in vjp(as_jax(dout))]


@pytest.mark.parametrize("D,H,KV,S,causal,window", [
    (256, 8, 1, 256, True, 0),        # gemma-2b's heads, cut in S
    (256, 8, 1, 200, True, 0),        # S off both tile sizes at D 256
    (128, 4, 2, 200, True, 0),        # GQA with two kv heads
    (64, 2, 1, 192, True, 48),        # a window that cuts tiles
    (64, 2, 2, 130, False, 0),        # bidirectional
])
def test_bwd_tc_scheme_is_as_close_to_f64_as_the_plain_version(
        D, H, KV, S, causal, window, rng):
    q, k, v, dout = bf16_case(rng, 1, H, KV, S, D)
    kw = dict(causal=causal, window=window, scale=D ** -0.5)
    lse = forward_lse(q, k, **kw)
    got = emulate_bwd_tc(q, k, v, dout, lse, **kw)
    plain = local_attention_bwd_ref(q, k, v, dout, **kw)
    exact = local_attention_bwd_ref(q.double(), k.double(), v.double(),
                                    dout.double(), **kw)
    want = jax_grads(q, k, v, dout, **kw)
    for name, a, pl, ex, jx in zip(("dq", "dk", "dv"), got, plain, exact,
                                   want, strict=True):
        assert a.dtype == torch.bfloat16 and a.shape == pl.shape, name
        d_tc, d_plain = f64_distance(a, ex), f64_distance(pl, ex)
        assert d_tc <= F64_FACTOR * d_plain, (name, d_tc, d_plain)
        lim = BF16_TOL * max(1.0, float(np.abs(jx).max()))
        np.testing.assert_allclose(a.float().numpy(), jx, rtol=0, atol=lim,
                                   err_msg=name)


def test_cpu_backward_runs_the_plain_vjp(rng):
    q, k, v, dout = bf16_case(rng, 1, 4, 2, 70, 64)
    kw = dict(causal=True, window=0, scale=0.125)
    before = (ops.launches, ops.launches_bwd, ops.launches_bwd_tc)
    got = ops.local_attention_bwd(q, k, v, None, dout, **kw)
    want = local_attention_bwd_ref(q, k, v, dout, **kw)
    assert all(torch.equal(a, w) for a, w in zip(got, want, strict=True))
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.local_flash_attention(*live, **kw)
    grads = torch.autograd.grad(out, live, dout)
    assert all(torch.equal(a, w) for a, w in zip(grads, want, strict=True))
    assert (ops.launches, ops.launches_bwd, ops.launches_bwd_tc) == before
