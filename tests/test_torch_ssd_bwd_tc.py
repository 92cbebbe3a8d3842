"""The tensor-core design of ``ssd_chunk``'s gradient
(``csrc/ssd_chunk_bwd.cu``) on the CPU: its numerical scheme, its choice of
heads a CTA and its shared memory.

The card is the only place the kernel runs, so its arithmetic is emulated
here in plain PyTorch, as it rounds: every product is split exactly into
three tf32 parts (hi = tf32(x), mid = tf32(x - hi), lo the rest, tf32 the
round to a 10-bit mantissa, ties away from zero, as ``cvt.rna.tf32.f32``),
and a k-step of 8 takes the six partial products (dropping mid lo, lo mid
and lo lo) into two fresh accumulators, the three smallest and the three
largest, whose f32 sum is added to the running sum in f32
round-to-nearest, k-steps in the kernel's order; the sums a block's heads
share (PD = sum_h L_h o D_h) are taken elementwise in head order; dB's
decay terms are added head after head; a group's head blocks are folded
in order in f64; M's row and column sums, u = xdt . E and the reverse
cumsum of d cum are f64; cum is the sequential f32 scan.  The emulation is
held two ways: at most twice as far from the VJP evaluated in f64 as the
plain version (the limit ``chip_smoke.py`` and
``tests/test_torch_cuda_train.py`` hold the kernel to on the card), and
within the reference's tolerance, 2e-5 x max(1, max|g|), of the JAX
package's gradient (``jax.vjp`` of ``repro.kernels.ssd_chunk.ref.ssd_ref``
over one chunk, where the whole scan is the intra-chunk function).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk.ref import ssd_ref as jax_ssd_ref
from repro_torch.kernels.ssd_chunk import ops
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_bwd_ref

F64_FACTOR = 2.0
JAX_TOL = 2e-5
SMS = 132                    # the H100's SMs


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32(x):
    """cvt.rna.tf32.f32: the nearest value with a 10-bit mantissa, ties
    away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split3(x):
    hi = tf32(x)
    r = x - hi
    mid = tf32(r)
    return hi, mid, r - mid


def mm6(a, b, acc=None):
    """acc + a @ b over the last dim of a in k-steps of 8 (zero-padded):
    each step's three smallest and three largest split products summed
    exactly and rounded apart, their sum rounded, then added to the
    running sum in f32."""
    k = a.shape[-1]
    pad = (-k) % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b.transpose(-1, -2), (0, pad)).transpose(-1,
                                                                         -2)
    ah, am, al = (t.double() for t in split3(a))
    bh, bm, bl = (t.double() for t in split3(b))
    if acc is None:
        acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, k + pad, 8):
        ks = slice(k0, k0 + 8)
        small, large = (sum(x[..., ks] @ y[..., ks, :] for x, y in pairs)
                        .float() for pairs in (((al, bh), (ah, bl), (am, bm)),
                                               ((am, bh), (ah, bm), (ah, bh))))
        acc = acc + (large + small)
    return acc


def emulate_bwd(xdt, dA, B, C, dy, dst, hb):
    """What the kernel and its fold compute, rounding where they round."""
    b, c, l, h, p = xdt.shape
    g, n = B.shape[3], B.shape[4]
    r = h // g
    cum = torch.cumsum(dA, dim=2)                                # (b,c,l,h)
    i = torch.arange(l)
    tri = i[:, None] >= i[None, :]
    # per head, (b, c, h, ...)
    ch = cum.permute(0, 1, 3, 2)                                 # (b,c,h,l)
    L = torch.where(tri, torch.exp(torch.where(tri, ch[..., :, None]
                                               - ch[..., None, :], 0.0)), 0.0)
    w = torch.exp(ch[..., -1:] - ch)                             # (b,c,h,l)
    xh, yh = xdt.permute(0, 1, 3, 2, 4), dy.permute(0, 1, 3, 2, 4)
    Bg, Cg = B.permute(0, 1, 3, 2, 4), C.permute(0, 1, 3, 2, 4)  # (b,c,g,l,n)
    Bh, Ch = Bg.repeat_interleave(r, 2), Cg.repeat_interleave(r, 2)
    G = mm6(Ch, Bh.transpose(-1, -2))                            # (b,c,h,l,l)
    D = mm6(yh, xh.transpose(-1, -2))
    PG = L * G
    M = PG * D
    # PD summed over a block's heads in head order
    nb = h // hb
    PDh = (L * D).reshape(b, c, nb, hb, l, l)
    PD = PDh[:, :, :, 0]
    for hs in range(1, hb):
        PD = PD + PDh[:, :, :, hs]
    Bb, Cb = Bh[:, :, ::hb], Ch[:, :, ::hb]       # a block's group: (b,c,nb,l,n)
    dxdt = mm6(PG.transpose(-1, -2), yh)
    dBb = mm6(PD.transpose(-1, -2), Cb)
    dCb = mm6(PD, Bb)
    # the decay terms: E over n in k-steps; each head's F into dB in order
    E = mm6(Bh, dst)                                             # (b,c,h,l,p)
    F = mm6(xh, dst.transpose(-1, -2)).reshape(b, c, nb, hb, l, n)
    wb = w.reshape(b, c, nb, hb, l)
    for hs in range(hb):
        dBb = dBb + wb[:, :, :, hs, :, None] * F[:, :, :, hs]
    dxdt = dxdt + w[..., None] * E
    u = (xh * E).double().sum(-1)
    wu = w.double() * u
    dcum = M.double().sum(-1) - M.double().sum(-2) - wu
    dcum[..., -1] += wu.sum(-1)
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    fold = [t.double().reshape(b, c, g, nb // g, l, n).sum(3).float()
            for t in (dBb, dCb)]
    return (dxdt.permute(0, 1, 3, 2, 4), ddA.float().permute(0, 1, 3, 2),
            fold[0].permute(0, 1, 3, 2, 4), fold[1].permute(0, 1, 3, 2, 4))


def mixer_case(rng, b, c, l, h, p, g, n):
    """Inputs as the mixer makes them (x, dt = softplus, A = -exp) and
    random output gradients, f32; also x, dt, A for the JAX scan."""
    f = np.float32
    x = rng.standard_normal((b, c * l, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, c * l, h)))).astype(f)
    A = (-np.exp(0.5 * rng.standard_normal(h))).astype(f)
    B = rng.standard_normal((b, c * l, g, n)).astype(f)
    C = rng.standard_normal((b, c * l, g, n)).astype(f)
    dy = rng.standard_normal((b, c, l, h, p)).astype(f)
    dst = rng.standard_normal((b, c, h, n, p)).astype(f)
    t = torch.from_numpy
    xdt = (t(x) * t(dt)[..., None]).reshape(b, c, l, h, p)
    dA = (t(dt) * t(A)).reshape(b, c, l, h)
    args = (xdt, dA, t(B).reshape(b, c, l, g, n), t(C).reshape(b, c, l, g, n),
            t(dy), t(dst))
    return args, (x, dt, A, B, C)


def f64_distance(got, exact):
    return ((got.double() - exact).abs().max() / exact.abs().max()).item()


@pytest.mark.parametrize("b,c,l,h,p,g,n", [
    (1, 2, 64, 8, 16, 1, 32),        # mamba2's layout, cut
    (2, 1, 40, 4, 24, 2, 20),        # l, n, p off the 32-wide tiles; 2 groups
    (1, 1, 32, 6, 8, 1, 16),         # 6 heads: blocks of 2
])
def test_bwd_scheme_is_as_close_to_f64_as_the_plain_version(b, c, l, h, p, g,
                                                            n, rng):
    args, _ = mixer_case(rng, b, c, l, h, p, g, n)
    hb = ops.bwd_heads_per_block(b * c, h, g, SMS, l, p, n)
    got = emulate_bwd(*args, hb=hb)
    plain = ssd_intra_chunk_bwd_ref(*args)
    exact = ssd_intra_chunk_bwd_ref(*(a.double() for a in args))
    for name, a, pl, ex in zip(("dxdt", "d(dA)", "dB", "dC"), got, plain,
                               exact, strict=True):
        assert a.shape == pl.shape and a.dtype == torch.float32, name
        d_tc, d_plain = f64_distance(a, ex), f64_distance(pl, ex)
        assert d_tc <= F64_FACTOR * d_plain, (name, d_tc, d_plain)


@pytest.mark.parametrize("hb", [4, 2, 1])
def test_bwd_scheme_agrees_with_the_jax_gradient(hb, rng):
    """One chunk: the JAX package's whole scan is the intra-chunk function,
    and its gradient is the emulated one through xdt = x dt, dA = dt A."""
    b, c, l, h, p, g, n = 2, 1, 48, 4, 16, 1, 24
    args, (x, dt, A, B, C) = mixer_case(rng, b, c, l, h, p, g, n)
    dxdt, ddA, dB, dC = emulate_bwd(*args, hb=hb)
    dy, dst = args[4], args[5]
    _, vjp = jax.vjp(lambda *a: jax_ssd_ref(*a, l), *(jnp.asarray(v) for v in
                                                     (x, dt, A, B, C)))
    want = vjp((jnp.asarray(dy.reshape(b, l, h, p).numpy()),
                jnp.asarray(dst[:, 0].transpose(-1, -2).numpy())))
    xt, dtt, At = (torch.from_numpy(v) for v in (x, dt, A))
    dxdt, ddA = dxdt.reshape(b, l, h, p), ddA.reshape(b, l, h)
    got = (dxdt * dtt[..., None],
           (dxdt * xt).sum(-1) + ddA * At,
           (ddA * dtt).sum((0, 1)),
           dB.reshape(b, l, g, n), dC.reshape(b, l, g, n))
    for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                          strict=True):
        w = np.asarray(w)
        lim = JAX_TOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=lim,
                                   err_msg=name)


@pytest.mark.parametrize("blocks,h,g,l,p,n,want", [
    (16, 32, 1, 256, 64, 128, 4),    # mamba2-370m, 2 x 2048: 128 CTAs
    (4, 32, 1, 256, 64, 128, 1),     # the federated round's 4 x 32 tokens
    (32, 32, 1, 256, 64, 128, 4),
    (8, 8, 2, 256, 80, 160, 1),      # SSD_SHAPES: 4 a CTA do not fit
    (64, 8, 2, 256, 80, 160, 2),
    (2, 6, 1, 64, 32, 48, 1),        # 4 do not divide 6 heads
    (64, 6, 1, 64, 32, 48, 2),
    (64, 5, 1, 100, 16, 24, 1),
])
def test_bwd_heads_per_block_is_a_function_of_the_shape(blocks, h, g, l, p, n,
                                                       want):
    hb = ops.bwd_heads_per_block(blocks, h, g, SMS, l, p, n)
    assert hb == want
    assert (h // g) % hb == 0
    assert ops.bwd_smem_bytes(hb, l, p, n) <= ops.MAX_SMEM


def test_bwd_smem_mirrors_the_kernel():
    # mamba2-370m: n 128, p 64 at l 256; the sums of sb_layout by hand
    t, ldn, ldp, ld1, ld2 = 32, 132, 68, 136, 72
    for hb in (4, 2, 1):
        ra = max(t * ldn + hb * t * ldp, hb * t * ld2)
        rb = max((2 + hb) * t * 40 + hb * t * 33, hb * t * ldp)
        floats = ra + rb + t * ldn + hb * t * ldp + t * ld1 + hb * t * ld2 \
            + hb * 256
        assert ops.bwd_smem_bytes(hb, 256, 64, 128) == 4 * floats + 16 * hb * 256
    assert ops.bwd_smem_bytes(4, 256, 64, 128) == 225_792
    assert ops.bwd_smem_bytes(4, 256, 80, 160) > ops.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        ops.bwd_heads_per_block(16, 32, 1, SMS, 256, 2048, 4096)


def test_cpu_backward_runs_the_plain_vjp(rng):
    args, _ = mixer_case(rng, 1, 2, 16, 4, 8, 2, 8)
    before = (ops.launches, ops.launches_bwd)
    got = ops.ssd_intra_chunk_bwd(*args)
    want = ssd_intra_chunk_bwd_ref(*args)
    assert all(torch.equal(a, w) for a, w in zip(got, want, strict=True))
    live = [a.clone().requires_grad_() for a in args[:4]]
    y, st = ops.SsdIntraChunkFn.apply(*live)
    grads = torch.autograd.grad((y, st), live, (args[4], args[5]))
    assert all(torch.equal(a, w) for a, w in zip(grads, want, strict=True))
    assert (ops.launches, ops.launches_bwd) == before
