"""The split-tf32 route of ``local_attn``'s gradient
(``csrc/local_attn_bwd_tf32.cu``) on the CPU: its numerical scheme, its
route and its shared memory.

The card is the only place the kernels run, so their arithmetic is
emulated here in plain PyTorch, as they round.  Every product (S = Q Kᵀ,
dP = dO Vᵀ, dq = dS K, dv = Pᵀ dO, dk = dSᵀ Q) runs on mma.sync m16n8k8
tf32 with f32 accumulation over a split of both operands (tf32 the round
to a 10-bit mantissa, ties away from zero, as ``cvt.rna.tf32.f32``): the
kernel's two parts, hi = tf32(x) and lo = x - hi, which the tensor core
reads cut to 10 bits toward zero, and three partial products (lo hi, hi
lo, hi hi); or the exact three-way split (hi, mid = tf32(x - hi), lo the
rest) and six (lo hi, hi lo, mid mid, mid hi, hi mid, hi hi).  A k-step of 8 takes its partial products into a fresh
accumulator, each ``mma`` rounding its sum to f32 once, and the step's sum
is then added to the running one in f32, k-steps in order.  P~ =
exp(fma(scale, S, -lse)) in f32 and 0 where masked; the dq kernel's first
pass sums each row's P~ and P~ dP; P = P~ / sum P~ and delta = (sum P~
dP) / sum P~ (not the output); dS = P (dP - delta); dq = scale acc in the
inputs' dtype; each query head's dk and dv partial in f32, folded over a
kv head's query heads in order in f64, scaled (dk) and rounded to the
inputs' dtype.

The emulation is held two ways: at most twice as far from the VJP
evaluated in f64 as the plain f32 VJP (``BWD_F64_FACTOR`` of
``chip_smoke.py``, the limit the card holds the kernel to), and within
``F32_TOL`` x max(1, max|g|) of the JAX package's gradient (``jax.vjp`` of
its plain attention on the same numpy inputs), for the kernel's scheme at
every case and for the six-product one at two.  Both schemes' distances
at a larger shape:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_attn_bwd_tf32.py \
        [--shape B,H,KV,S,D]

prints both schemes' and the plain version's distances to f64 at a shape
(default gemma-2b's training shape, 2 x 2048; minutes on a CPU).
"""

import argparse
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.local_attn.ref import local_attention_ref as jax_local_attn_ref
from repro_torch.kernels.local_attn import ops
from repro_torch.kernels.local_attn.ref import NEG_INF, local_attention_bwd_ref

F64_FACTOR = 2.0
F32_TOL = 1e-5
# the kernels' tiles (csrc/local_attn_bwd_tf32.cu): kept rows, streamed
# rows by head dim, cp.async stages by kernel and head dim (f32), padding
# of a row, P / dS tiles by kernel
BLOCK_M = 64
BLOCK_N = {16: 64, 32: 64, 64: 64, 128: 64, 256: 32}
STAGES = {"dq": {16: 2, 32: 2, 64: 2, 128: 2, 256: 1},
          "dkdv": {16: 2, 32: 2, 64: 2, 128: 1, 256: 1}}
PAD = {torch.float32: 4, torch.bfloat16: 8}
E_TILES = {"dq": 1, "dkdv": 2}
SMEM_LIMIT = 232448          # the H100's shared memory a block can take
# six products (the exact three-way split), or three (two parts)
SCHEMES = {6: ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)),
           3: ((1, 0), (0, 1), (0, 0))}


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


def cut(x):
    """What the tensor core reads of an f32 register it takes as tf32: its
    top 19 bits (the mantissa cut to 10 bits toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x, products):
    """The parts of ``x`` a scheme multiplies: three exact parts for six
    products; for three, hi = tf32(x) and x - hi, which the kernel passes
    as it is and the tensor core cuts."""
    hi = tf32(x)
    r = x - hi
    if products == 3:
        return hi, cut(r)
    mid = tf32(r)
    return hi, mid, r - mid


def mm(a, b, products=ops.TF32_PRODUCTS, chunk=16):
    """a @ b as the kernels take it: over the last dim of ``a`` in k-steps
    of 8 (zero-padded), each step's partial products into a fresh f32
    accumulator (every mma rounds its sum once), then added to the running
    sum in f32, step after step (``chunk`` steps' products at a time)."""
    k = a.shape[-1]
    pad = (-k) % 8
    a = torch.nn.functional.pad(a.float(), (0, pad))
    b = torch.nn.functional.pad(b.float().transpose(-1, -2),
                                (0, pad)).transpose(-1, -2)
    n = (k + pad) // 8
    # (..., steps, M, 8) and (..., steps, 8, N): every step's products at once
    pa = [t.double().unflatten(-1, (n, 8)).movedim(-2, -3)
          for t in split(a, products)]
    pb = [t.double().unflatten(-2, (n, 8)) for t in split(b, products)]
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for c0 in range(0, n, chunk):
        sl = slice(c0, c0 + chunk)
        t = None
        for i, j in SCHEMES[products]:
            prod = pa[i][..., sl, :, :] @ pb[j][..., sl, :, :]
            t = prod.float() if t is None else (t.double() + prod).float()
        for step in t.unbind(-3):
            acc = acc + step
    return acc


def allowed(S, T, causal, window):
    s = torch.arange(S)[:, None]
    t = torch.arange(T)[None, :]
    ok = torch.ones(S, T, dtype=torch.bool)
    if causal:
        ok &= t <= s
    if window:
        ok &= t > s - window
    return ok


def forward_lse(q, k, *, causal, window, scale):
    """Each row's log-sum-exp of the scaled scores in f32 (the forward
    kernel's statistics)."""
    g = q.shape[1] // k.shape[1]
    s = q.float() @ k.float().repeat_interleave(g, 1).transpose(-1, -2)
    s = torch.where(allowed(q.shape[2], k.shape[2], causal, window),
                    s * scale, torch.tensor(NEG_INF))
    return torch.logsumexp(s, dim=-1)


def emulate_heads(q, k, v, dout, lse, *, causal, window, scale,
                  products=ops.TF32_PRODUCTS):
    """What the dq kernel and the dv and dk passes compute, rounding where
    they round: dq in the inputs' dtype, each query head's dk and dv
    partials in f32."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    g = H // KV
    qf, of = q.float(), dout.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    ok = allowed(S, T, causal, window)
    s = mm(qf, kf.transpose(-1, -2), products)
    dp = mm(of, vf.transpose(-1, -2), products)
    # exp(fma(scale, s, -lse)): one rounding of the argument
    arg = (s.double() * scale - lse.double()[..., None]).float()
    p = torch.where(ok, torch.exp(arg), torch.tensor(0.0))
    # the first pass: each row's sum of P and of P dP; P renormalised by
    # the first (the f32 lse's rounding moves a whole row of P by as much
    # as |lse| ulps, which dS's cancellation against delta amplifies)
    rsum = p.sum(-1)
    rinv = torch.where(rsum > 0, 1.0 / rsum, torch.tensor(0.0))
    delta = (p * dp).sum(-1) * rinv
    p = p * rinv[..., None]
    ds = p * (dp - delta[..., None])
    dq = (scale * mm(ds, kf, products)).to(q.dtype)
    dk_h = mm(ds.transpose(-1, -2), qf, products)
    dv_h = mm(p.transpose(-1, -2), of, products)
    return dq, dk_h, dv_h


def fold(dk_h, dv_h, kv, scale, dtype):
    """The fold: a kv head's query heads in order in f64, dk scaled."""
    B, H, T, D = dk_h.shape
    dk, dv = (part.double().reshape(B, kv, H // kv, T, D).sum(2).float()
              for part in (dk_h, dv_h))
    return (scale * dk).to(dtype), dv.to(dtype)


def emulate_bwd_tf32(q, k, v, dout, lse, *, scale,
                     products=ops.TF32_PRODUCTS, **kw):
    """What the dq kernel, the dv and dk passes and the fold compute."""
    dq, dk_h, dv_h = emulate_heads(q, k, v, dout, lse, scale=scale,
                                   products=products, **kw)
    return (dq, *fold(dk_h, dv_h, k.shape[1], scale, k.dtype))


def f64_distance(got, exact):
    """max|got - exact| / max|exact|."""
    return ((got.double() - exact).abs().max() / exact.abs().max()).item()


def case(rng, b, h, kv, s, d, dtype=torch.float32):
    return tuple(torch.from_numpy(rng.standard_normal((b, n, s, d))
                                  .astype(np.float32)).to(dtype)
                 for n in (h, kv, kv, h))


def distances(q, k, v, dout, products=ops.TF32_PRODUCTS, **kw):
    """Per output (dq, dk, dv): the emulated route's and the plain f32
    VJP's distance to the f64 VJP, and the emulated gradient."""
    lse = forward_lse(q, k, **kw)
    got = emulate_bwd_tf32(q, k, v, dout, lse, products=products, **kw)
    plain = local_attention_bwd_ref(q, k, v, dout, **kw)
    exact = local_attention_bwd_ref(q.double(), k.double(), v.double(),
                                    dout.double(), **kw)
    return [(f64_distance(a, ex), f64_distance(pl, ex))
            for a, pl, ex in zip(got, plain, exact, strict=True)], got


def jax_grads(q, k, v, dout, **kw):
    """The JAX package's gradient of its plain attention, f32 in."""
    def as_jax(t):
        return jnp.asarray(t.float().numpy(), jnp.float32)

    _, vjp = jax.vjp(lambda a, b, c: jax_local_attn_ref(a, b, c, **kw),
                     as_jax(q), as_jax(k), as_jax(v))
    return [np.asarray(g, np.float32) for g in vjp(as_jax(dout))]


CASES = [
    (1, 8, 1, 192, 256, True, 0),     # gemma-2b's heads, cut in S
    (1, 8, 2, 200, 128, True, 0),     # S off the tiles, two kv heads
    (1, 4, 1, 160, 64, True, 48),     # a window that cuts the tiles
    (1, 4, 4, 130, 64, False, 0),     # bidirectional
    (1, 8, 2, 96, 32, True, 0),       # GQA 4:1 at D 32
    (1, 2, 1, 70, 16, False, 0),      # D 16, bidirectional
]


def hold_scheme(B, H, KV, S, D, causal, window, rng, products):
    q, k, v, dout = case(rng, B, H, KV, S, D)
    kw = dict(causal=causal, window=window, scale=D ** -0.5)
    dist, got = distances(q, k, v, dout, products=products, **kw)
    want = jax_grads(q, k, v, dout, **kw)
    for name, (d_k, d_p), a, jx in zip(("dq", "dk", "dv"), dist, got, want,
                                       strict=True):
        assert a.dtype == torch.float32, name
        assert d_k <= F64_FACTOR * d_p, (name, d_k, d_p)
        lim = F32_TOL * max(1.0, float(np.abs(jx).max()))
        np.testing.assert_allclose(a.numpy(), jx, rtol=0, atol=lim,
                                   err_msg=name)


@pytest.mark.parametrize("B,H,KV,S,D,causal,window", CASES)
def test_tf32_scheme_is_as_close_to_f64_as_the_plain_version(
        B, H, KV, S, D, causal, window, rng):
    """The kernel's scheme (``ops.TF32_PRODUCTS`` products)."""
    hold_scheme(B, H, KV, S, D, causal, window, rng, ops.TF32_PRODUCTS)


@pytest.mark.parametrize("B,H,KV,S,D,causal,window", CASES[:2])
def test_six_product_scheme_is_as_close_to_f64_as_the_plain_version(
        B, H, KV, S, D, causal, window, rng):
    """The exact three-way split the two-part one replaced."""
    hold_scheme(B, H, KV, S, D, causal, window, rng, 6)


@pytest.mark.parametrize("D", [16, 32])
def test_tf32_scheme_takes_bf16_at_small_head_dims(D, rng):
    """bf16 at D 16 and 32 runs the same kernels (bf16 is exact in a
    tf32 hi part); outputs round to bf16."""
    q, k, v, dout = case(rng, 1, 4, 2, 100, D, torch.bfloat16)
    kw = dict(causal=True, window=0, scale=D ** -0.5)
    lse = forward_lse(q, k, **kw)
    got = emulate_bwd_tf32(q, k, v, dout, lse, **kw)
    plain = local_attention_bwd_ref(q, k, v, dout, **kw)
    exact = local_attention_bwd_ref(q.double(), k.double(), v.double(),
                                    dout.double(), **kw)
    for name, a, pl, ex in zip(("dq", "dk", "dv"), got, plain, exact,
                               strict=True):
        assert a.dtype == torch.bfloat16 and a.shape == pl.shape, name
        assert f64_distance(a, ex) <= F64_FACTOR * f64_distance(pl, ex), name


def test_split_parts_are_exact(rng):
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    x = torch.cat([x, x * 1e-30, x * 1e30, torch.tensor([0.0, -0.0])])
    hi, mid, lo = split(x, 6)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    for part in (hi, mid, lo):
        assert torch.equal(tf32(part), part)     # each a tf32 as it is
    # two parts: hi + lo keeps all but the last two bits of x's 24
    hi, lo = split(x, 3)
    assert torch.equal(tf32(hi), hi) and torch.equal(cut(lo), lo)
    gap = (x.double() - hi.double() - lo.double()).abs()
    assert (gap <= x.double().abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("D", ops.HEAD_DIMS)
def test_route_names_the_tf32_kernel_for_every_f32_head_dim(D):
    assert ops.route(torch.float32, D) == "tf32"
    # bf16 at D 16 and 32 runs the CUDA-core forward and the tf32 backward
    want = "tc" if D in ops.TC_HEAD_DIMS else "tf32"
    assert ops.route(torch.bfloat16, D) == want


def smem_bytes(D, dtype, kernel, stages):
    """A kernel's dynamic shared memory: two kept tiles of BLOCK_M rows,
    ``stages`` x 2 streamed tiles of BLOCK_N rows (each row D + PAD
    elements), its P / dS tiles (BLOCK_M x (BLOCK_N + 4) f32) and the
    dk/dv kernel's lse, rinv and delta of each stage's queries."""
    el = torch.tensor([], dtype=dtype).element_size()
    row = (D + PAD[dtype]) * el
    bn = BLOCK_N[D]
    stats = 3 * bn * stages if kernel == "dkdv" else 0
    return ((2 * BLOCK_M + stages * 2 * bn) * row
            + 4 * (E_TILES[kernel] * BLOCK_M * (bn + 4) + stats))


@pytest.mark.parametrize("D", ops.HEAD_DIMS)
def test_shared_memory_layout_mirrors_the_kernel(D):
    for dtype in (torch.float32, torch.bfloat16):
        for kernel in ("dq", "dkdv"):
            # two cp.async stages where they fit, as lt_stages
            stages = 2 if smem_bytes(D, dtype, kernel, 2) <= SMEM_LIMIT \
                else 1
            if dtype == torch.float32:
                assert stages == STAGES[kernel][D], (kernel, D)
            assert smem_bytes(D, dtype, kernel, stages) <= SMEM_LIMIT, (
                kernel, D, dtype)
        # rows start 16 bytes apart for cp.async, and the tiles' row
        # strides (in 4-byte words) are 4 banks apart mod 32
        row = (D + PAD[dtype]) * torch.tensor([], dtype=dtype).element_size()
        assert row % 16 == 0 and (row // 4) % 32 in (4, 12, 20, 28)


def test_wrapper_constants_mirror_the_kernel_source():
    """The tiles above, ``ops.TF32_PRODUCTS`` and ``smem_bytes``' terms
    are the kernel source's (the backward and the helpers it shares with
    the forward): ``LT_PARTS``, ``LT_BM``, ``LtShape``'s BN and EW,
    ``LtPad``, ``lt_smem``, ``lt_stages`` and the two launches' shared
    memory."""
    csrc = Path(ops.__file__).parents[1] / "csrc"
    src = "\n".join((csrc / name).read_text() for name in (
        "local_attn_tf32_common.cuh", "local_attn_bwd_tf32.cu"))
    parts = int(re.search(r"#define LT_PARTS (\d)", src).group(1))
    assert ops.TF32_PRODUCTS == {2: 3, 3: 6}[parts] == 3
    assert int(re.search(r"#define LT_BM (\d+)", src).group(1)) == BLOCK_M
    big, small = map(int, re.search(r"BN = D == 256 \? (\d+) : (\d+);",
                                    src).groups())
    assert BLOCK_N == {d: big if d == 256 else small for d in ops.HEAD_DIMS}
    assert "EW = BN + 4;" in src
    pads = [int(p) for p in re.findall(r"static constexpr int v = (\d+);",
                                       src)]
    assert pads == [PAD[torch.float32], PAD[torch.bfloat16]]
    assert "return (kept * LT_BM + stages * 2 * LtShape<D>::BN) * " \
        "(D + LtPad<T>::v) *" in src
    assert "4 * (etiles * LT_BM * LtShape<D>::EW +" in src
    assert "stats * stages * 3 * LtShape<D>::BN);" in src
    assert f"<= {SMEM_LIMIT} ? 2 : 1;" in src
    for name, kernel in (("smem_dq", "dq"), ("smem_kv", "dkdv")):
        etiles, stats = E_TILES[kernel], int(kernel == "dkdv")
        assert (f"{name} = lt_smem<D, T>(2, lt_stages<D, T>({etiles}, "
                f"{stats}), {etiles}, {stats});") in src


def test_cpu_backward_runs_the_plain_vjp(rng):
    q, k, v, dout = case(rng, 1, 4, 1, 70, 64)
    kw = dict(causal=True, window=0, scale=0.125)
    before = (ops.launches, ops.launches_bwd, ops.launches_bwd_tf32)
    got = ops.local_attention_bwd(q, k, v, None, dout, **kw)
    want = local_attention_bwd_ref(q, k, v, dout, **kw)
    assert all(torch.equal(a, w) for a, w in zip(got, want, strict=True))
    assert (ops.launches, ops.launches_bwd, ops.launches_bwd_tf32) == before


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="2,8,1,2048,256",
                    help="B,H,KV,S,D (causal, no window)")
    args = ap.parse_args()
    B, H, KV, S, D = (int(x) for x in args.shape.split(","))
    q, k, v, dout = case(np.random.default_rng(0), B, H, KV, S, D)
    kw = dict(causal=True, window=0, scale=D ** -0.5)
    lse = forward_lse(q, k, **kw)
    plain = local_attention_bwd_ref(q, k, v, dout, **kw)
    exact = local_attention_bwd_ref(q.double(), k.double(), v.double(),
                                    dout.double(), **kw)
    g = H // KV
    for products in (6, 3):
        # a query head at a time (the products' memory)
        parts = [[], [], []]
        for h in range(H):
            one = emulate_heads(
                q[:, h:h + 1], k[:, h // g:h // g + 1],
                v[:, h // g:h // g + 1], dout[:, h:h + 1], lse[:, h:h + 1],
                products=products, **kw)
            for acc, part in zip(parts, one, strict=True):
                acc.append(part)
        dq, dk_h, dv_h = (torch.cat(p, 1) for p in parts)
        got = (dq, *fold(dk_h, dv_h, KV, kw["scale"], k.dtype))
        for name, a, pl, ex in zip(("dq", "dk", "dv"), got, plain, exact,
                                   strict=True):
            d_k, d_p = f64_distance(a, ex), f64_distance(pl, ex)
            print(f"{products} products, {args.shape} {name}: distance to "
                  f"f64 {d_k:.3e}, plain f32 {d_p:.3e}, ratio "
                  f"{d_k / d_p:.2f} (limit {F64_FACTOR})", flush=True)


if __name__ == "__main__":
    main()
