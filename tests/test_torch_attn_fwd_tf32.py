"""The split-tf32 forward of ``local_attn`` (``csrc/local_attn_tf32.cu``)
on the CPU: its numerical scheme, its tiles and its shared memory.

The card is the only place the kernel runs, so its arithmetic is emulated
here in plain PyTorch, as it rounds.  Both products (S = Q Kᵀ over D, O =
P V over a key tile) run on mma.sync m16n8k8 tf32 with f32 accumulation
over the two-part split (hi = tf32(x), lo = x - hi cut to 10 bits by the
tensor core) and three partial products, each k-step of 8 into a fresh
accumulator added to the running sum in f32 (the helpers of
``tests/test_torch_attn_bwd_tf32.py``, which emulates the backward the
same way).  The scores are scale · S in f32, masked to the reference's
finite -2^30; an online softmax over key tiles of ``BLOCK_N`` keys keeps
each row's max m and sum l in f32 (c = exp(m_old - m_new), l = l c +
sum_t exp(x - m_new), O = O c + P V); the output is O / max(l, 1e-30) in
the inputs' dtype and lse = m + log l.  Visiting every key tile for every
row, as the emulation does, gives the kernel's numbers: a tile the kernel
skips is either fully masked after a row's first allowed key (c = 1,
P = 0) or before it (its exp(0) weights are wiped by the next tile's c =
0).

The emulation is held two ways: at most twice as far from the function
evaluated in f64 as the plain f32 version (``ATTN_F64_FACTOR`` of
``chip_smoke.py``, the limit the card holds the kernel to), and within
1e-5 of the JAX package's ``local_flash_attention`` on the same numpy
inputs (its Pallas kernel in interpret mode, as the JAX package's tests
run it).  bf16 at D 16 and 32 takes the same kernel (bf16 is exact in a
tf32 hi part).  The kernel's constants and shared memory are read from
its source.  The distances at a larger shape:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_attn_fwd_tf32.py \
        [--shape B,H,KV,S,D]

(default gemma-2b's, 2 x 2048; minutes on a CPU).
"""

import argparse
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.local_attn.ops import local_flash_attention as jax_local_attn
from repro_torch.kernels import build
from repro_torch.kernels.local_attn import ops
from repro_torch.kernels.local_attn.ref import NEG_INF, local_attention_ref
from test_torch_attn_bwd_tf32 import (
    BLOCK_M,
    BLOCK_N,
    CASES,
    PAD,
    SCHEMES,
    SMEM_LIMIT,
    allowed,
    case,
    f64_distance,
    mm,
    split,
)

F64_FACTOR = 2.0
JAX_TOL = 1e-5
SPLIT = 2          # LF_SPLIT: warps a row group
STAGES = 2         # LF_STAGES: the K / V ring


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def step_products(a, b, products=ops.TF32_PRODUCTS):
    """a @ b's k-steps of 8 (zero-padded) as the kernel forms them, each
    into a fresh f32 accumulator: (..., steps, M, N), to be added to a
    running sum in order."""
    k = a.shape[-1]
    pad = (-k) % 8
    a = torch.nn.functional.pad(a.float(), (0, pad))
    b = torch.nn.functional.pad(b.float().transpose(-1, -2),
                                (0, pad)).transpose(-1, -2)
    n = (k + pad) // 8
    pa = [t.double().unflatten(-1, (n, 8)).movedim(-2, -3)
          for t in split(a, products)]
    pb = [t.double().unflatten(-2, (n, 8)) for t in split(b, products)]
    t = None
    for i, j in SCHEMES[products]:
        prod = pa[i] @ pb[j]
        t = prod.float() if t is None else (t.double() + prod).float()
    return t


def emulate_fwd(q, k, v, *, causal, window, scale,
                products=ops.TF32_PRODUCTS):
    """What the forward kernel computes, rounding where it rounds: (out in
    the inputs' dtype, lse in f32)."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    g = H // KV
    bn = BLOCK_N[D]
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    s = mm(q.float(), kf.transpose(-1, -2), products)
    x = torch.where(allowed(S, T, causal, window), s * scale,
                    torch.tensor(NEG_INF))
    m = torch.full((B, H, S), NEG_INF)
    l = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, D)
    for t0 in range(0, T, bn):
        xt = x[..., t0:t0 + bn]
        mn = torch.maximum(m, xt.amax(-1))
        c = torch.exp(m - mn)
        p = torch.exp(xt - mn[..., None])
        l = l * c + p.sum(-1)
        acc = acc * c[..., None]
        for step in step_products(p, vf[:, :, t0:t0 + bn],
                                  products).unbind(-3):
            acc = acc + step
        m = mn
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype), m + torch.log(l)


def jax_forward(q, k, v, **kw):
    """The JAX package's kernel route, f32 in (interpret mode on the
    CPU)."""
    def as_jax(t):
        return jnp.asarray(t.float().numpy(), jnp.float32)

    return np.asarray(jax_local_attn(as_jax(q), as_jax(k), as_jax(v), **kw),
                      np.float32)


def exact_lse(q, k, *, causal, window, scale):
    g = q.shape[1] // k.shape[1]
    s = q.double() @ k.double().repeat_interleave(g, 1).transpose(-1, -2)
    s = torch.where(allowed(q.shape[2], k.shape[2], causal, window),
                    s * scale, torch.tensor(float("-inf"), dtype=s.dtype))
    return torch.logsumexp(s, dim=-1)


@pytest.mark.parametrize("B,H,KV,S,D,causal,window", CASES)
def test_tf32_forward_is_as_close_to_f64_as_the_plain_version(
        B, H, KV, S, D, causal, window, rng):
    q, k, v, _ = case(rng, B, H, KV, S, D)
    kw = dict(causal=causal, window=window, scale=D ** -0.5)
    got, lse = emulate_fwd(q, k, v, **kw)
    plain = local_attention_ref(q, k, v, **kw)
    exact = local_attention_ref(q.double(), k.double(), v.double(), **kw)
    d_k, d_p = f64_distance(got, exact), f64_distance(plain, exact)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert d_k <= F64_FACTOR * d_p, (d_k, d_p)
    np.testing.assert_allclose(got.numpy(), jax_forward(q, k, v, **kw),
                               rtol=0, atol=JAX_TOL)
    want = exact_lse(q, k, **kw)
    assert (lse.double() - want).abs().max().item() <= 2e-5 * max(
        1.0, want.abs().max().item())


@pytest.mark.parametrize("D", [16, 32])
def test_tf32_forward_takes_bf16_at_small_head_dims(D, rng):
    """bf16 at D 16 and 32 (bf16 is exact in a tf32 hi part); the output
    rounds to bf16."""
    q, k, v, _ = case(rng, 1, 4, 2, 100, D, torch.bfloat16)
    kw = dict(causal=True, window=24, scale=D ** -0.5)
    got, _ = emulate_fwd(q, k, v, **kw)
    plain = local_attention_ref(q, k, v, **kw)
    exact = local_attention_ref(q.double(), k.double(), v.double(), **kw)
    assert got.dtype == torch.bfloat16 and got.shape == plain.shape
    assert f64_distance(got, exact) <= F64_FACTOR * f64_distance(plain, exact)
    # bf16 parts: the split's lo parts are 0, so the products are exact
    for t in (q, k, v):
        hi, lo = split(t.float(), 3)
        assert torch.equal(hi, t.float()) and not lo.any()


def fwd_smem_bytes(D, dtype):
    """The kernel's dynamic shared memory: the Q tile of BLOCK_M rows,
    STAGES x 2 streamed tiles of BLOCK_N rows (each row D + PAD elements),
    the E tile (BLOCK_M x (BLOCK_N + 4) f32) and the row groups' maxima and
    sums (BLOCK_M x SPLIT f32)."""
    el = torch.tensor([], dtype=dtype).element_size()
    bn = BLOCK_N[D]
    return ((BLOCK_M + STAGES * 2 * bn) * (D + PAD[dtype]) * el
            + 4 * (BLOCK_M * (bn + 4) + BLOCK_M * SPLIT))


@pytest.mark.parametrize("D", ops.HEAD_DIMS)
def test_forward_shared_memory_fits_two_stages(D):
    dtypes = [torch.float32] + ([torch.bfloat16] if D in (16, 32) else [])
    for dtype in dtypes:
        assert fwd_smem_bytes(D, dtype) <= SMEM_LIMIT, (D, dtype)
        assert ops.route(dtype, D) == "tf32"
    # a warp's score and output columns are whole 8-column n-tiles
    assert BLOCK_N[D] % (8 * SPLIT) == 0 and D % (8 * SPLIT) == 0
    assert fwd_smem_bytes(256, torch.float32) == 209408     # 204.5 KB


def test_wrapper_constants_mirror_the_forward_source():
    """``SPLIT``, ``STAGES``, ``fwd_smem_bytes``' terms, the tiles and
    ``ops.TF32_PRODUCTS`` are the kernel source's (with the helpers it
    shares with the backward), and the C entry point takes as many
    arguments as ``build.SIGNATURES`` gives it."""
    csrc = Path(ops.__file__).parents[1] / "csrc"
    fwd = (csrc / "local_attn_tf32.cu").read_text()
    common = (csrc / "local_attn_tf32_common.cuh").read_text()
    assert int(re.search(r"#define LF_SPLIT (\d)", fwd).group(1)) == SPLIT
    assert int(re.search(r"#define LF_STAGES (\d)", fwd).group(1)) == STAGES
    assert int(re.search(r"#define LT_BM (\d+)", common).group(1)) == BLOCK_M
    parts = int(re.search(r"#define LT_PARTS (\d)", common).group(1))
    assert ops.TF32_PRODUCTS == {2: 3, 3: 6}[parts]
    big, small = map(int, re.search(r"BN = D == 256 \? (\d+) : (\d+);",
                                    common).groups())
    assert BLOCK_N == {d: big if d == 256 else small for d in ops.HEAD_DIMS}
    assert "EW = BN + 4;" in common
    assert "return (LT_BM + LF_STAGES * 2 * LtShape<D>::BN) * " \
        "(D + LtPad<T>::v) *" in fwd
    assert "4 * (LT_BM * LtShape<D>::EW + LT_BM * LF_SPLIT);" in fwd
    assert f"lf_smem<D, T>() <= {SMEM_LIMIT}," in fwd
    params = re.search(r'extern "C" int local_attn_tf32_launch\(([^)]*)\)',
                       fwd).group(1)
    assert len(params.split(",")) == len(
        build.SIGNATURES["local_attn_tf32_launch"]) == 28
    assert "local_attn_kernel" not in build.SIGNATURES
    assert not (csrc / "local_attn.cu").exists()


def test_cpu_forward_runs_the_plain_version(rng):
    q, k, v, _ = case(rng, 1, 4, 1, 70, 64)
    kw = dict(causal=True, window=0, scale=0.125)
    before = (ops.launches, ops.launches_tc, ops.launches_tf32)
    got = ops.local_flash_attention(q, k, v, **kw)
    assert torch.equal(got, local_attention_ref(q, k, v, **kw))
    assert (ops.launches, ops.launches_tc, ops.launches_tf32) == before


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="2,8,1,2048,256",
                    help="B,H,KV,S,D (causal, no window)")
    args = ap.parse_args()
    B, H, KV, S, D = (int(x) for x in args.shape.split(","))
    q, k, v, _ = case(np.random.default_rng(0), B, H, KV, S, D)
    kw = dict(causal=True, window=0, scale=D ** -0.5)
    g = H // KV
    for products in (6, 3):
        worst = []
        for h in range(H):            # a query head at a time (memory)
            one = (q[:, h:h + 1], k[:, h // g:h // g + 1],
                   v[:, h // g:h // g + 1])
            got, _ = emulate_fwd(*one, products=products, **kw)
            plain = local_attention_ref(*one, **kw)
            exact = local_attention_ref(*(t.double() for t in one), **kw)
            worst.append((f64_distance(got, exact),
                          f64_distance(plain, exact)))
        d_k, d_p = max(w[0] for w in worst), max(w[1] for w in worst)
        print(f"{products} products, {args.shape}: distance to f64 (worst "
              f"head) {d_k:.3e}, plain f32 {d_p:.3e}, ratio {d_k / d_p:.2f} "
              f"(limit {F64_FACTOR})", flush=True)


if __name__ == "__main__":
    main()
