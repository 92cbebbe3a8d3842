"""The port's kernel wrappers against the JAX package's kernels.

On the CPU every wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version; the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_kernels.py`` does.  Inputs come from one seeded numpy
generator and go through both.  Tolerances are those of
``tests/test_kernels.py``: atol 1e-5 for the fold and the LSTM step,
rtol/atol 1e-5 for the anchor gradient with rtol 1e-4 on its loss;
windowed attention at atol 2e-5 in f32 and 2e-2 in bf16, the chunked SSD
at atol 2e-5.

The kernels themselves are held against the plain versions on the card in
``tests/test_torch_cuda.py``.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ewc_update.ops import ewc_penalty_grad_flat as jax_ewc
from repro.kernels.fedavg_agg.ops import aggregate_flat as jax_agg_flat
from repro.kernels.fedavg_agg.ops import aggregate_pytrees as jax_agg_trees
from repro.kernels.local_attn.ops import local_flash_attention as jax_local_attn
from repro.kernels.local_attn.ref import local_attention_ref as jax_local_attn_ref
from repro.kernels.lstm_cell.ops import lstm_cell_fused as jax_lstm_fused
from repro.kernels.ssd_chunk.ops import ssd_chunked_pallas as jax_ssd_pallas
from repro.kernels.ssd_chunk.ref import ssd_ref as jax_ssd_ref
from repro.kernels.ssd_chunk.ssd_chunk import ssd_intra_chunk as jax_ssd_intra
from repro.models.lstm import lstm_cell as jax_model_cell
from repro_torch.core.aggregation import _pad_pow2
from repro_torch.kernels import build, launch_counts, reset_launch_counts
from repro_torch.kernels.ewc_update.ops import ewc_penalty_grad_flat
from repro_torch.kernels.dp_clip_noise.ops import privatize_flat
from repro_torch.kernels.ewc_update.ref import ewc_ref
from repro_torch.kernels.fedavg_agg import ops as agg_ops
from repro_torch.kernels.fedavg_agg.ops import (
    MAX_N,
    aggregate_flat,
    aggregate_pytrees,
    fold_chunks,
)
from repro_torch.kernels.fedavg_agg.ref import agg_leaves_ref, agg_ref
from repro_torch.kernels.lstm_cell.ops import LSTMCellFn, lstm_cell_fused, lstm_step
from repro_torch.kernels.local_attn.ops import local_flash_attention
from repro_torch.kernels.local_attn.ref import local_attention_ref
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
from repro_torch.kernels.ssd_chunk.ops import ssd_chunked_fused, ssd_intra_chunk
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref
from repro_torch.models.ssm import ssd_chunked


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ------------------------------------------------------------- fedavg_agg
@pytest.mark.parametrize("n,t", [(2, 17), (2, 8192), (3, 100_000), (8, 4096)])
def test_agg_plain_matches_jax_kernel(n, t, rng):
    x = rng.standard_normal((n, t)).astype(np.float32)
    w = rng.dirichlet(np.ones(n)).astype(np.float32)
    ref = np.asarray(jax_agg_flat(jnp.asarray(x), jnp.asarray(w)))
    out = aggregate_flat(t32(x), w.tolist())
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(agg_ref(t32(x), w.tolist()).numpy(), ref,
                               atol=1e-5)


@pytest.mark.parametrize("n", [3, 5, 17])
def test_agg_pad_pow2_is_exact(n, rng):
    """Zero-weight padding to the next power of two leaves the fold
    bit-unchanged, as the reference's ``_pad_pow2`` promises."""
    rows = [t32(rng.standard_normal(257)) for _ in range(n)]
    ws = rng.dirichlet(np.ones(n)).tolist()
    sets, pws = _pad_pow2(rows, ws)
    assert len(sets) == 1 << (n - 1).bit_length()
    plain = aggregate_flat(torch.stack(rows), ws)
    padded = aggregate_flat(torch.stack(sets), pws)
    assert torch.equal(plain, padded)
    ref = np.asarray(jax_agg_flat(jnp.asarray(torch.stack(sets).numpy()),
                                  jnp.asarray(pws, jnp.float32)))
    np.testing.assert_allclose(padded.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("n", [64, 65, 70, 128, 200])
def test_agg_fold_chunks_equals_the_flat_fold(n, rng):
    """The CUDA route folds more than MAX_N sets in ordered chunks behind
    the running sum at weight 1.0; with the row-ordered plain fold in each
    chunk that is the flat fold, bit for bit, and the JAX kernel's sum."""
    x = rng.standard_normal((n, 257)).astype(np.float32)
    ws = rng.dirichlet(np.ones(n)).tolist()
    calls = []

    def fold(rows, w):
        assert rows.shape[0] == len(w) <= MAX_N
        calls.append(len(w))
        return agg_ref(rows, w)

    out = fold_chunks(t32(x), ws, fold)
    assert len(calls) == 1 + -(-(n - MAX_N) // (MAX_N - 1))
    assert torch.equal(out, agg_ref(t32(x), ws))
    ref = np.asarray(jax_agg_flat(jnp.asarray(x), jnp.asarray(ws, jnp.float32)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


class CudaView(torch.Tensor):
    """A CPU tensor (and its slices) that says it is on CUDA, so
    ``aggregate_flat`` takes its CUDA route; ``new_empty`` (the output)
    goes through ``keep``, which ``stacked_route`` sets."""

    keep = None

    @property
    def is_cuda(self):
        return True

    def new_empty(self, *a, **kw):
        return self.keep(torch.Tensor.new_empty)(self.as_subclass(
            torch.Tensor), *a, **kw)


def stacked_route(monkeypatch):
    """Send CPU tensors down ``aggregate_flat``'s CUDA route with a Python
    stand-in for the C call: it finds the rows by their pointer, unpacks
    the weights from the bytes the wrapper packs, folds them in set order
    as ``agg_ref`` does and writes the output by its pointer.  Returns the
    tensors it can find and the launches seen, as (n, t, weights)."""
    tensors, calls = [], []
    real_cat = torch.cat

    def keep(make):
        def call(*a, **kw):
            t = make(*a, **kw)
            tensors.append(t)
            return t
        return call

    def at(ptr, n):
        for t in tensors:
            off = (ptr - t.data_ptr()) // 4
            if 0 <= off and off + n <= t.numel():
                return t.reshape(-1)[off:off + n]
        raise AssertionError(f"pointer {ptr} is no tensor of the call")

    class Library:
        def fedavg_agg_launch(self, x, weights, n, t, out, stream):
            ws = list(struct.unpack(f"{n}f", weights))
            at(out, t).copy_(agg_ref(at(x, n * t).reshape(n, t), ws))
            calls.append((n, t, ws))
            return 0

    monkeypatch.setattr(CudaView, "keep", staticmethod(keep), raising=False)
    monkeypatch.setattr(build, "library", lambda: Library())
    monkeypatch.setattr(build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(agg_ops.torch, "cat", keep(real_cat))
    return tensors, calls


@pytest.mark.parametrize("t", [37, 40])          # T odd, T % 4 == 0
@pytest.mark.parametrize("n", [1, 2, 64, 65, 130])
def test_agg_stacked_host_path_packs_one_launch_up_to_64_sets(
        n, t, rng, monkeypatch):
    """The stacked route's host path, read back on the CPU: one launch of
    all N sets up to MAX_N, ordered chunks past them (the first weight of a
    later chunk 1.0, the running sum), the weights packed as f32 in set
    order; the fold bit for bit ``agg_ref``, ``fold_chunks`` of the plain
    fold and the fold by leaves."""
    x = t32(rng.standard_normal((n, t)))
    ws = rng.dirichlet(np.ones(n)).tolist()
    want = agg_ref(x, ws)
    chunked = fold_chunks(x, ws, agg_ref)
    leaves = agg_leaves_ref([[row] for row in x], ws)
    tensors, calls = stacked_route(monkeypatch)
    tensors.append(x)
    reset_launch_counts()
    got = aggregate_flat(x.as_subclass(CudaView), ws).as_subclass(
        torch.Tensor)
    assert len(calls) == agg_ops.launches_stacked == agg_ops.launches == \
        1 + max(0, -(-(n - MAX_N) // (MAX_N - 1)))
    f32 = [struct.unpack("f", struct.pack("f", w))[0] for w in ws]
    assert calls[0] == (min(n, MAX_N), t, f32[:MAX_N])
    for i, (m, tt, w) in enumerate(calls[1:]):
        lo = MAX_N + i * (MAX_N - 1)
        assert (m, tt) == (len(w), t) and w == [1.0] + f32[lo:lo + m - 1]
    assert torch.equal(got, want) and torch.equal(got, chunked)
    assert torch.equal(got, leaves)
    reset_launch_counts()


def test_agg_pytrees_matches_jax(rng):
    trees_np = [{"b": {"c": rng.standard_normal(11).astype(np.float32)},
                 "a": rng.standard_normal((5, 7)).astype(np.float32)}
                for _ in range(3)]
    w = [0.2, 0.3, 0.5]
    ref = jax_agg_trees([jax.tree.map(jnp.asarray, t) for t in trees_np], w)
    out = aggregate_pytrees([{"b": {"c": t32(t["b"]["c"])}, "a": t32(t["a"])}
                             for t in trees_np], w)
    assert list(out) == ["b", "a"]            # the template's key order
    np.testing.assert_allclose(out["a"].numpy(), np.asarray(ref["a"]),
                               atol=1e-5)
    np.testing.assert_allclose(out["b"]["c"].numpy(),
                               np.asarray(ref["b"]["c"]), atol=1e-5)


def test_agg_identity_skip_returns_the_tree():
    tree = {"w": torch.ones(3)}
    assert aggregate_pytrees([tree], [1.0]) is tree


# ------------------------------------------------------------- ewc_update
@pytest.mark.parametrize("t", [5, 8192, 65536 + 3])
@pytest.mark.parametrize("lam", [0.1, 1.0, 7.5])
def test_ewc_plain_matches_jax_kernel(t, lam, rng):
    g, p, a = (rng.standard_normal(t).astype(np.float32) for _ in range(3))
    f = np.abs(rng.standard_normal(t)).astype(np.float32)
    gj, lj = jax_ewc(lam, *(jnp.asarray(v) for v in (g, p, a, f)))
    go, loss = ewc_penalty_grad_flat(lam, t32(g), t32(p), t32(a), t32(f))
    np.testing.assert_allclose(go.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-4)


def test_ewc_l2sp_needs_no_fisher(rng):
    t = 1000
    g, p, a = (rng.standard_normal(t).astype(np.float32) for _ in range(3))
    gj, lj = jax_ewc(0.5, jnp.asarray(g), jnp.asarray(p), jnp.asarray(a),
                     None)
    go, loss = ewc_penalty_grad_flat(0.5, t32(g), t32(p), t32(a))
    np.testing.assert_allclose(go.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-4)
    go1, l1 = ewc_ref(0.5, t32(g), t32(p), t32(a), torch.ones(t))
    assert torch.equal(go, go1)
    np.testing.assert_allclose(float(loss), float(l1), rtol=1e-6)


# -------------------------------------------------------------- lstm_cell
def lstm_case(rng, b, i, h):
    return (rng.standard_normal((b, i)).astype(np.float32),
            rng.standard_normal((b, h)).astype(np.float32),
            rng.standard_normal((b, h)).astype(np.float32),
            (rng.standard_normal((i, 4 * h)) * .1).astype(np.float32),
            (rng.standard_normal((h, 4 * h)) * .1).astype(np.float32),
            (rng.standard_normal(4 * h) * .1).astype(np.float32))


@pytest.mark.parametrize("B,I,H", [(1, 5, 64), (8, 10, 128), (13, 32, 256),
                                   (7, 9, 128), (26, 10, 128)])
def test_lstm_plain_matches_jax_kernel(B, I, H, rng):
    x, h, c, wx, wh, b = lstm_case(rng, B, I, H)
    pj = {"wx": jnp.asarray(wx), "wh": jnp.asarray(wh), "b": jnp.asarray(b)}
    hj, cj = jax_lstm_fused(pj, jnp.asarray(x), jnp.asarray(h),
                            jnp.asarray(c))
    hm, cm = jax_model_cell(pj, jnp.asarray(x), jnp.asarray(h),
                            jnp.asarray(c))
    pt = {"wx": t32(wx), "wh": t32(wh), "b": t32(b)}
    hn, cn = lstm_cell_fused(pt, t32(x), t32(h), t32(c))
    for got, want in ((hn, hj), (cn, cj), (hn, hm), (cn, cm)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)


def test_lstm_fn_gradcheck_float64():
    gen = torch.Generator().manual_seed(0)
    b, i, h = 3, 4, 5
    args = [torch.randn(*s, generator=gen, dtype=torch.float64)
            .mul_(0.5).requires_grad_()
            for s in ((b, i), (b, h), (b, h), (i, 4 * h), (h, 4 * h),
                      (4 * h,))]
    assert torch.autograd.gradcheck(LSTMCellFn.apply, args, eps=1e-6,
                                    atol=1e-7)


def test_lstm_fn_backward_matches_autograd_of_plain_cell(rng):
    args = [t32(a).requires_grad_() for a in lstm_case(rng, 8, 10, 32)]
    wh_, wc_ = t32(rng.standard_normal((8, 32))), t32(rng.standard_normal((8, 32)))
    hk, ck = LSTMCellFn.apply(*args)
    gk = torch.autograd.grad((hk * wh_).sum() + (ck * wc_).sum(), args)
    hr, cr = lstm_cell_ref(*args)
    gr = torch.autograd.grad((hr * wh_).sum() + (cr * wc_).sum(), args)
    for a, b in zip(gk, gr, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------- local_attn
def to_np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("H,KV,S,causal,window,dtype", [
    (4, 2, 64, True, 0, "float32"),
    (4, 1, 96, True, 32, "float32"),
    (2, 2, 64, False, 0, "float32"),
    (8, 4, 128, True, 64, "float32"),
    (4, 2, 64, True, 16, "bfloat16"),
])
def test_local_attn_plain_matches_jax_kernel(H, KV, S, causal, window, dtype,
                                            rng):
    """The reference sweep (``tests/test_kernels.py``): JAX's Pallas kernel
    in interpret mode against the port's wrapper (plain route on the CPU)
    and its plain version, at atol 2e-5 in f32 and 2e-2 in bf16."""
    arrs = [rng.standard_normal((2, n, S, 32)).astype(np.float32)
            for n in (H, KV, KV)]
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    q, k, v = (torch.tensor(np.asarray(a.astype(jnp.float32)))
               .to(getattr(torch, dtype)) for a in (jq, jk, jv))
    ref = np.asarray(jax_local_attn(jq, jk, jv, causal=causal, window=window,
                                    scale=0.18, blk_q=32, blk_k=32),
                     np.float32)
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    out = local_flash_attention(q, k, v, causal=causal, window=window,
                                scale=0.18)
    assert out.dtype == q.dtype and out.shape == q.shape
    np.testing.assert_allclose(to_np(out), ref, atol=atol)
    plain = local_attention_ref(q, k, v, causal=causal, window=window,
                                scale=0.18)
    jplain = jax_local_attn_ref(jq, jk, jv, causal=causal, window=window,
                                scale=0.18)
    np.testing.assert_allclose(to_np(plain), np.asarray(jplain, np.float32),
                               atol=atol)


def test_local_attn_window_actually_limits_context(rng):
    """Tokens outside the window must not influence the output."""
    S, W = 64, 8
    q, k, v = (t32(rng.standard_normal((1, 2, S, 16))) for _ in range(3))
    out1 = local_flash_attention(q, k, v, causal=True, window=W, scale=0.25)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, :S - 2 * W] = 99.0
    v2[:, :, :S - 2 * W] = -99.0
    out2 = local_flash_attention(q, k2, v2, causal=True, window=W, scale=0.25)
    np.testing.assert_allclose(out1[:, :, -1].numpy(), out2[:, :, -1].numpy(),
                               atol=1e-5)
    ref = jax_local_attn(jnp.asarray(q.numpy()), jnp.asarray(k2.numpy()),
                         jnp.asarray(v2.numpy()), causal=True, window=W,
                         scale=0.25, blk_q=16, blk_k=16)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref), atol=2e-5)


# ------------------------------------------------------------- ssd_chunk
def ssd_case(rng, b, c, l, h, p, n):
    """Head-broadcast kernel inputs: xdt, dA (negative), B, C."""
    return (t32(rng.standard_normal((b, c, l, h, p))),
            t32(-np.abs(rng.standard_normal((b, c, l, h))) * 0.5),
            t32(rng.standard_normal((b, c, l, h, n))),
            t32(rng.standard_normal((b, c, l, h, n))))


@pytest.mark.parametrize("b,c,l,h,p,n", [(1, 2, 4, 2, 4, 8),
                                         (2, 3, 8, 4, 8, 16),
                                         (1, 1, 32, 2, 16, 32)])
def test_ssd_intra_chunk_plain_matches_jax_kernel(b, c, l, h, p, n, rng):
    """The kernel's own function against JAX's kernel in interpret mode.
    Outputs reach ~30 here (sums of l * n unit products), so the bound is
    atol 2e-5 plus rtol 1e-5: f32 sums taken in another order."""
    args = ssd_case(rng, b, c, l, h, p, n)
    jy, jst = jax_ssd_intra(*(jnp.asarray(a.numpy()) for a in args))
    for fn in (ssd_intra_chunk, ssd_intra_chunk_ref):
        y, st = fn(*args)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("b,c,l,h,p,n", [(1, 2, 4, 2, 4, 8),
                                         (2, 3, 8, 4, 8, 16),
                                         (1, 1, 32, 2, 16, 32)])
def test_ssd_intra_chunk_plain_computes_f64_inputs_in_f64(b, c, l, h, p, n,
                                                          rng):
    """The exact answer the card measures both f32 routes from: f64 inputs
    give f64 outputs, nearer JAX's f32 kernel than its own tolerance and
    within f32 rounding of the f32 plain version."""
    args = ssd_case(rng, b, c, l, h, p, n)
    jy, jst = jax_ssd_intra(*(jnp.asarray(a.numpy()) for a in args))
    exact = ssd_intra_chunk_ref(*(a.double() for a in args))
    for got, want, f32 in zip(exact, (jy, jst), ssd_intra_chunk_ref(*args),
                              strict=True):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(f32.double().numpy(), got.numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [
    (1, 16, 2, 4, 1, 8, 4),
    (2, 32, 4, 8, 2, 16, 8),
    (1, 20, 2, 16, 1, 32, 8),     # l not divisible by chunk (padding path)
])
def test_ssd_chunked_matches_jax(b, l, h, p, g, n, chunk, rng):
    """The reference sweep: the port's fused scan (plain intra-chunk route
    on the CPU) and its plain oracle against JAX's Pallas scan (interpret
    mode) and JAX's oracle, at atol 2e-5."""
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(jnp.asarray(
        rng.standard_normal((b, l, h)), jnp.float32)))
    A = np.asarray(-jnp.exp(jnp.asarray(rng.standard_normal(h) * 0.5,
                                        jnp.float32)))
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    jy, js = jax_ssd_pallas(*jargs, chunk)
    ry, rs = jax_ssd_ref(*jargs, chunk)
    targs = [t32(a) for a in (x, dt, A, B, C)]
    for fn in (ssd_chunked_fused, ssd_chunked):
        y, s = fn(*targs, chunk)
        assert y.shape == (b, l, h, p) and s.shape == (b, h, p, n)
        for want_y, want_s in ((jy, js), (ry, rs)):
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=2e-5)
            np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=2e-5)


def test_ssd_chunked_carries_an_initial_state(rng):
    b, l, h, p, n, chunk = 1, 12, 2, 4, 8, 4
    x, B, C = (t32(rng.standard_normal(s)) for s in
               ((b, l, h, p), (b, l, 1, n), (b, l, 1, n)))
    dt = t32(np.abs(rng.standard_normal((b, l, h))))
    A = t32(-np.abs(rng.standard_normal(h)))
    s0 = t32(rng.standard_normal((b, h, p, n)))
    jy, js = jax_ssd_ref(*(jnp.asarray(t.numpy()) for t in (x, dt, A, B, C)),
                         chunk, jnp.asarray(s0.numpy()))
    for fn in (ssd_chunked_fused, ssd_chunked):
        y, s = fn(x, dt, A, B, C, chunk, s0)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=2e-5)


# ---------------------------------------------------------------- routing
def test_cpu_calls_run_the_plain_versions_and_count_nothing(rng):
    reset_launch_counts()
    x, h, c, wx, wh, b = (t32(a) for a in lstm_case(rng, 2, 3, 4))
    lstm_step(x, h, c, wx, wh, b)
    aggregate_flat(torch.stack([x[0], x[1]]), [0.5, 0.5])
    ewc_penalty_grad_flat(0.1, x[0], x[1], x[0])
    privatize_flat(x[0], x[1], 1.0, 0.5)
    q = t32(rng.standard_normal((1, 2, 5, 16)))
    local_flash_attention(q, q[:, :1], q[:, :1], causal=True, window=0,
                          scale=0.25)
    xdt, dA, B, C = ssd_case(rng, 1, 1, 4, 2, 3, 5)
    ssd_intra_chunk(xdt, dA, B, C)
    assert launch_counts() == {"fedavg_agg": 0, "lstm_cell": 0,
                               "ewc_update": 0, "dp_clip_noise": 0,
                               "ssd_chunk": 0, "local_attn": 0}


def test_wrappers_refuse_devices_without_a_route():
    m = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no route"):
        aggregate_flat(m, [0.25] * 4)
    with pytest.raises(ValueError, match="no route"):
        ewc_penalty_grad_flat(0.1, m[0], m[0], m[0])
    with pytest.raises(ValueError, match="no route"):
        privatize_flat(m[0], m[0], 1.0, 0.5)
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no route"):
        local_flash_attention(q, q, q)
    x = torch.empty(1, 1, 4, 2, 3, device="meta")
    with pytest.raises(ValueError, match="no route"):
        ssd_intra_chunk(x, x[..., 0], x, x)


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "CUDA_DEFAULT_HOME", tmp_path / "cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
