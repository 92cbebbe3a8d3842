"""The shapes the port's kernels once refused, and the SSD's per-group B
and C, against the JAX package on the CPU.

On the CPU every wrapper runs its plain version; the JAX side runs its
Pallas kernels in interpret mode (``tests/test_kernels.py``).  Inputs come
from one seeded numpy generator and go through both.

- SSD: the plain version takes B and C once per group, (b, c, l, g, n); JAX's
  kernel takes them repeated per head (``jnp.repeat(B, h // g)``).  Held at
  max|port - JAX| <= 1e-5 * max(1, max|JAX|): outputs reach ~100 at n 160,
  sums of up to l * n unit products taken in another order, where entries
  near 0 carry the rounding of their large neighbours (the card's
  path-shape bound has the same form at 2e-5).  The fused scan against
  JAX's Pallas scan at atol 2e-5 (the reference sweep's tolerance) plus
  rtol 1e-5.
- ``local_attn`` at head dims 80 (hubert-xlarge) and 192 (MLA's qk): the
  plain version against JAX's ``flash_tiled`` at atol 2e-5 in f32 and 2e-2
  in bf16; the wrapper's zero-padding of the head dim, run through the
  plain version at the caller's scale and sliced, against the unpadded
  plain output at atol 1e-6 (the same sums plus zeros).
- LSTM: the route each (hidden, input) takes, and the forecaster at hidden 6
  (the chained step route) against JAX's forecaster with the weights carried
  across, at atol 1e-5, its loss gradient at rtol 1e-4 / atol 1e-5.

The kernels themselves are held at these shapes on the card in
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.solar_lstm import SolarLSTMConfig as JaxConfig
from repro.kernels.local_attn.local_attn import flash_tiled as jax_flash_tiled
from repro.kernels.ssd_chunk.ops import ssd_chunked_pallas as jax_ssd_pallas
from repro.kernels.ssd_chunk.ssd_chunk import ssd_intra_chunk as jax_ssd_intra
from repro.models.lstm import SolarForecaster as JaxForecaster
from repro.training.losses import solar_loss as jax_solar_loss
from repro_torch.configs.solar_lstm import SolarLSTMConfig
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.local_attn import ops as attn_ops
from repro_torch.kernels.local_attn.ops import local_flash_attention
from repro_torch.kernels.local_attn.ref import local_attention_ref
from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk.ops import (
    heads_per_block,
    ssd_chunked_fused,
    ssd_intra_chunk,
)
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref
from repro_torch.models.lstm import SolarForecaster, lstm_scan
from repro_torch.training.losses import solar_loss
from repro_torch.utils.tree import params_from_numpy, tree_leaves


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
    return torch.from_numpy(np.array(a, np.float32))


def close_to_scale(got, want, rtol=1e-5):
    """max|got - want| <= rtol * max(1, max|want|) (module docstring)."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rtol * max(1.0, np.abs(want).max()), err


# ------------------------------------------------------------- ssd_chunk
def ssd_group_case(rng, b, c, l, h, p, g, n):
    """Kernel inputs with one B and C per group: xdt, dA (negative), B, C."""
    return (t32(rng.standard_normal((b, c, l, h, p))),
            t32(-np.abs(rng.standard_normal((b, c, l, h))) * 0.5),
            t32(rng.standard_normal((b, c, l, g, n))),
            t32(rng.standard_normal((b, c, l, g, n))))


SSD_GROUP_CASES = [  # b, c, l, h, p, g, n
    (1, 2, 16, 4, 8, 1, 16),
    (2, 1, 24, 4, 8, 2, 16),
    (1, 2, 16, 4, 8, 4, 16),       # g == h: the head-broadcast call
    (1, 1, 32, 4, 80, 2, 160),     # n 160 and p 80: past the old caps
    (1, 2, 20, 2, 80, 1, 160),
    (1, 1, 16, 6, 65, 3, 160),     # p not a multiple of 4
]


@pytest.mark.parametrize("b,c,l,h,p,g,n", SSD_GROUP_CASES)
def test_ssd_plain_with_group_b_c_matches_jax_kernel(b, c, l, h, p, g, n,
                                                     rng):
    xdt, dA, B, C = ssd_group_case(rng, b, c, l, h, p, g, n)
    rep = [jnp.repeat(jnp.asarray(t.numpy()), h // g, axis=3) for t in (B, C)]
    jy, jst = jax_ssd_intra(jnp.asarray(xdt.numpy()), jnp.asarray(dA.numpy()),
                            *rep)
    for fn in (ssd_intra_chunk, ssd_intra_chunk_ref):
        y, st = fn(xdt, dA, B, C)
        assert y.shape == (b, c, l, h, p) and st.shape == (b, c, h, n, p)
        close_to_scale(y.numpy(), jy)
        close_to_scale(st.numpy(), jst)


@pytest.mark.parametrize("b,c,l,h,p,g,n", SSD_GROUP_CASES[:4])
def test_ssd_plain_per_group_equals_its_head_broadcast(b, c, l, h, p, g, n,
                                                       rng):
    """B and C once per group give the bits of the same B and C repeated
    per head: the plain version forms C Bᵀ per group and hands it to each
    head of the group."""
    xdt, dA, B, C = ssd_group_case(rng, b, c, l, h, p, g, n)
    got = ssd_intra_chunk_ref(xdt, dA, B, C)
    want = ssd_intra_chunk_ref(xdt, dA, *(t.repeat_interleave(h // g, dim=3)
                                         for t in (B, C)))
    for a, w in zip(got, want, strict=True):
        assert torch.equal(a, w)


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [
    (1, 16, 4, 4, 1, 8, 4),
    (2, 32, 4, 8, 2, 16, 8),
    (1, 20, 4, 16, 2, 32, 8),     # l not divisible by chunk (padding path)
    (1, 40, 2, 80, 1, 160, 16),   # n 160, p 80
])
def test_ssd_chunked_fused_with_group_b_c_matches_jax(b, l, h, p, g, n,
                                                      chunk, rng):
    """The fused scan (per-group B and C straight into the intra-chunk
    route, y_off from the grouped C) against JAX's Pallas scan."""
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(jnp.asarray(
        rng.standard_normal((b, l, h)), jnp.float32)))
    A = np.asarray(-jnp.exp(jnp.asarray(rng.standard_normal(h) * 0.5,
                                        jnp.float32)))
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    jy, js = jax_ssd_pallas(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                            chunk)
    y, s = ssd_chunked_fused(*(t32(a) for a in (x, dt, A, B, C)), chunk)
    assert y.shape == (b, l, h, p) and s.shape == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=2e-5)


def test_ssd_fused_passes_the_groups_to_the_kernel_uncopied(rng,
                                                            monkeypatch):
    """The wrapper hands the intra-chunk route B and C with g groups, not
    one copy per head."""
    seen = []
    orig = ssd_ops.ssd_intra_chunk

    def spy(xdt, dA, B, C):
        seen.append((tuple(xdt.shape), tuple(B.shape), tuple(C.shape)))
        return orig(xdt, dA, B, C)
    monkeypatch.setattr(ssd_ops, "ssd_intra_chunk", spy)
    x = t32(rng.standard_normal((2, 16, 8, 4)))
    dt = t32(np.abs(rng.standard_normal((2, 16, 8))))
    A = t32(-np.abs(rng.standard_normal(8)))
    B, C = (t32(rng.standard_normal((2, 16, 2, 5))) for _ in range(2))
    ssd_chunked_fused(x, dt, A, B, C, 8)
    assert seen == [((2, 2, 8, 8, 4), (2, 2, 8, 2, 5), (2, 2, 8, 2, 5))]


@pytest.mark.parametrize("blocks,h,g,sms,l,want", [
    (32, 32, 1, 132, 256, 4),   # mamba2-370m scoring, b 4 x 8 chunks: 256 CTAs
    (4, 32, 1, 132, 256, 1),    # one sequence of 1 chunk: the most CTAs
    (16, 32, 1, 132, 256, 2),   # 16 x 16 = 256 >= 132 at 2, 128 at 4
    (64, 6, 3, 132, 256, 2),    # two heads a group: 64 x 3 CTAs
    (32, 6, 2, 132, 256, 1),    # three heads a group
    (32, 4, 4, 132, 256, 1),    # g == h
    (32, 32, 1, 132, 5000, 2),  # a long chunk: dA_cum of 4 heads too big
])
def test_ssd_heads_per_block(blocks, h, g, sms, l, want):
    hb = heads_per_block(blocks, h, g, sms, l)
    assert hb == want and (h // g) % hb == 0
    assert ssd_ops.smem_bytes(hb, l) <= ssd_ops.MAX_SMEM


def test_ssd_smem_at_the_path_shape():
    """csrc/ssd_chunk.cu's launcher at l 256, 4 heads: 3 stages of 5 slices
    of 32 x 72 floats, G 64 x 68, dA_cum 4 x 256."""
    assert ssd_ops.smem_bytes(4, 256) == 4 * (3 * 5 * 32 * 72 + 64 * 68
                                              + 4 * 256)
    with pytest.raises(ValueError, match="does not fit"):
        heads_per_block(32, 32, 1, 132, 40_000)


# ------------------------------------------------------------- local_attn
@pytest.mark.parametrize("D,dtype", [(80, "float32"), (80, "bfloat16"),
                                     (192, "float32"), (192, "bfloat16")])
def test_local_attn_plain_at_padded_head_dims_matches_jax(D, dtype, rng):
    """hubert-xlarge's head dim 80 and MLA's qk 192: the port's wrapper
    (plain route here) against JAX's ``flash_tiled`` in interpret mode."""
    S, H, KV = 64, 4, 2
    arrs = [rng.standard_normal((1, n, S, D)).astype(np.float32)
            for n in (H, KV, KV)]
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    q, k, v = (torch.tensor(np.asarray(a.astype(jnp.float32)))
               .to(getattr(torch, dtype)) for a in (jq, jk, jv))
    scale = D ** -0.5
    ref = np.asarray(jax_flash_tiled(jq, jk, jv, causal=True, window=24,
                                     scale=scale, t_real=S, blk_q=32,
                                     blk_k=32, interpret=True), np.float32)
    out = local_flash_attention(q, k, v, causal=True, window=24, scale=scale)
    assert out.shape == q.shape and out.dtype == q.dtype
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol)


@pytest.mark.parametrize("D,want", [(80, 128), (192, 256), (48, 64),
                                    (20, 32), (8, 16), (256, 256)])
def test_local_attn_padding_keeps_the_scores(D, want, rng):
    """Zero columns add nothing to q·k, and the caller's scale (here
    D ** -0.5, not the padded D's) is passed on: the padded plain output,
    sliced back to D, is the unpadded one."""
    assert attn_ops.padded_head_dim(D) == want
    q, k, v = (t32(rng.standard_normal((2, n, 40, D))) for n in (4, 2, 2))
    qp, kp, vp = attn_ops.pad_head_dim(q, k, v)
    assert qp.shape[-1] == want and torch.equal(qp[..., :D], q)
    assert not qp[..., D:].any() and not vp[..., D:].any()
    kw = dict(causal=True, window=16, scale=D ** -0.5)
    got = local_attention_ref(qp, kp, vp, **kw)[..., :D]
    torch.testing.assert_close(got, local_attention_ref(q, k, v, **kw),
                               rtol=0, atol=1e-6)


def test_local_attn_route_follows_the_padded_head_dim():
    bf16, f32 = torch.bfloat16, torch.float32
    assert [attn_ops.route(bf16, d) for d in (16, 32, 48, 80, 128, 192,
                                              256)] == \
        ["tf32", "tf32", "tc", "tc", "tc", "tc", "tc"]
    assert {attn_ops.route(f32, d) for d in (48, 80, 192, 256)} == \
        {"tf32"}
    with pytest.raises(ValueError, match="head_dim 320"):
        attn_ops.padded_head_dim(320)


# ------------------------------------------------------------------ LSTM
@pytest.mark.parametrize("hidden,in_dim,route", [
    (6, 10, "step"), (6, 9, "step"), (132, 10, "step"), (384, 10, "step"),
    (384, 9, "step"), (16, 10, "seq"), (16, 9, "seq"), (128, 10, "seq"),
    (128, 9, "seq")])
def test_lstm_scan_route_by_shape(hidden, in_dim, route):
    """``seq_fits`` is the route: a cluster size (the sequence kernels'
    launch shape, as ``seq_cluster`` gives it) or None (the step route)."""
    fits = lstm_ops.seq_fits(hidden, in_dim)
    assert (fits is None) == (route == "step")
    if fits is not None:
        assert fits == lstm_ops.seq_cluster(hidden, in_dim)
    else:
        with pytest.raises(ValueError, match="no cluster shape"):
            lstm_ops.seq_cluster(hidden, in_dim)


@pytest.fixture(scope="module")
def hidden6():
    """JAX's forecaster at hidden 6, its weights carried across, a batch."""
    jfc = JaxForecaster(JaxConfig(hidden_size=6))
    jparams = jfc.init(jax.random.key(11))
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=6))
    cfg = fc.cfg
    rng = np.random.default_rng(6)
    batch = {"history": rng.uniform(0, 1, (3, cfg.history_steps,
                                           cfg.history_channels)),
             "forecast": rng.uniform(0, 1, (3, cfg.horizon_steps,
                                            cfg.forecast_channels)),
             "target": rng.uniform(0, 0.5, (3, cfg.horizon_steps))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    return jfc, jparams, fc, batch


def test_forecaster_at_hidden_6_matches_jax(hidden6):
    jfc, jparams, fc, batch = hidden6
    want = np.asarray(jfc.forward(jparams, jnp.asarray(batch["history"]),
                                  jnp.asarray(batch["forecast"])))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    reset_launch_counts()
    got = fc.forward(params, torch.from_numpy(batch["history"]),
                     torch.from_numpy(batch["forecast"]))
    assert launch_counts()["lstm_cell"] == 0          # CPU: plain versions
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_forecaster_gradient_at_hidden_6_matches_jax(hidden6):
    jfc, jparams, fc, batch = hidden6
    jg = jax.grad(lambda p: jax_solar_loss(
        jfc, p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jparams)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss, _ = solar_loss(fc, params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    for got, want in zip(grads, jax.tree.leaves(jg), strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_step_route_scan_equals_the_chained_cell(rng):
    """The step route is the cell applied step by step: ys and (hT, cT)."""
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

    b, t, i, h = 2, 7, 9, 6
    xs = t32(rng.standard_normal((b, t, i)))
    p = {"wx": t32(rng.standard_normal((i, 4 * h)) * .1),
         "wh": t32(rng.standard_normal((h, 4 * h)) * .1),
         "b": t32(rng.standard_normal(4 * h) * .1)}
    h0, c0 = (t32(rng.standard_normal((b, h)) * .5) for _ in range(2))
    ys, (hT, cT) = lstm_scan(p, xs, h0, c0)
    hh, cc = h0, c0
    for s in range(t):
        hh, cc = lstm_cell_ref(xs[:, s], hh, cc, p["wx"], p["wh"], p["b"])
        assert torch.equal(ys[:, s], hh)
    assert torch.equal(hT, hh) and torch.equal(cT, cc)
    empty, (h_e, c_e) = lstm_scan(p, xs[:, :0], h0, c0)
    assert empty.shape == (b, 0, h) and torch.equal(h_e, h0)
