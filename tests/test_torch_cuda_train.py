"""The backward kernels of ``ssd_chunk`` and ``local_attn`` against their
plain versions (the explicit VJPs in ``kernels/*/ref.py``), on the card.

Every test here is marked ``cuda`` and skips where there is no GPU; the
file imports only torch, numpy and ``repro_torch``.  Each backward kernel
is held three ways: within a stated limit of its plain version in the
working dtype; at most BWD_F64_FACTOR times as far from the VJP evaluated
in f64 as the plain version is (max|route - f64| / max|f64| per output;
the f64 answer tells a fault from rounding, as the forward checks do);
and bit for bit on a second run (ordered sums, no atomics).  The limits
against the plain version: f32 within 1e-4 x max(1, max|plain|) (the
plain version sums through cuBLAS in another order, and d(dA) is a
reverse cumsum of sums that cancel), bf16 within 2e-2 x max(1,
max|plain|) (bf16 outputs).  The models' gradients on the card equal the
CPU's within 1e-4 x max(1, max|g_cpu|) per leaf, with one backward launch
a layer.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.data.lm_synth import lm_batch
from repro_torch.kernels import reset_launch_counts
from repro_torch.kernels.local_attn import ops as attn_ops
from repro_torch.kernels.local_attn.ops import local_flash_attention
from repro_torch.kernels.local_attn.ref import local_attention_bwd_ref
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_bwd_ref
from repro_torch.models.blocks import ATTN_KINDS, stack_layout
from repro_torch.models.model import build_model
from repro_torch.training.losses import loss_for_batch
from repro_torch.utils.tree import tree_leaves, tree_map

pytestmark = pytest.mark.cuda
BWD_F64_FACTOR = 2.0
F32_RTOL, BF16_RTOL = 1e-4, 2e-2
GRAD_RTOL = 1e-4


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels run only there")
    return torch.device("cuda", 0)


def f64_distance(got, exact):
    return ((got.double() - exact).abs().max() / exact.abs().max()).item()


def hold(name, got, plain, exact, rtol):
    for what, g, p, e in zip(name, got, plain, exact, strict=True):
        assert g.shape == p.shape and g.dtype == p.dtype, what
        err = (g.float() - p.float()).abs().max().item()
        lim = rtol * max(1.0, p.float().abs().max().item())
        assert err <= lim, (what, err, lim)
        dk, dp = f64_distance(g, e), f64_distance(p, e)
        assert dk <= BWD_F64_FACTOR * dp, (what, dk, dp)


def ssd_case(gen, b, c, l, h, p, g, n):
    """Inputs as the mixer makes them, and random output gradients."""
    dev = gen.device

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(r(b, c, l, h))
    A = -torch.exp(0.5 * r(h))
    return (r(b, c, l, h, p) * dt[..., None], dt * A, r(b, c, l, g, n),
            r(b, c, l, g, n), r(b, c, l, h, p), r(b, c, h, n, p))


@pytest.mark.parametrize("b,c,l,h,p,g,n", [
    (1, 2, 8, 4, 16, 2, 16),         # short chunks, two groups
    (2, 3, 40, 4, 24, 1, 20),        # l not a multiple of the 32-row tile
    (2, 4, 16, 8, 80, 2, 160),       # SSD_SHAPES of chip_smoke.py
    (1, 2, 256, 8, 80, 2, 160),
    (2, 8, 256, 32, 64, 1, 128),     # mamba2-370m, 2 x 2048 tokens
])
def test_ssd_backward_matches_plain_and_f64(b, c, l, h, p, g, n, cuda):
    args = ssd_case(torch.Generator(device=cuda).manual_seed(l + h), b, c, l,
                    h, p, g, n)
    before = ssd_ops.launches_bwd
    got = ssd_ops.ssd_intra_chunk_bwd(*args)
    assert ssd_ops.launches_bwd == before + 1
    again = ssd_ops.ssd_intra_chunk_bwd(*args)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again, strict=True))
    plain = ssd_intra_chunk_bwd_ref(*args)
    exact = ssd_intra_chunk_bwd_ref(*(a.double() for a in args))
    hold(("dxdt", "d(dA)", "dB", "dC"), got, plain, exact, F32_RTOL)


def attn_case(gen, B, H, KV, S, D, dtype):
    dev = gen.device
    q = torch.randn(B, H, S, D, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(B, KV, S, D, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    dout = torch.randn(B, H, S, D, generator=gen, device=dev).to(dtype)
    return q, k, v, dout


def attn_grads(q, k, v, dout, **kw):
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    out = local_flash_attention(*live, **kw)
    return out, torch.autograd.grad(out, live, dout)


@pytest.mark.parametrize("B,H,KV,S,D,causal,window,dtype", [
    (2, 8, 1, 256, 256, True, 0, torch.bfloat16),   # gemma-2b, cut in S
    (2, 8, 1, 256, 256, True, 0, torch.float32),
    (1, 4, 2, 200, 128, True, 0, torch.bfloat16),   # S off the tiles, GQA
    (1, 4, 4, 130, 64, False, 0, torch.float32),    # bidirectional
    (1, 4, 1, 192, 64, True, 48, torch.float32),    # a window
    (1, 2, 2, 100, 32, True, 0, torch.bfloat16),    # the CUDA-core bf16 route
    (1, 2, 1, 96, 80, False, 0, torch.float32),     # D padded to 128
    (1, 2, 1, 96, 192, True, 0, torch.bfloat16),    # D padded to 256
    (1, 8, 1, 2000, 256, True, 0, torch.float32),   # S off every tile
    (1, 8, 2, 200, 128, True, 0, torch.float32),    # GQA 4:1 at D 128
    (1, 8, 2, 96, 32, True, 0, torch.float32),      # GQA 4:1 at D 32
    (1, 4, 1, 70, 16, False, 0, torch.float32),     # D 16, bidirectional
    (1, 2, 1, 70, 16, True, 20, torch.bfloat16),    # bf16 at D 16, a window
])
def test_local_attn_backward_matches_plain_and_f64(B, H, KV, S, D, causal,
                                                   window, dtype, cuda):
    q, k, v, dout = attn_case(torch.Generator(device=cuda).manual_seed(S + D),
                              B, H, KV, S, D, dtype)
    kw = dict(causal=causal, window=window, scale=D ** -0.5)
    before = (attn_ops.launches_bwd, attn_ops.launches_bwd_tc,
              attn_ops.launches_bwd_tf32)
    out, got = attn_grads(q, k, v, dout, **kw)
    tc = attn_ops.route(dtype, D) == "tc"     # else the split-tf32 kernels
    assert (attn_ops.launches_bwd, attn_ops.launches_bwd_tc,
            attn_ops.launches_bwd_tf32) == (before[0] + 1, before[1] + tc,
                                            before[2] + (not tc))
    _, again = attn_grads(q, k, v, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True))
    with torch.no_grad():            # scoring: the same bits, no statistics
        assert torch.equal(local_flash_attention(q, k, v, **kw), out)
    plain = local_attention_bwd_ref(q, k, v, dout, **kw)
    exact = local_attention_bwd_ref(q.double(), k.double(), v.double(),
                                    dout.double(), **kw)
    hold(("dq", "dk", "dv"), got, plain, exact,
         F32_RTOL if dtype == torch.float32 else BF16_RTOL)


@pytest.mark.parametrize("B,H,KV,S,D,causal,window", [
    (1, 8, 1, 2000, 256, True, 0),    # gemma-2b's heads, S off every tile
    (1, 8, 2, 256, 128, True, 0),     # GQA with two kv heads
    (1, 4, 1, 320, 64, True, 100),    # a window that cuts the tiles
    (2, 4, 4, 200, 128, False, 0),    # bidirectional
])
def test_local_attn_backward_tensor_core_route(B, H, KV, S, D, causal,
                                               window, cuda):
    """The bf16 tensor-core route at its edges: rows past S and T filled
    by TMA, kv heads folded in order, tiles cut by a window, no mask."""
    q, k, v, dout = attn_case(torch.Generator(device=cuda).manual_seed(S + D),
                              B, H, KV, S, D, torch.bfloat16)
    kw = dict(causal=causal, window=window, scale=D ** -0.5)
    before = (attn_ops.launches_bwd, attn_ops.launches_bwd_tc)
    _, got = attn_grads(q, k, v, dout, **kw)
    assert (attn_ops.launches_bwd, attn_ops.launches_bwd_tc) == (
        before[0] + 1, before[1] + 1)
    _, again = attn_grads(q, k, v, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True))
    plain = local_attention_bwd_ref(q, k, v, dout, **kw)
    exact = local_attention_bwd_ref(q.double(), k.double(), v.double(),
                                    dout.double(), **kw)
    hold(("dq", "dk", "dv"), got, plain, exact, BF16_RTOL)


@pytest.mark.parametrize("b,c,l,h,p,g,n", [
    (1, 2, 64, 6, 32, 1, 48),         # 6 heads a group: 4 do not divide them
    (2, 1, 100, 5, 16, 1, 24),        # 5: one a CTA
])
def test_ssd_backward_head_blocks_that_do_not_divide(b, c, l, h, p, g, n,
                                                     cuda):
    hb = ssd_ops.bwd_heads_per_block(b * c, h, g, 132, l, p, n)
    assert (h // g) % hb == 0 and hb < 4
    args = ssd_case(torch.Generator(device=cuda).manual_seed(l + h), b, c, l,
                    h, p, g, n)
    got = ssd_ops.ssd_intra_chunk_bwd(*args)
    again = ssd_ops.ssd_intra_chunk_bwd(*args)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again, strict=True))
    plain = ssd_intra_chunk_bwd_ref(*args)
    exact = ssd_intra_chunk_bwd_ref(*(a.double() for a in args))
    hold(("dxdt", "d(dA)", "dB", "dC"), got, plain, exact, F32_RTOL)


@pytest.mark.parametrize("arch", ["mamba2-370m", "gemma-2b"])
def test_llm_gradients_on_card_match_cpu(arch, cuda):
    cfg = reduced_for_smoke(get_config(arch))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = lm_batch(np.random.default_rng(0), 2, 100, cfg.vocab_size)

    def grads(tree):
        live = tree_map(lambda x: x.detach().requires_grad_(), tree)
        loss, _ = loss_for_batch(model, cfg, live, batch)
        return torch.autograd.grad(loss, tree_leaves(live))

    want = grads(params)
    reset_launch_counts()
    got = grads(tree_map(lambda x: x.to(cuda), params))
    torch.cuda.synchronize()
    ops = ssd_ops if arch == "mamba2-370m" else attn_ops
    assert ops.launches_bwd == cfg.n_layers
    assert ops.launches == 2 * cfg.n_layers
    for g, w in zip(got, want, strict=True):
        err = (g.cpu() - w).abs().max().item()
        assert err <= GRAD_RTOL * max(1.0, w.abs().max().item()), err


@pytest.mark.parametrize("D,dtype", [(128, torch.bfloat16),
                                     (256, torch.bfloat16),
                                     (64, torch.float32)])
def test_attention_recomputed_in_the_backward(D, dtype, cuda):
    """``torch.utils.checkpoint`` runs the forward kernel again on
    autograd's backward thread (the tensor-core route encodes its tensor
    maps there, the split-tf32 route sets its shared memory there): the
    gradients equal the unrematerialised ones bit for bit, with two
    forward launches and one backward."""
    from torch.utils.checkpoint import checkpoint

    q, k, v, dout = attn_case(torch.Generator(device=cuda).manual_seed(D),
                              1, 4, 1, 300, D, dtype)
    kw = dict(causal=True, window=0, scale=D ** -0.5)
    _, want = attn_grads(q, k, v, dout, **kw)
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (attn_ops.launches, attn_ops.launches_bwd)
    out = checkpoint(lambda *t: local_flash_attention(*t, **kw), *live,
                     use_reentrant=False)
    got = torch.autograd.grad(out, live, dout)
    torch.cuda.synchronize()
    assert (attn_ops.launches - before[0],
            attn_ops.launches_bwd - before[1]) == (3, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


@pytest.mark.parametrize("arch,dtype", [("gemma-2b", "bfloat16"),
                                        ("recurrentgemma-9b", "bfloat16"),
                                        ("mamba2-370m", "float32")])
def test_llm_remat_on_card_equals_none(arch, dtype, cuda):
    """A reduced model's loss gradient on the card under remat "full" and
    "dots_saveable" equals the one under "none" bit for bit, with each
    scanned block's forward kernel launched twice."""
    cfg = reduced_for_smoke(get_config(arch)).replace(dtype=dtype)
    if cfg.family == "hybrid":
        cfg = cfg.replace(n_layers=5)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), cuda)
    batch = lm_batch(np.random.default_rng(0), 2, 100, cfg.vocab_size)
    ops = ssd_ops if arch == "mamba2-370m" else attn_ops
    got = {}
    for remat in ("none", "full", "dots_saveable"):
        c = cfg.replace(remat=remat)
        live = tree_map(lambda x: x.detach().requires_grad_(), params)
        reset_launch_counts()
        loss, _ = loss_for_batch(build_model(c), c, live, batch)
        got[remat] = (loss.detach(), torch.autograd.grad(loss,
                                                         tree_leaves(live)))
        torch.cuda.synchronize()
        blocks = sum(repeat * sum(k in ATTN_KINDS + ("ssm",) for k in kinds)
                     for _mode, kinds, repeat in stack_layout(cfg))
        again = 0 if remat == "none" else sum(
            repeat * sum(k in ATTN_KINDS + ("ssm",) for k in kinds)
            for mode, kinds, repeat in stack_layout(cfg) if mode == "scan")
        assert (ops.launches, ops.launches_bwd) == (2 * blocks + again,
                                                    blocks), remat
    for remat in ("full", "dots_saveable"):
        assert torch.equal(got[remat][0], got["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(
            got[remat][1], got["none"][1], strict=True)), remat
