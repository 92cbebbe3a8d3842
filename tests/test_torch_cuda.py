"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU; the
file imports only torch, numpy and ``repro_torch`` so that it runs on a
machine without JAX.  Shapes are the solar main path's: T = 141,953
parameters at hidden 128, H = 128 with I = 9 or 10.  Tolerances: fold
atol 1e-6 (N-way f32 sums in the same order), step atol 1e-5, anchor
gradient rtol/atol 1e-5 and loss rtol 1e-4, DP release atol 1e-5 (the
reference tests' own).

The LLM kernels: ``local_attn`` and ``ssd_chunk`` on the reference sweep
shapes (``tests/test_kernels.py``) at the reference tolerances, atol 2e-5
in f32 and 2e-2 in bf16; at the full path shapes (gemma-2b: H 8, KV 1,
D 256, S 2048; RecurrentGemma's window 2048 at S 4096; mamba2-370m: l 256,
h 32, p 64, n 128 over 2048 tokens) the f32 bound is relative,
max|kernel - plain| <= 2e-5 * max(1, max|plain|), since there sums run
over up to 2048 keys or 256 x 128 products in another order; bf16 stays
at 2e-2.  bf16 at D 64, 128 and 256 takes the tensor-core route
(``local_attn_tc.cu``; ``ops.launches_tc`` counts it): besides 2e-2
against the plain version, its output may sit at most twice as far from
the same function evaluated in f64 (the plain version on f64 copies of
the bf16 inputs) as the plain version's bf16 output does, and it reads
transposed views in place.  f32, and bf16 at D 16 and 32, take the
split-tf32 route (``local_attn_tf32.cu``; ``ops.launches_tf32``): within
2e-5 x max(1, max|plain|) in f32 (2e-2 in bf16) at D 16-256, ragged S and
T, windows with and without the causal mask, at most twice as far from
the f64 answer as the plain version, its row log-sum-exp within 2e-5 x
max(1, max|lse|) of the plain scores', the same bits twice, and strided
views read in place.  The SSD at mamba2-370m's shapes is also
held against the same function evaluated in f64: there dA_cum reaches ~200 in magnitude, where
an f32 ulp is 1.5e-5, so the order of the in-chunk scan shows.  The
kernel may sit at most twice as far from the f64 answer as its plain
version, and the whole chunked scan within 2e-5 * max|f64| of the f64
scan (the plain oracle ``ssd_chunked`` takes its cumsum in another
order).  The reduced models' forward on the card matches the CPU
forward at atol 5e-5.  The MoE, MLA with MTP, hybrid, audio and VLM
families (reduced; recurrentgemma at 5 layers): in f32 the loss within
1e-5 and every gradient leaf within 1e-4 x max(1, max|g_cpu|) of the
CPU's, one forward and one backward ``local_attn`` launch an attention
block; in bf16 every launch on the tensor-core route and the cross entropy
within 2 of ln V; decode by replay within 2e-4 of the kernel forward (the
rolling cache wrapping at window 8) and ragged decoding equal to
independent decoding.

Distribution: reduced gemma-2b's forward on ``make_host_mesh()``'s (1, 1)
mesh (an nccl world of one) equals the plain forward bit for bit, and
``ClusterParallel`` (two reduced gemma-2b clusters, one SGD step) on the
card equals the CPU within 1e-4 (loss) and 1e-4 x max(1, max|p_cpu|)
(parameters, the global tier).

The whole-sequence LSTM kernels (``csrc/lstm_seq.cu``): the forward equals
the chained step kernel bit for bit, and forward and backward sit within
2e-5 * max(1, max|plain|) of their plain versions (138-term sums in another
order than cuBLAS's, carried through up to 672 recurrent steps); the
reverse scan gives the same bits on every run (fixed-order sums, no
atomics); ``LSTMSeqFn``'s gradients sit within 2e-5 * max|f64| of the
gradient evaluated in f64, and at T 40 match autograd of the plain loop at
rtol 1e-4 / atol 1e-5.  The fold by leaves equals the stacked fold bit for
bit (the same FMAs in the same order), one launch for up to 64 trees.

The shapes the kernels once refused: the forecaster at hidden 6, 132 and
384 takes the chained step kernel (forecast atol 1e-5, gradient rtol 1e-4 /
atol 1e-5 against the CPU route); ``local_attn`` at head dims 48, 80 and
192 runs zero-padded to the next instantiation (f32 atol 2e-5; bf16 on the
tensor cores, held like the route above) and raises above 256; the SSD
kernel takes any n and p with B and C per group, held to 2e-5 * max(1,
max|plain|) and to twice the plain version's distance from f64, and gives
the bits of its own head-broadcast call.  ``ewc_update`` is one launch
whose loss is summed in a fixed order: two runs give the same bits, on
float4 rows and on views off 16-byte alignment, with a workspace per
stream.  ``dp_clip_noise`` is one device kernel a call on both routes (a
thread-block cluster up to 196,608 values, a cooperative grid above) and
gives the same bits twice, on views off alignment too.  The threaded
runtime's secure run on the card matches the CPU's: the same clusters,
stats and budgets, Table II within 0.1 pp.

The process server tier: a shard worker on the card folds a drain batch
with one fold launch, equal to a CPU worker's fold within 1e-6; spawned
CUDA workers and a subprocess shard server (``--device cuda``) announce
ready within their cold-start allowance and fold as the in-process
emulation on the CPU, within 1e-6.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.solar_lstm import SolarLSTMConfig
from repro_torch.core.aggregation import _pad_pow2
from repro_torch.kernels.dp_clip_noise import ops as dp_ops
from repro_torch.kernels.dp_clip_noise.ops import privatize_flat
from repro_torch.kernels.dp_clip_noise.ref import dp_clip_noise_ref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ewc_update import ops as ewc_ops
from repro_torch.kernels.ewc_update.ops import ewc_penalty_grad_flat
from repro_torch.kernels.ewc_update.ref import ewc_ref
from repro_torch.kernels.fedavg_agg.ops import aggregate_flat
from repro_torch.kernels.fedavg_agg.ref import agg_ref
from repro_torch.kernels.fedavg_agg import ops as agg_ops
from repro_torch.kernels.fedavg_agg.ops import aggregate_pytrees
from repro_torch.kernels.fedavg_agg.ref import agg_leaves_ref
from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.kernels.lstm_cell.ops import (
    LSTMCellFn,
    LSTMSeqFn,
    lstm_seq_bwd,
    lstm_seq_fwd,
    lstm_step,
)
from repro_torch.kernels.lstm_cell.ref import lstm_seq_bwd_ref, lstm_seq_ref
from repro_torch.kernels.local_attn import ops as attn_ops
from repro_torch.kernels.local_attn.ops import local_flash_attention
from repro_torch.kernels.local_attn.ref import local_attention_ref
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
from repro_torch.kernels.ssd_chunk.ops import ssd_chunked_fused, ssd_intra_chunk
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.data.lm_synth import audio_batch, lm_batch, vlm_batch
from repro_torch.models.blocks import attention_blocks
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ServeEngine
from repro_torch.models.ssm import ssd_chunked
from repro_torch.models.lstm import SolarForecaster
from repro_torch.privacy.dp import DPConfig, DPPrivatizer
from repro_torch.training.losses import loss_for_batch, solar_loss
from repro_torch.training.fed_solar import run_fedccl_solar
from repro_torch.utils.tree import (
    flatten_params,
    params_to_numpy,
    tree_leaves,
    tree_map,
)

pytestmark = pytest.mark.cuda
T = 141_953
SSD_F64_FACTOR = 2.0    # kernel's distance to f64 over the plain version's
ATTN_F64_FACTOR = 2.0   # the same for the tensor-core route of local_attn
SEQ_GRAD_F64_RTOL = 2e-5   # sequence LSTM gradients vs f64, x max|f64|


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels run only there")
    return torch.device("cuda", 0)


def randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device=gen.device) * scale


def lstm_args(gen, b, i, h=128):
    return (randn(gen, b, i), randn(gen, b, h), randn(gen, b, h),
            randn(gen, i, 4 * h, scale=0.1), randn(gen, h, 4 * h, scale=0.1),
            randn(gen, 4 * h, scale=0.1))


@pytest.mark.parametrize("n", [2, 3, 32])
def test_fedavg_kernel_matches_plain(n, cuda):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = randn(gen, n, T)
    ws = torch.rand(n, generator=gen, device=cuda)
    ws = (ws / ws.sum()).tolist()
    before = launch_counts()["fedavg_agg"]
    out = aggregate_flat(x, ws)
    assert launch_counts()["fedavg_agg"] == before + 1
    torch.testing.assert_close(out, agg_ref(x, ws), rtol=0, atol=1e-6)
    sets, pws = _pad_pow2(list(x), ws)           # zero-weight padding is exact
    assert torch.equal(aggregate_flat(torch.stack(sets), pws), out)


@pytest.mark.parametrize("n", [70, 128])
def test_fedavg_kernel_folds_more_than_64_sets(n, cuda):
    """A secure round of more than 62 submitters folds 64 < N sets: one
    launch for the first 64, then one per 63 more."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = randn(gen, n, T)
    ws = torch.rand(n, generator=gen, device=cuda)
    ws = (ws / ws.sum()).tolist()
    before = launch_counts()["fedavg_agg"]
    out = aggregate_flat(x, ws)
    assert launch_counts()["fedavg_agg"] == before + 1 + -(-(n - 64) // 63)
    torch.testing.assert_close(out, agg_ref(x, ws), rtol=0, atol=1e-6)
    sets, pws = _pad_pow2(list(x), ws)
    assert torch.equal(aggregate_flat(torch.stack(sets), pws), out)


@pytest.mark.parametrize("t", [T, T - 1])          # odd; T % 4 == 0
@pytest.mark.parametrize("n", [1, 2, 64, 65, 130])
def test_fedavg_stacked_fold_is_the_leaves_fold_bit_for_bit(n, t, cuda):
    """The stacked fold's one launch up to 64 sets (chunks past them), its
    scalar loop at odd T and its 16-byte route at T % 4 == 0: the same FMAs
    in set order as the fold by leaves, so the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(n + t)
    x = randn(gen, n, t)
    ws = torch.rand(n, generator=gen, device=cuda)
    ws = (ws / ws.sum()).tolist()
    before = agg_ops.launches_stacked
    out = aggregate_flat(x, ws)
    assert agg_ops.launches_stacked == before + 1 + max(
        0, -(-(n - 64) // 63))
    assert torch.equal(out, agg_ops.aggregate_leaves([[r] for r in x], ws))
    torch.testing.assert_close(out, agg_ref(x, ws), rtol=0, atol=1e-6)


@pytest.mark.parametrize("m", [0.0, 1.1])
@pytest.mark.parametrize("case", ["binding", "inside", "zero", "nan"])
@pytest.mark.parametrize("t", [1, 5, 8192, T, (1 << 20) + 3])
def test_dp_clip_noise_kernel_matches_plain(t, case, m, cuda):
    gen = torch.Generator(device=cuda).manual_seed(t)
    d = randn(gen, t)
    d = torch.zeros_like(d) if case == "zero" else \
        d * ((3.0 if case == "binding" else 0.25) / d.norm())
    if case == "nan":        # one NaN makes every output NaN, as in JAX
        d[t // 2] = float("nan")
    noise = randn(gen, t)
    before = launch_counts()["dp_clip_noise"]
    out = privatize_flat(d, noise, 1.0, m)
    assert launch_counts()["dp_clip_noise"] == before + 1
    want = dp_clip_noise_ref(d, noise, 1.0, m)
    if case == "nan":
        assert out.isnan().all() and want.isnan().all()
    else:
        torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    if case == "zero":
        torch.testing.assert_close(out, noise * m, rtol=0, atol=0)
    assert privatize_flat(d[:0], noise[:0], 1.0, m).shape == (0,)


def test_privatizer_adds_the_same_noise_on_card_and_cpu(cuda):
    gen = torch.Generator().manual_seed(0)
    d = torch.randn(T, generator=gen) * 0.01
    cfg = DPConfig(clip=0.5, noise_multiplier=0.3)
    got = DPPrivatizer(cfg, "c0", seed=4).privatize_delta(d.to(cuda), "k")
    want = DPPrivatizer(cfg, "c0", seed=4).privatize_delta(d, "k")
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("t,offset", [
    (1, 0), (5, 1), (T, 0), (T, 1), (196_608, 3), (196_609, 0),
    ((1 << 20) + 3, 0), ((1 << 20) + 3, 1)])
def test_dp_clip_noise_kernel_gives_the_same_bits_twice(t, offset, cuda):
    """One launch a call on either route (a cluster up to 196,608 values,
    a cooperative grid above), with a summation order fixed by T: two runs
    give the same bits, also on views 4 and 12 bytes past 16-byte
    alignment (the noise one float off the delta's alignment)."""
    gen = torch.Generator(device=cuda).manual_seed(t + offset)
    d = randn(gen, t + offset)[offset:]
    noise = randn(gen, t + offset + 1)[offset + 1:]
    before = launch_counts()["dp_clip_noise"]
    first = privatize_flat(d, noise, 1.0, 0.7)        # the clip binds
    again = privatize_flat(d, noise, 1.0, 0.7)
    assert launch_counts()["dp_clip_noise"] == before + 2
    assert torch.equal(first, again)
    torch.testing.assert_close(first, dp_clip_noise_ref(d, noise, 1.0, 0.7),
                               rtol=0, atol=1e-5)
    assert dp_ops.route(t) == ("cluster" if t <= 196_608 else "wide")


@pytest.mark.parametrize("t", [T, (1 << 20) + 3])
def test_dp_clip_noise_is_one_device_kernel_a_call(t, cuda):
    from torch.autograd import DeviceType

    gen = torch.Generator(device=cuda).manual_seed(3)
    d, noise = randn(gen, t), randn(gen, t)
    # the first window of a process's first profiler session may miss its
    # first kernel while the tracer starts: count in a second window
    for _ in range(2):
        privatize_flat(d, noise, 5.0, 0.3)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                privatize_flat(d, noise, 5.0, 0.3)
            torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    own = [e for e in events if e.name.startswith("dp_clip_noise_")]
    assert len(own) == 20 and len(events) == 20, [e.name for e in events]


def test_threaded_secure_run_on_card_matches_cpu(cuda):
    """The threaded runtime with secure aggregation and DP clipping (noise
    0) at hidden 16, on the card and on the CPU from one init: the same
    clusters, stats and budgets, Table II within 0.1 pp."""
    cfg = dict(hidden=16, n_sites=4, n_days=14, rounds=1, epochs=2,
               n_independent=1, seed=0, dp_clip=5.0, dp_noise_multiplier=0.0,
               secure_agg=True)
    init = params_to_numpy(SolarForecaster(SolarLSTMConfig(hidden_size=16))
                           .init(torch.Generator().manual_seed(1), "cpu"))
    gpu = run_fedccl_solar(device=cuda, init_params=init, runtime="threaded",
                           **cfg)
    cpu = run_fedccl_solar(device="cpu", init_params=init,
                           runtime="threaded", **cfg)
    assert gpu["clusters"] == cpu["clusters"]
    assert gpu["async_stats"] == cpu["async_stats"]
    assert gpu["async_stats"]["secure_rounds"] > 0
    assert gpu["privacy"]["per_client"] == cpu["privacy"]["per_client"]
    for tab in ("table2", "independent"):
        for col, row in cpu[tab].items():
            for k, v in row.items():
                w = gpu[tab][col][k]
                assert math.isnan(v) == math.isnan(w), (tab, col, k)
                if not math.isnan(v):
                    assert abs(v - w) <= 0.1, (tab, col, k, v, w)


@pytest.mark.parametrize("B,I", [(1, 9), (7, 10), (8, 10), (26, 9)])
def test_lstm_kernel_matches_plain(B, I, cuda):
    gen = torch.Generator(device=cuda).manual_seed(B * 100 + I)
    args = lstm_args(gen, B, I)
    hk, ck = lstm_step(*args)
    hr, cr = lstm_cell_ref(*args)
    torch.testing.assert_close(hk, hr, rtol=0, atol=1e-5)
    torch.testing.assert_close(ck, cr, rtol=0, atol=1e-5)


def test_lstm_fn_gradients_match_autograd_of_plain_cell(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = [a.requires_grad_() for a in lstm_args(gen, 8, 10)]
    wts = randn(gen, 8, 128), randn(gen, 8, 128)
    hk, ck = LSTMCellFn.apply(*args)
    gk = torch.autograd.grad((hk * wts[0]).sum() + (ck * wts[1]).sum(), args)
    hr, cr = lstm_cell_ref(*args)
    gr = torch.autograd.grad((hr * wts[0]).sum() + (cr * wts[1]).sum(), args)
    for a, b in zip(gk, gr, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_fisher", [False, True])
def test_ewc_kernel_matches_plain(with_fisher, cuda):
    gen = torch.Generator(device=cuda).manual_seed(int(with_fisher))
    g, p, a, f = (randn(gen, T) for _ in range(4))
    f = f.abs() if with_fisher else None
    go, loss = ewc_penalty_grad_flat(0.05, g, p, a, f)
    gr, lr = ewc_ref(0.05, g, p, a, f)
    torch.testing.assert_close(go, gr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(loss, lr, rtol=1e-4, atol=0)


@pytest.mark.parametrize("t,offset", [(T, 0), (T, 1), (5, 0), (1027, 3),
                                      ((1 << 20) + 3, 0)])
@pytest.mark.parametrize("with_fisher", [False, True])
def test_ewc_kernel_gives_the_same_bits_twice(t, offset, with_fisher, cuda):
    """One launch a call; the block that finishes last adds the partials in
    index order, so two runs agree bit for bit, on float4 rows (offset 0)
    and on views that break 16-byte alignment (the scalar route)."""
    gen = torch.Generator(device=cuda).manual_seed(t + offset)
    g, p, a, f = (randn(gen, t + offset)[offset:] for _ in range(4))
    f = f.abs() if with_fisher else None
    before = launch_counts()["ewc_update"]
    first = ewc_penalty_grad_flat(0.05, g, p, a, f)
    again = ewc_penalty_grad_flat(0.05, g, p, a, f)
    assert launch_counts()["ewc_update"] == before + 2
    for x, y in zip(first, again, strict=True):
        assert torch.equal(x, y)
    gr, lr = ewc_ref(0.05, g, p, a, f)
    torch.testing.assert_close(first[0], gr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(first[1], lr, rtol=1e-4, atol=0)


def test_ewc_kernel_keeps_one_workspace_per_stream(cuda):
    """Each stream gets its own partials and ticket; results agree."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    g, p, a = (randn(gen, T) for _ in range(3))
    want = ewc_penalty_grad_flat(0.1, g, p, a)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = ewc_penalty_grad_flat(0.1, g, p, a)
    torch.cuda.current_stream(cuda).wait_stream(side)
    assert (cuda.index, side.cuda_stream) in ewc_ops._workspaces
    for x, y in zip(got, want, strict=True):
        assert torch.equal(x, y)


def test_forecaster_on_card_matches_cpu(cuda):
    """The 672 + 96 steps as two sequence launches (encoder, decoder)
    against the plain loop, same weights and inputs."""
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=32))
    params = fc.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    hist = torch.rand(5, fc.cfg.history_steps, fc.cfg.history_channels,
                      generator=gen)
    fcst = torch.rand(5, fc.cfg.horizon_steps, fc.cfg.forecast_channels,
                      generator=gen)
    reset_launch_counts()
    got = fc.forward(tree_map(lambda x: x.to(cuda), params), hist.to(cuda),
                     fcst.to(cuda))
    assert launch_counts()["lstm_cell"] == 2
    assert lstm_ops.launches_seq_fwd == 2 and lstm_ops.launches_seq_bwd == 0
    torch.testing.assert_close(got.cpu(), fc.forward(params, hist, fcst),
                               rtol=0, atol=1e-5)


def test_forecaster_gradient_on_card_matches_cpu(cuda):
    """One solar_loss gradient: two sequence forwards and two reverse scans
    on the card against the plain versions on the CPU."""
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=32))
    params = fc.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(2)
    batch = {"history": torch.rand(5, fc.cfg.history_steps,
                                   fc.cfg.history_channels, generator=gen),
             "forecast": torch.rand(5, fc.cfg.horizon_steps,
                                    fc.cfg.forecast_channels, generator=gen),
             "target": torch.rand(5, fc.cfg.horizon_steps, generator=gen)}

    def grads(dev):
        live = tree_map(lambda x: x.to(dev).requires_grad_(), params)
        loss, _ = solar_loss(fc, live, {k: v.to(dev)
                                        for k, v in batch.items()})
        return torch.autograd.grad(loss, tree_leaves(live))
    reset_launch_counts()
    got = grads(cuda)
    assert lstm_ops.launches_seq_fwd == 2 and lstm_ops.launches_seq_bwd == 2
    assert launch_counts()["lstm_cell"] == 4
    for a, b in zip(got, grads("cpu"), strict=True):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hidden", [6, 132, 384])
def test_forecaster_step_route_on_card_matches_cpu(hidden, cuda):
    """Hidden sizes the sequence kernels have no launch shape for take the
    chained step kernel, forward and gradient, against the CPU route."""
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=hidden))
    params = fc.init(torch.Generator().manual_seed(hidden), "cpu")
    gen = torch.Generator().manual_seed(3)
    batch = {"history": torch.rand(3, fc.cfg.history_steps,
                                   fc.cfg.history_channels, generator=gen),
             "forecast": torch.rand(3, fc.cfg.horizon_steps,
                                    fc.cfg.forecast_channels, generator=gen),
             "target": torch.rand(3, fc.cfg.horizon_steps, generator=gen)}
    steps = fc.cfg.history_steps + fc.cfg.horizon_steps
    reset_launch_counts()
    got = fc.forward(tree_map(lambda x: x.to(cuda), params),
                     batch["history"].to(cuda), batch["forecast"].to(cuda))
    assert launch_counts()["lstm_cell"] == steps
    assert lstm_ops.launches_seq_fwd == 0 and lstm_ops.launches_seq_bwd == 0
    torch.testing.assert_close(got.cpu(), fc.forward(params, batch["history"],
                                                     batch["forecast"]),
                               rtol=0, atol=1e-5)

    def grads(dev):
        live = tree_map(lambda x: x.to(dev).requires_grad_(), params)
        loss, _ = solar_loss(fc, live, {k: v.to(dev)
                                        for k, v in batch.items()})
        return torch.autograd.grad(loss, tree_leaves(live))
    for a, b in zip(grads(cuda), grads("cpu"), strict=True):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


# ------------------------------------------------- the sequence kernels
def seq_args(gen, b, i, t, h=128):
    return (randn(gen, t, b, i), randn(gen, b, h, scale=0.5),
            randn(gen, b, h, scale=0.5), randn(gen, i, 4 * h, scale=0.1),
            randn(gen, h, 4 * h, scale=0.1), randn(gen, 4 * h, scale=0.1))


# the main path's shapes (B 8: encoder T 672 with I 10, decoder T 96 with
# I 9), other batches (two clusters at 26 and 33) and widths
SEQ_SHAPES = [(8, 10, 672, 128), (8, 9, 96, 128), (1, 10, 96, 128),
              (7, 9, 37, 128), (26, 10, 37, 128), (33, 9, 5, 128),
              (5, 10, 96, 32), (3, 9, 37, 16), (2, 9, 11, 4)]


@pytest.mark.parametrize("B,I,T,H", SEQ_SHAPES)
def test_lstm_seq_forward_matches_plain_and_the_step_kernel(B, I, T, H,
                                                            cuda):
    gen = torch.Generator(device=cuda).manual_seed(B * 1000 + T)
    xs, h0, c0, wx, wh, b = seq_args(gen, B, I, T, H)
    before = lstm_ops.launches_seq_fwd
    ys, cseq, gates, h, c = lstm_seq_fwd(xs, h0, c0, wx, wh, b)
    assert lstm_ops.launches_seq_fwd == before + 1
    want = lstm_seq_ref(xs, h0, c0, wx, wh, b)
    for what, got, ref in zip(("ys", "c seq", "gates", "hT", "cT"),
                              (ys, cseq, gates, h, c), want, strict=True):
        full_close(got, ref, f"lstm_seq forward {what}")
    hh, cc = h0, c0
    for t in range(T):                  # the chained step kernel
        hh, cc = lstm_step(xs[t], hh, cc, wx, wh, b)
        assert torch.equal(ys[t], hh), f"step {t} differs"
    assert torch.equal(h, hh) and torch.equal(c, cc)
    # without the saved tensors: the same outputs
    ys2, cs2, g2, h2, c2 = lstm_seq_fwd(xs, h0, c0, wx, wh, b, save=False)
    assert cs2 is None and g2 is None
    assert torch.equal(ys2, ys) and torch.equal(h2, h) and torch.equal(c2, c)


@pytest.mark.parametrize("with_dys", [True, False])
@pytest.mark.parametrize("B,I,T,H", SEQ_SHAPES)
def test_lstm_seq_backward_matches_plain(B, I, T, H, with_dys, cuda):
    gen = torch.Generator(device=cuda).manual_seed(B * 1000 + T + 7)
    xs, h0, c0, wx, wh, b = seq_args(gen, B, I, T, H)
    _, cseq, gates, _, _ = lstm_seq_fwd(xs, h0, c0, wx, wh, b)
    dys = randn(gen, T, B, H) if with_dys else None
    dh, dc = randn(gen, B, H), randn(gen, B, H)
    before = lstm_ops.launches_seq_bwd
    got = lstm_seq_bwd(dys, dh, dc, gates, cseq, c0, wh)
    assert lstm_ops.launches_seq_bwd == before + 1
    want = lstm_seq_bwd_ref(dys, dh, dc, gates, cseq, c0, wh)
    for what, g, r in zip(("da", "dh0", "dc0"), got, want, strict=True):
        full_close(g, r, f"lstm_seq backward {what}")
    again = lstm_seq_bwd(dys, dh, dc, gates, cseq, c0, wh)
    for g, r in zip(got, again, strict=True):     # fixed-order sums
        assert torch.equal(g, r)


@pytest.mark.parametrize("B,I,T", [(8, 10, 672), (3, 9, 40)])
def test_lstm_seq_fn_gradients_match_autograd_of_plain_loop(B, I, T, cuda):
    """Against autograd of the plain loop in f32 and in f64.  Every gradient
    of the kernels sits within SEQ_GRAD_F64_RTOL * max|f64| of the f64
    gradient (as the whole SSD scan is held).  At T 40 they also agree with
    the plain f32 gradients at rtol 1e-4 / atol 1e-5; at T 672 the weight
    gradients sum 5,376 products, whose f32 rounding in two orders differs
    by more than that atol, so the f64 answer is the referee."""
    gen = torch.Generator(device=cuda).manual_seed(T)
    args = [a.requires_grad_() for a in seq_args(gen, B, I, T)]
    wy, wh_, wc_ = (randn(gen, T, B, 128), randn(gen, B, 128),
                    randn(gen, B, 128))

    def loss(ys, h, c):
        return (ys * wy).sum() + (h * wh_).sum() + (c * wc_).sum()
    gk = torch.autograd.grad(loss(*LSTMSeqFn.apply(*args)), args)
    ys, _, _, h, c = lstm_seq_ref(*args)
    gr = torch.autograd.grad(loss(ys, h, c), args)
    args64 = [a.detach().double().requires_grad_() for a in args]
    ys, _, _, h, c = lstm_seq_ref(*args64)
    ge = torch.autograd.grad(loss(ys, h, c), args64)
    for a, b, e in zip(gk, gr, ge, strict=True):
        dk = (a.double() - e).abs().max().item()
        assert dk <= SEQ_GRAD_F64_RTOL * e.abs().max().item(), dk
        if T <= 40:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------ fold by leaves
def forecaster_trees(n, seed):
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=128))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [fc.init(gen, "cuda") for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3, 8, 64, 70, 128])
def test_fold_by_leaves_equals_the_stacked_fold(n, cuda):
    trees = forecaster_trees(n, n)
    gen = torch.Generator(device=cuda).manual_seed(n)
    ws = torch.rand(n, generator=gen, device=cuda)
    ws = (ws / ws.sum()).tolist()
    if n == 1:
        ws = [0.5]                      # not the identity shortcut
    reset_launch_counts()
    got = flatten_params(aggregate_pytrees(trees, ws))
    assert agg_ops.launches_leaves == 1 + max(0, -(-(n - 64) // 63))
    assert launch_counts()["fedavg_agg"] == agg_ops.launches_leaves
    stacked = torch.stack([flatten_params(t) for t in trees])
    assert torch.equal(got, aggregate_flat(stacked, ws))
    torch.testing.assert_close(
        got, agg_leaves_ref([tree_leaves(t) for t in trees], ws), rtol=0,
        atol=1e-6)


def test_fold_by_leaves_keeps_the_tree(cuda):
    trees = forecaster_trees(2, 0)
    out = aggregate_pytrees(trees, [0.25, 0.75])
    assert list(out) == list(trees[0])
    for a, b in zip(tree_leaves(out), tree_leaves(trees[0]), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype and a.is_cuda


# ------------------------------------------------------------- LLM kernels
def full_close(got, want, what, rtol=2e-5):
    """The full-shape bound stated in the module docstring."""
    err = (got.float() - want.float()).abs().max().item()
    lim = rtol * max(1.0, want.float().abs().max().item())
    assert err <= lim, f"{what}: max abs err {err} > {lim}"


def attn_case(gen, b, h, kv, s, d, dtype):
    return tuple(randn(gen, b, n, s, d).to(dtype) for n in (h, kv, kv))


@pytest.mark.parametrize("H,KV,S,causal,window,dtype", [
    (4, 2, 64, True, 0, torch.float32),
    (4, 1, 96, True, 32, torch.float32),
    (2, 2, 64, False, 0, torch.float32),
    (8, 4, 128, True, 64, torch.float32),
    (4, 2, 64, True, 16, torch.bfloat16),
    (4, 2, 50, True, 0, torch.float32),       # S, T padded to the tile
])
def test_local_attn_kernel_matches_plain_on_the_sweep(H, KV, S, causal,
                                                      window, dtype, cuda):
    gen = torch.Generator(device=cuda).manual_seed(S * 10 + H)
    q, k, v = attn_case(gen, 2, H, KV, S, 32, dtype)
    before = launch_counts()["local_attn"]
    out = local_flash_attention(q, k, v, causal=causal, window=window,
                                scale=0.18)
    assert launch_counts()["local_attn"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = local_attention_ref(q, k, v, causal=causal, window=window,
                               scale=0.18)
    atol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
def test_local_attn_kernel_takes_every_head_dim(D, cuda):
    gen = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = attn_case(gen, 1, 2, 1, 80, D, torch.float32)
    out = local_flash_attention(q, k, v, causal=True, window=24,
                                scale=D ** -0.5)
    want = local_attention_ref(q, k, v, causal=True, window=24,
                               scale=D ** -0.5)
    torch.testing.assert_close(out, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("B,H,KV,S,T,D,causal,window,dtype", [
    (2, 4, 2, 64, 64, 16, True, 0, torch.float32),
    (1, 8, 2, 200, 200, 32, True, 0, torch.float32),     # S off the tiles
    (2, 4, 1, 130, 130, 64, False, 0, torch.float32),    # bidirectional
    (1, 4, 4, 100, 77, 128, False, 0, torch.float32),    # T != S, ragged
    (1, 8, 1, 333, 333, 256, True, 48, torch.float32),   # a window
    (1, 2, 1, 70, 150, 256, True, 0, torch.float32),     # S < T
    (1, 4, 2, 150, 150, 128, False, 40, torch.float32),  # window, no mask
    (2, 4, 2, 90, 90, 16, True, 20, torch.bfloat16),
    (1, 4, 1, 150, 150, 32, False, 0, torch.bfloat16),
])
def test_local_attn_tf32_forward_matches_plain_and_f64(B, H, KV, S, T, D,
                                                       causal, window, dtype,
                                                       cuda):
    """The split-tf32 forward (module docstring): one launch on its route,
    the plain version's answer, as near f64, its lse, the same bits
    twice."""
    gen = torch.Generator(device=cuda).manual_seed(S + T + D)
    q = randn(gen, B, H, S, D).to(dtype)
    k, v = (randn(gen, B, KV, T, D).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window, scale=D ** -0.5)
    before = (attn_ops.launches, attn_ops.launches_tc,
              attn_ops.launches_tf32)
    out = local_flash_attention(q, k, v, **kw)
    assert (attn_ops.launches, attn_ops.launches_tc,
            attn_ops.launches_tf32) == (before[0] + 1, before[1],
                                        before[2] + 1)
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.equal(out, local_flash_attention(q, k, v, **kw))
    plain = local_attention_ref(q, k, v, **kw)
    exact = local_attention_ref(q.double(), k.double(), v.double(), **kw)
    full_close(out, plain, "local_attn tf32",
               rtol=2e-5 if dtype == torch.float32 else 2e-2)
    d_k, d_p = f64_distance(out, exact), f64_distance(plain, exact)
    assert d_k <= ATTN_F64_FACTOR * d_p, (d_k, d_p)
    _, lse = attn_ops._forward_cuda(q, k, v, causal, window, kw["scale"],
                                    True)
    s = torch.einsum("bhsd,bhtd->bhst", q.double(),
                     k.double().repeat_interleave(H // KV, 1)) * kw["scale"]
    ok = torch.ones(S, T, dtype=torch.bool, device=cuda)
    pos_q = torch.arange(S, device=cuda)[:, None]
    pos_k = torch.arange(T, device=cuda)[None, :]
    if causal:
        ok &= pos_k <= pos_q
    if window:
        ok &= pos_k > pos_q - window
    want = torch.logsumexp(s.masked_fill(~ok, float("-inf")), dim=-1)
    full_close(lse, want, "local_attn tf32 lse")


def test_local_attn_tf32_forward_reads_strided_views_in_place(cuda):
    """f32 q, k, v as the model hands them over, (b, s, heads, D)
    transposed: the output takes q's layout and equals the contiguous
    copies' output bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (randn(gen, 2, 200, n, 64) for n in (4, 2, 2))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    out = local_flash_attention(*views, causal=True, scale=0.125)
    assert out.stride() == views[0].stride()
    want = local_flash_attention(*(t.contiguous() for t in views),
                                 causal=True, scale=0.125)
    assert torch.equal(out, want)


def attn_f64_check(q, k, v, out, **kw):
    """The tensor-core route's distance to f64 against the plain version's
    bf16 output's (module docstring)."""
    exact = local_attention_ref(q.double(), k.double(), v.double(), **kw)
    plain = local_attention_ref(q, k, v, **kw)
    d_tc, d_plain = f64_distance(out, exact), f64_distance(plain, exact)
    assert d_tc <= ATTN_F64_FACTOR * d_plain, (d_tc, d_plain)
    torch.testing.assert_close(out.float(), plain.float(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("H,KV,S,causal,window,D", [
    (4, 2, 64, True, 0, 64),
    (4, 1, 96, True, 32, 128),
    (2, 2, 64, False, 0, 64),
    (8, 4, 128, True, 64, 256),
    (4, 2, 50, True, 0, 128),        # S, T not multiples of the tiles
    (2, 1, 200, True, 20, 256),      # a window narrower than a key tile
    (2, 2, 130, False, 40, 64),      # a window without the causal mask
])
def test_local_attn_tc_route_matches_plain_on_the_sweep(H, KV, S, causal,
                                                        window, D, cuda):
    gen = torch.Generator(device=cuda).manual_seed(S * 10 + H + D)
    q, k, v = attn_case(gen, 2, H, KV, S, D, torch.bfloat16)
    before, before_tc = attn_ops.launches, attn_ops.launches_tc
    out = local_flash_attention(q, k, v, causal=causal, window=window,
                                scale=D ** -0.5)
    assert (attn_ops.launches, attn_ops.launches_tc) == (before + 1,
                                                         before_tc + 1)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    attn_f64_check(q, k, v, out, causal=causal, window=window,
                   scale=D ** -0.5)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_local_attn_tc_route_is_as_close_to_f64_as_plain(D, cuda):
    """gemma-2b's scoring shape (B 2, H 8, KV 1, S 2048) at each head_dim
    the route takes."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = attn_case(gen, 2, 8, 1, 2048, D, torch.bfloat16)
    before_tc = attn_ops.launches_tc
    out = local_flash_attention(q, k, v, causal=True, scale=D ** -0.5)
    assert attn_ops.launches_tc == before_tc + 1
    attn_f64_check(q, k, v, out, causal=True, window=0, scale=D ** -0.5)


@pytest.mark.parametrize("S", [2048, 200])
def test_local_attn_tc_route_reads_strided_views_in_place(S, cuda):
    """q, k, v as the model hands them over: (b, s, heads, D) transposed
    to (b, heads, s, D).  The output takes q's layout, so the model's
    transpose back is free, and equals the contiguous copies' output."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (randn(gen, 2, S, n, 256).to(torch.bfloat16) for n in (8, 1, 1))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    out = local_flash_attention(*views, causal=True, scale=0.0625)
    assert out.stride() == views[0].stride()
    assert out.transpose(1, 2).is_contiguous()
    want = local_flash_attention(*(t.contiguous() for t in views),
                                 causal=True, scale=0.0625)
    assert torch.equal(out, want)


def test_local_attn_f32_stays_on_the_cuda_cores(cuda):
    """f32 never takes the bf16 tensor-core route: its forward runs split
    tf32 (``launches_tf32``)."""
    q = torch.zeros(1, 2, 64, 128, device=cuda)
    before = (attn_ops.launches, attn_ops.launches_tc,
              attn_ops.launches_tf32)
    local_flash_attention(q, q, q, scale=0.1)
    assert (attn_ops.launches, attn_ops.launches_tc,
            attn_ops.launches_tf32) == (before[0] + 1, before[1],
                                        before[2] + 1)


def test_local_attn_kernel_refuses_other_head_dims(cuda):
    """Head dims up to 256 are padded to an instantiation (next test);
    above it no kernel is built, and the wrapper raises."""
    q = torch.zeros(1, 1, 32, 320, device=cuda)
    with pytest.raises(ValueError, match="head_dim 320"):
        local_flash_attention(q, q, q)


@pytest.mark.parametrize("D,dtype", [
    (48, torch.float32), (48, torch.bfloat16), (80, torch.float32),
    (80, torch.bfloat16), (192, torch.bfloat16), (192, torch.float32)])
def test_local_attn_kernel_takes_padded_head_dims(D, dtype, cuda):
    """D between the instantiations (hubert-xlarge 80, MLA's qk 192) runs
    zero-padded to the next one at the caller's scale: bf16 on the tensor
    cores (and as close to f64 as the plain version), f32 on the CUDA
    cores."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = attn_case(gen, 2, 4, 2, 100, D, dtype)
    before, before_tc = attn_ops.launches, attn_ops.launches_tc
    out = local_flash_attention(q, k, v, causal=True, window=40,
                                scale=D ** -0.5)
    tc = dtype == torch.bfloat16
    assert (attn_ops.launches, attn_ops.launches_tc) == (before + 1,
                                                         before_tc + tc)
    assert out.shape == q.shape and out.dtype == dtype
    if tc:
        attn_f64_check(q, k, v, out, causal=True, window=40, scale=D ** -0.5)
    else:
        want = local_attention_ref(q, k, v, causal=True, window=40,
                                   scale=D ** -0.5)
        torch.testing.assert_close(out, want, rtol=0, atol=2e-5)


def test_local_attn_window_actually_limits_context(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    S, W = 64, 8
    q, k, v = attn_case(gen, 1, 2, 2, S, 16, torch.float32)
    out1 = local_flash_attention(q, k, v, causal=True, window=W, scale=0.25)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, :S - 2 * W] = 99.0
    v2[:, :, :S - 2 * W] = -99.0
    out2 = local_flash_attention(q, k2, v2, causal=True, window=W, scale=0.25)
    torch.testing.assert_close(out1[:, :, -1], out2[:, :, -1], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("b,h,s,window,dtype", [
    (2, 8, 2048, 0, torch.bfloat16),       # gemma-2b's scoring path
    (2, 8, 2048, 0, torch.float32),
    (1, 16, 4096, 2048, torch.float32),    # RecurrentGemma's local window
])
def test_local_attn_kernel_at_the_path_shapes(b, h, s, window, dtype, cuda):
    gen = torch.Generator(device=cuda).manual_seed(h + window)
    q, k, v = attn_case(gen, b, h, 1, s, 256, dtype)
    out = local_flash_attention(q, k, v, causal=True, window=window,
                                scale=256 ** -0.5)
    want = local_attention_ref(q, k, v, causal=True, window=window,
                               scale=256 ** -0.5)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), want.float(), rtol=0,
                                   atol=2e-2)
    else:
        full_close(out, want, "local_attn")


def ssd_inputs(gen, b, l, h, p, g, n):
    x = randn(gen, b, l, h, p)
    dt = torch.nn.functional.softplus(randn(gen, b, l, h))
    A = -torch.exp(randn(gen, h, scale=0.5))
    return x, dt, A, randn(gen, b, l, g, n), randn(gen, b, l, g, n)


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [
    (1, 16, 2, 4, 1, 8, 4),
    (2, 32, 4, 8, 2, 16, 8),
    (1, 20, 2, 16, 1, 32, 8),     # l not divisible by chunk (padding path)
])
def test_ssd_kernel_matches_plain_on_the_sweep(b, l, h, p, g, n, chunk, cuda):
    gen = torch.Generator(device=cuda).manual_seed(l * 10 + n)
    args = ssd_inputs(gen, b, l, h, p, g, n)
    before = launch_counts()["ssd_chunk"]
    y, s = ssd_chunked_fused(*args, chunk)
    assert launch_counts()["ssd_chunk"] == before + 1
    yr, sr = ssd_chunked(*args, chunk)
    torch.testing.assert_close(y, yr, rtol=0, atol=2e-5)
    torch.testing.assert_close(s, sr, rtol=0, atol=2e-5)


@pytest.mark.parametrize("b,s", [(4, 2048), (4, 2000), (1, 520)])
def test_ssd_kernel_at_the_path_shapes(b, s, cuda):
    """mamba2-370m: l 256, h 32, p 64, n 128, one group of B and C (as the
    path hands them over); 2000 and 520 tokens take the padding path."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    x, dt, A, B, C = ssd_inputs(gen, b, s, 32, 64, 1, 128)
    c = -(-s // 256)
    pad = c * 256 - s
    xdt = torch.nn.functional.pad(x * dt[..., None], (0, 0, 0, 0, 0, pad))
    dA = torch.nn.functional.pad(dt * A, (0, 0, 0, pad))
    Bg, Cg = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (B, C))
    args = [t.reshape(b, c, 256, *t.shape[2:]).contiguous()
            for t in (xdt, dA, Bg, Cg)]
    y, st = ssd_intra_chunk(*args)
    yr, sr = ssd_intra_chunk_ref(*args)
    full_close(y, yr, "ssd_chunk y_diag")
    full_close(st, sr, "ssd_chunk states")
    exact = ssd_intra_chunk_ref(*(t.double() for t in args))
    for k, p, e in zip((y, st), (yr, sr), exact, strict=True):
        assert f64_distance(k, e) <= SSD_F64_FACTOR * f64_distance(p, e)
    exact = ssd_chunked(*(t.double() for t in (x, dt, A, B, C)), 256)
    for k, e in zip(ssd_chunked_fused(x, dt, A, B, C, 256), exact,
                    strict=True):
        assert f64_distance(k, e) <= 2e-5


def f64_distance(got, exact):
    """max|got - exact| / max|exact|."""
    return ((got.double() - exact).abs().max() / exact.abs().max()).item()


def test_ssd_kernel_refuses_states_it_cannot_hold(cuda):
    """The kernel tiles n and p, so a head dim of 65 and a state of 160,
    once refused, are computed; what it still refuses is a head count the
    groups do not divide."""
    gen = torch.Generator(device=cuda).manual_seed(65)
    args = ssd_group_args(gen, 1, 1, 8, 1, 65, 1, 160)
    before = launch_counts()["ssd_chunk"]
    y, st = ssd_intra_chunk(*args)
    assert launch_counts()["ssd_chunk"] == before + 1
    ssd_close_and_f64(args, (y, st))
    x = torch.zeros(1, 1, 8, 3, 4, device=cuda)
    bc = torch.zeros(1, 1, 8, 2, 4, device=cuda)
    with pytest.raises(ValueError, match="3 heads over 2 groups"):
        ssd_intra_chunk(x, x[..., 0].contiguous(), bc, bc)


def ssd_group_args(gen, b, c, l, h, p, g, n):
    """Kernel inputs with one B and C per group, dA negative."""
    return (randn(gen, b, c, l, h, p), -randn(gen, b, c, l, h).abs() * 0.5,
            randn(gen, b, c, l, g, n), randn(gen, b, c, l, g, n))


def ssd_close_and_f64(args, got):
    """The kernel's outputs within 2e-5 * max(1, max|plain|) of the plain
    version and at most SSD_F64_FACTOR times as far from f64."""
    want = ssd_intra_chunk_ref(*args)
    exact = ssd_intra_chunk_ref(*(t.double() for t in args))
    for k, p, e, what in zip(got, want, exact, ("y_diag", "states"),
                             strict=True):
        full_close(k, p, f"ssd_chunk {what}")
        assert f64_distance(k, e) <= SSD_F64_FACTOR * f64_distance(p, e)


@pytest.mark.parametrize("b,c,l,h,p,g,n", [
    (2, 2, 32, 4, 80, 2, 160),     # g 2, n 160, p 80
    (1, 2, 20, 6, 80, 2, 160),     # three heads a group, ragged l
    (1, 1, 256, 8, 64, 1, 128),    # one chunk of mamba2-370m's shape
    (2, 1, 70, 4, 3, 4, 5),        # g == h; n, p not multiples of 4
    (1, 3, 64, 2, 130, 1, 200),    # p past two tiles of 64, n past three
])
def test_ssd_kernel_takes_any_state_size(b, c, l, h, p, g, n, cuda):
    gen = torch.Generator(device=cuda).manual_seed(l * 10 + n + p)
    args = ssd_group_args(gen, b, c, l, h, p, g, n)
    ssd_close_and_f64(args, ssd_intra_chunk(*args))


@pytest.mark.parametrize("h,g", [(8, 1), (8, 2), (6, 3)])
def test_ssd_kernel_per_group_equals_head_broadcast(h, g, cuda):
    """B and C once per group give the bits of the same B and C repeated
    per head (g == h): every output sums the same products in the same
    order, whichever block of heads forms C Bᵀ."""
    gen = torch.Generator(device=cuda).manual_seed(h + g)
    xdt, dA, B, C = ssd_group_args(gen, 2, 3, 96, h, 64, g, 128)
    got = ssd_intra_chunk(xdt, dA, B, C)
    rep = [t.repeat_interleave(h // g, dim=3).contiguous() for t in (B, C)]
    want = ssd_intra_chunk(xdt, dA, *rep)
    for a, w in zip(got, want, strict=True):
        assert torch.equal(a, w)


@pytest.mark.parametrize("arch", ["mamba2-370m", "gemma-2b"])
def test_llm_forward_on_card_matches_cpu(arch, cuda):
    """The reduced model: one kernel launch per layer on the card, and the
    logits of the plain route on the CPU."""
    cfg = reduced_for_smoke(get_config(arch))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    want, _ = model.forward(params, tokens=toks)
    reset_launch_counts()
    got, _ = model.forward(tree_map(lambda x: x.to(cuda), params),
                           tokens=toks.to(cuda))
    name = "ssd_chunk" if arch == "mamba2-370m" else "local_attn"
    assert launch_counts()[name] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=5e-5)


# ------------------------------ the MoE, MLA, hybrid, audio and VLM families
FAMILIES = ["deepseek-moe-16b", "deepseek-v3-671b", "recurrentgemma-9b",
            "hubert-xlarge", "internvl2-76b"]


def family_case(arch, dtype="float32"):
    """A reduced model of ``arch`` (recurrentgemma at 5 layers: a scanned
    (rec, rec, local_attn) group and an unrolled remainder), its weights
    drawn on the CPU, and a numpy batch of the family's kind."""
    cfg = reduced_for_smoke(get_config(arch)).replace(dtype=dtype)
    if cfg.rglru is not None:
        cfg = cfg.replace(n_layers=5)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    if cfg.family == "audio":
        batch = audio_batch(rng, 2, 40, cfg.frontend.embed_dim,
                            cfg.vocab_size)
    elif cfg.family == "vlm":
        batch = vlm_batch(rng, 2, 48, 8, cfg.frontend.embed_dim,
                          cfg.vocab_size)
    else:
        batch = lm_batch(rng, 2, 40, cfg.vocab_size)
    return cfg, model, params, batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_and_gradients_on_card_match_cpu(arch, cuda):
    """f32: one forward and one backward ``local_attn`` launch an
    attention block (MTP's included), the loss within 1e-5 and every
    gradient leaf within 1e-4 x max(1, max|g_cpu|) of the CPU's (a kernel
    output without ``grad_fn`` would drop its terms)."""
    cfg, model, params, batch = family_case(arch)

    def loss_grads(p):
        live = tree_map(lambda x: x.detach().requires_grad_(), p)
        loss, _ = loss_for_batch(model, cfg, live, batch)
        return loss.item(), torch.autograd.grad(
            loss, tree_leaves(live), allow_unused=True,
            materialize_grads=True)

    want_loss, want = loss_grads(params)
    reset_launch_counts()
    got_loss, got = loss_grads(tree_map(lambda x: x.to(cuda), params))
    n = attention_blocks(cfg) + cfg.mtp_depth
    assert launch_counts()["local_attn"] == 2 * n
    assert attn_ops.launches_bwd == n
    assert abs(got_loss - want_loss) <= 1e-5
    for g, w in zip(got, want, strict=True):
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * max(
            1.0, w.abs().max().item())


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_bf16_forward_takes_the_tensor_cores(arch, cuda):
    """bf16 (the configs' dtype): every attention block's launch on the
    tensor-core route (MLA's qk head dim 48 and v zero-padded to 64), a
    finite loss within 2 of ln V."""
    cfg, model, params, batch = family_case(arch, "bfloat16")
    params = tree_map(lambda x: x.to(cuda), params)
    reset_launch_counts()
    with torch.no_grad():
        loss, met = loss_for_batch(model, cfg, params, batch)
    n = attention_blocks(cfg) + cfg.mtp_depth
    assert launch_counts()["local_attn"] == attn_ops.launches_tc == n
    assert abs(met["ce"].item() - math.log(cfg.vocab_size)) < 2.0


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b",
                                  "recurrentgemma-9b", "internvl2-76b"])
def test_family_decode_on_card_matches_the_kernel_forward(arch, cuda):
    """f32: decode by replay (no kernel) against the kernel forward on the
    card within 2e-4 (recurrentgemma at window 8, so its rolling cache
    wraps), and ragged decoding equal to independent decoding."""
    cfg, model, params, _ = family_case(arch)
    if cfg.rglru is not None:
        model = build_model(cfg.replace(rglru=dataclasses.replace(
            cfg.rglru, attn_window=8)))
    params = tree_map(lambda x: x.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(2)).to(cuda)
    with torch.no_grad():
        full, _ = model.forward(params, tokens=toks)
        caches = model.init_caches(2, 20, torch.float32, cuda)
        reset_launch_counts()
        for t in range(20):
            lg, caches = model.decode_step(params, caches, toks[:, t:t + 1],
                                           t)
            assert (lg[:, 0] - full[:, t]).abs().max().item() < 2e-4
    assert all(n == 0 for n in launch_counts().values())
    eng = ServeEngine(model, params, max_len=32)
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, cfg.vocab_size, n) for n in (3, 9)]
    ragged = eng.generate_ragged(reqs, 5)
    for i, r in enumerate(reqs):
        assert (ragged[i] == eng.generate(r[None], 5)[0]).all()


# ------------------------------------------------- the process server tier
def drawn_trees(dev, n, seed=0):
    """n forecaster trees drawn on the CPU from one seed, moved to dev
    (the same values on every device)."""
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=128))
    gen = torch.Generator().manual_seed(seed)
    return [tree_map(lambda x: x.to(dev), fc.init(gen, "cpu"))
            for _ in range(n)]


def test_cuda_shard_worker_fold_matches_plain(cuda):
    """A shard worker on the card folds a drain batch of forecaster trees
    with one launch of the fold kernel; the same commands through a CPU
    worker (the plain version) give the same params within 1e-6."""
    from repro_torch.checkpoint.msgpack_ckpt import packb
    from repro_torch.core.aggregation import AggregationConfig
    from repro_torch.core.server_proc import ShardWorker, make_seed_blob

    trees = drawn_trees("cpu", 6)
    blob = make_seed_blob([("c0", trees[0], _meta(50, 1, 1))], 8,
                          AggregationConfig(), None)
    workers = [ShardWorker(0, blob, d) for d in (cuda, "cpu")]
    msgs = [packb(["sub", i, "c0", t, [20 + i, 1, 1], [20 + i, 1, 1], 0])
            for i, t in enumerate(trees[1:])]
    replies = []
    for w in workers:
        for raw in msgs:
            w.handle(w.decode(raw))
        reset_launch_counts()
        replies.append(w.handle(w.decode(packb(["drain", "c0"]))))
        if w.device.type == "cuda":
            torch.cuda.synchronize()
            assert launch_counts()["fedavg_agg"] == 1
    (_, _, n, _, batches, acked, got, meta), want = replies[0], replies[1]
    assert (n, batches, acked, meta) == (5, 1, [0, 1, 2, 3, 4], want[7])
    for g, p in zip(tree_leaves(got), tree_leaves(want[6]), strict=True):
        assert g.device.type == "cuda"
        assert (g.cpu() - p).abs().max().item() <= 1e-6


def _meta(s, e, r):
    from repro_torch.core.aggregation import ModelMeta

    return ModelMeta(s, e, r)


def test_spawned_cuda_workers_cold_start_and_fold(cuda):
    """Two spawned workers and one subprocess shard server on the card:
    each announces ready within the cold-start allowance, and their folds
    equal the in-process emulation's on the CPU within 1e-6."""
    from repro_torch.core.aggregation import UpdateDelta
    from repro_torch.core.store import ProcessShardedModelStore
    from repro_torch.core.transport import LoopbackShardServers

    trees = drawn_trees(cuda, 9, seed=1)
    keys = ["c0", "c1", "c2"]
    ref = ProcessShardedModelStore(tree_map(lambda x: x.cpu(), trees[0]),
                                   keys, n_shards=2, inprocess=True,
                                   device="cpu")
    with LoopbackShardServers(1, device="cuda") as srv:
        stores = [ProcessShardedModelStore(trees[0], keys, n_shards=2,
                                           device=cuda),
                  ProcessShardedModelStore(trees[0], keys, device=cuda,
                                           server_hosts=srv.hosts)]
        cold = [sh.handle.cold_start_s for sh in stores[0]._proc_shards]
        assert all(0 < c < 180 for c in cold), cold
        assert 0 < srv.startup_s[0] < 120
        for i, t in enumerate(trees[1:]):
            for s in stores + [ref]:
                p = t if s is not ref else tree_map(lambda x: x.cpu(), t)
                for key in (keys[i % 3], None):
                    s.handle_model_update(
                        "global" if key is None else "cluster", key, p,
                        _meta(10 + i, 1, 1), UpdateDelta(10 + i, 1, 1))
        for s in stores + [ref]:
            s.drain_all()
        for s in stores:
            stats = s.agg_stats()
            assert stats["respawns"] == 0 and stats["drain_timeouts"] == 0
            for level, key in [("global", None)] + [("cluster", k)
                                                   for k in keys]:
                assert s.meta(level, key) == ref.meta(level, key)
                for g, p in zip(tree_leaves(s.params(level, key)),
                                tree_leaves(ref.params(level, key)),
                                strict=True):
                    assert g.device.type == "cuda"
                    assert (g.cpu() - p).abs().max().item() <= 1e-6
            s.close()


# ------------------------------------------------------------ distribution
def test_forward_on_a_one_card_mesh_equals_the_plain_forward(cuda):
    """Reduced gemma-2b with its parameters and tokens distributed on
    ``make_host_mesh()``'s (1, 1) mesh over an nccl world of one: the
    logits equal the plain forward's on the card bit for bit, one
    ``local_attn`` launch a layer; the group is gone afterwards."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import host_world
    from repro_torch.sharding.logical import (
        distribute,
        logical_to_spec,
        make_rules,
        on_mesh,
        placements,
        shardings_from_schema,
    )

    cfg = reduced_for_smoke(get_config("gemma-2b"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cuda)
    toks = torch.as_tensor(lm_batch(np.random.default_rng(0), 2, 64,
                                    cfg.vocab_size)["tokens"], device=cuda)
    with torch.no_grad():
        base, _ = model.forward(params, tokens=toks)
    with host_world(cuda) as mesh:
        rules = make_rules(mesh)
        placed = distribute(params, mesh, shardings_from_schema(
            model.schema(), mesh, rules))
        dtoks = distribute_tensor(toks, mesh, placements(logical_to_spec(
            ("batch", "seq"), rules, tuple(toks.shape)), mesh),
            src_data_rank=None)
        reset_launch_counts()
        with torch.no_grad(), on_mesh():
            out, _ = model.forward(placed, tokens=dtoks, rules=rules)
        torch.cuda.synchronize()
        assert launch_counts()["local_attn"] == cfg.n_layers
        assert torch.equal(out.to_local(), base)
    assert not dist.is_initialized()


def test_cluster_parallel_on_card_matches_cpu(cuda):
    """Two reduced gemma-2b clusters, one SGD step each (no clipping), from
    the same CPU-drawn parameters on the card and on the CPU: losses within
    1e-4; the parameters and the global tier within the reference test's
    rtol 1e-4 / atol 1e-6; and each cluster's update (new - init) leaf by
    leaf within 1e-3 x max|update_cpu| plus one f32 ulp of max|p_cpu| (the
    rounding of the two subtractions), so that a card step that applied
    no update, or another cluster's, fails."""
    from repro_torch.core.cluster_parallel import ClusterParallel
    from repro_torch.optim import sgd

    cfg = reduced_for_smoke(get_config("gemma-2b"))
    rng = np.random.default_rng(0)
    batches = [lm_batch(rng, 2, 32, cfg.vocab_size, structure=1.0)
               for _ in range(2)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    runs = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg)
        cp = ClusterParallel(model, cfg, sgd(5e-3), 2, grad_clip=0.0)
        state = cp.init(torch.Generator().manual_seed(0), dev)
        init = [x.cpu() for x in tree_leaves(state.params)]
        new, metrics = cp.step(state, {k: torch.as_tensor(v, device=dev)
                                       for k, v in stacked.items()})
        runs[str(dev)] = (init, new, metrics, cp.global_params(new, [1, 3]))
    (c_init, c_new, c_m, c_g), (g_init, g_new, g_m, g_g) = (runs["cpu"],
                                                            runs[str(cuda)])
    np.testing.assert_allclose(g_m["loss"].cpu().numpy(),
                               c_m["loss"].numpy(), atol=1e-4, rtol=0)
    for got, want in ((g_new.params, c_new.params), (g_g, c_g)):
        for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-4, atol=1e-6)
    moved = 0
    for gi, ci, a, b in zip(g_init, c_init, tree_leaves(g_new.params),
                            tree_leaves(c_new.params), strict=True):
        assert torch.equal(gi, ci)
        for k in range(2):
            du, dc = a[k].cpu() - gi[k], b[k] - ci[k]
            lim = (1e-3 * dc.abs().max().item()
                   + 2.0 ** -23 * ci[k].abs().max().item())
            assert (du - dc).abs().max().item() <= lim
            moved += bool(dc.abs().max() > lim)
    assert moved > 0
