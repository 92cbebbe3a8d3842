"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU; the
file imports only torch, numpy and ``repro_torch`` so that it runs on a
machine without JAX.  Shapes are the solar main path's: T = 141,953
parameters at hidden 128, H = 128 with I = 9 or 10.  Tolerances: fold
atol 1e-6 (N-way f32 sums in the same order), step atol 1e-5, anchor
gradient rtol/atol 1e-5 and loss rtol 1e-4, DP release atol 1e-5 (the
reference tests' own).
"""

import pytest
import torch

from repro_torch.configs.solar_lstm import SolarLSTMConfig
from repro_torch.core.aggregation import _pad_pow2
from repro_torch.kernels.dp_clip_noise.ops import privatize_flat
from repro_torch.kernels.dp_clip_noise.ref import dp_clip_noise_ref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ewc_update.ops import ewc_penalty_grad_flat
from repro_torch.kernels.ewc_update.ref import ewc_ref
from repro_torch.kernels.fedavg_agg.ops import aggregate_flat
from repro_torch.kernels.fedavg_agg.ref import agg_ref
from repro_torch.kernels.lstm_cell.ops import LSTMCellFn, lstm_step
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
from repro_torch.models.lstm import SolarForecaster
from repro_torch.privacy.dp import DPConfig, DPPrivatizer
from repro_torch.utils.tree import tree_map

pytestmark = pytest.mark.cuda
T = 141_953


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


def test_forecaster_on_card_matches_cpu(cuda):
    """768 kernel steps against 768 plain steps, same weights and inputs."""
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
    assert launch_counts()["lstm_cell"] == (fc.cfg.history_steps
                                            + fc.cfg.horizon_steps)
    torch.testing.assert_close(got.cpu(), fc.forward(params, hist, fcst),
                               rtol=0, atol=1e-5)
