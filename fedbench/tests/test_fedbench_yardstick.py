"""The metric files' frozen arithmetic against the port's kernel table
(PERF.md's ``bound_ms``) and the port's own 6 N D.  The test imports the
port to compare; the harness does not."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from fedbench import harness  # noqa: E402

LSTM = harness.metric_reader("lstm_seq_roofline")
SSD = harness.metric_reader("ssd_chunk_roofline")
MFU_LM = harness.metric_reader("mfu.lm")
MFU_SOLAR = harness.metric_reader("mfu.solar")
CONF = {c: json.loads((ROOT / "fedbench" / "configs" / f"{c}.json")
                      .read_text())
        for c in ("solar-lstm-h128", "mamba2-370m")}


def test_lstm_seq_bounds_match_the_kernel_table():
    fwd, bwd = LSTM.seq_bounds(672, 8, 10, 128)
    assert fwd * 1e3 == pytest.approx(0.01134, abs=5e-6)
    assert bwd * 1e3 == pytest.approx(0.01052, abs=5e-6)


def test_ssd_chunk_bound_matches_the_kernel_table():
    fwd, _ = SSD.ssd_bounds(4, 8, 256, 32, 64, 1, 128)
    assert fwd * 1e3 == pytest.approx(0.13323, abs=5e-6)
    _, bwd = SSD.ssd_bounds(2, 8, 256, 32, 64, 1, 128)
    assert bwd * 1e3 == pytest.approx(0.26018, abs=5e-6)


def test_six_n_d_equals_the_ports():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.roofline import model_flops
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import param_count

    cfg = get_config("mamba2-370m")
    n = param_count(build_model(cfg).param_shapes())
    assert MFU_LM.n_params(CONF["mamba2-370m"]["model"]) == n
    shape = InputShape("cell", 2048, 4, "train")
    assert 6.0 * n * 4 * 2048 == model_flops(cfg, shape, n, n)


def test_forecaster_flops_and_parameters():
    m = CONF["solar-lstm-h128"]["model"]
    h = m["hidden_size"]
    params = ((m["history_channels"] + h) * 4 * h + 4 * h
              + (m["forecast_channels"] + h) * 4 * h + 4 * h + h + 1)
    assert params == m["n_params"] == 141953
    fwd = MFU_SOLAR.forward_flops(m)
    assert fwd == 2 * 4 * h * (138 * 672 + 137 * 96) + 2 * h * 96


def test_peaks():
    from fedbench import peaks

    assert peaks.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 989e12, peaks.BF16_FLOP_PER_S) \
        == pytest.approx(1.0)
