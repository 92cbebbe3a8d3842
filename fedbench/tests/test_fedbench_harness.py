"""The rest of a run without the chip: each cell at a small size on the
CPU (the kernels' plain versions), sound, with its control in the
program's place, and with the timed path broken underneath: a step that
returns its state unchanged, half of the batch left out (the mean over
the rest), an update altered where the client produces it, a fold altered
where the server produces it, a fold that leaves the model as it was
(``faults.py``).  Each broken run must come out not correct.  (One chip:
no exchange between chips to leave out.)  Small sizes come from
``small/<cell>.json``."""

import dataclasses
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(HERE)]

import faults  # noqa: E402
from fedbench import checks, harness  # noqa: E402

CELLS = {"solar": "solar-fleet-threaded", "lm": "mamba2-fed-4x2048"}
SEED = 2 ** 31 + 17
CELL_SPEC = harness.cell_spec


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_spec(cell, **federation):
    """The cell's files with the sizes of ``small/<cell>.json`` (and the
    ``federation`` fields given) in place of theirs."""
    entry, work, conf = CELL_SPEC(cell)
    small = harness.load_json(HERE / "small" / f"{cell}.json")
    for key, val in small["config"].items():
        conf[key] = {**conf[key], **val}
    for key, val in small["workload"].items():
        work[key] = {**work[key], **val}
    work["federation"] = {**work["federation"], **federation}
    return entry, work, conf


def run(monkeypatch, kind, seconds=2.0, **federation):
    spec = small_spec(CELLS[kind], **federation)
    monkeypatch.setattr(harness, "cell_spec", lambda *a: spec)
    return harness.run_cell(CELLS[kind], SEED, seconds, False, device="cpu",
                            log=lambda s: None)


@pytest.mark.parametrize("kind", ["solar", "lm"])
def test_sound_run_is_correct(monkeypatch, kind):
    from repro_torch.core import aggregation, store

    r = run(monkeypatch, kind)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "cpu"
    # the fold tap is gone once the window has closed
    assert store.aggregate_models is aggregation.aggregate_models
    assert store.coalesced_aggregate is aggregation.coalesced_aggregate


def test_threaded_runtime_runs(monkeypatch):
    r = run(monkeypatch, "solar", 5.0, runtime="threaded")
    assert r["attempted"] > 0
    assert r["correct"], r["checks"]


def test_federation_block_reaches_the_config():
    """Every field of a workload's ``federation`` block reaches the
    program's config, so a cell with secure aggregation and DP is a
    workload file."""
    _, work, conf = CELL_SPEC(CELLS["solar"])
    work["federation"].update(secure_agg=True, dp_clip=5.0,
                              dp_noise_multiplier=0.3, server_processes=4)
    cfg = harness.federation_config(work, conf["training"], 7, False)
    assert (cfg.secure_agg, cfg.dp_clip, cfg.dp_noise_multiplier,
            cfg.server_processes) == (True, 5.0, 0.3, 4)
    assert cfg.runtime == "threaded" and cfg.max_coalesce == 16
    assert cfg.spaces[1].metric == "cyclic" and cfg.seed == 7
    work["federation"]["no_such_field"] = 1
    with pytest.raises(TypeError):
        harness.federation_config(work, conf["training"], 7, False)


@pytest.mark.parametrize("field", harness.UNTAPPED)
def test_untapped_folds_are_refused(field):
    """Masked sums and folds in shard workers or servers never reach the
    fold tap: the recorder refuses such a federation at set-up, by name."""
    from repro_torch.core.fedccl import FedCCLConfig

    value = ("localhost:1",) if field == "server_hosts" else \
        True if field == "secure_agg" else 2
    fed = types.SimpleNamespace(
        cfg=dataclasses.replace(FedCCLConfig(), **{field: value}),
        clients=[])
    with pytest.raises(NotImplementedError, match=field):
        harness.Recorder(1, 1, 1).instrument(fed)


@pytest.mark.parametrize("kind", ["solar", "lm"])
def test_control_is_not_correct(kind):
    """The reference in the precision below the configuration's, put in
    the program's place, fails at least one of the cell's numbers; the
    program passes them all."""
    entry, work, conf = small_spec(CELLS[kind])
    cell = harness.driver(conf["driver"]).Cell(conf, work, SEED,
                                               torch.device("cpu"), False)
    cell.setup()
    cell.window(2.0)
    low = conf["control_precision"]
    got = checks.readings(cell, (checks.PROGRAM, low))
    limits = work["limits"]
    assert all(got[checks.PROGRAM][k] <= v for k, v in limits.items()), got
    assert any(got[low][k] > v for k, v in limits.items()), got


# ------------------------------------------------------------- faults
@pytest.mark.parametrize("kind", ["solar", "lm"])
@pytest.mark.parametrize("fault", faults.CLIENT + faults.SERVER)
def test_broken_path_is_not_correct(monkeypatch, kind, fault):
    faults.plant(monkeypatch, kind, fault)
    r = run(monkeypatch, kind)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("kind", ["solar", "lm"])
def test_dropped_fold_fails_the_fold_gap(monkeypatch, kind):
    """A fold that leaves the model as it was reads about 1 on the window's
    own folds, in the program and in the reference put in its place."""
    faults.plant(monkeypatch, kind, "dropped_fold")
    r = run(monkeypatch, kind)
    assert r["checks"]["fold_gap"]["value"] >= 0.99, r["checks"]


def test_trace_reader_needs_only_device_types():
    """The device trace is read from each event's device type, name and
    times, which every torch 2 build's profiler events carry: operations
    on the card apart from the host's CUDA calls, their union as busy
    time, the longest idle gap named by the call that covered it."""
    from torch.autograd import DeviceType

    class Event:
        def __init__(self, name, start_us, dur_us, device):
            self.args = (name, start_us, dur_us, device)

        def name(self):
            return self.args[0]

        def start_us(self):
            return self.args[1]

        def duration_us(self):
            return self.args[2]

        def device_type(self):
            return self.args[3]

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [Event("k1", 0, 10, cuda), Event("cudaLaunchKernel", 0, 2, cpu),
              Event("k2", 5, 10, cuda), Event("Memcpy HtoD", 40, 5, cuda),
              Event("cudaStreamSynchronize", 16, 30, cpu),
              Event("aten::mm", 0, 1, cpu)]
    dt = harness.DeviceTrace.__new__(harness.DeviceTrace)
    dt.ops, dt.calls = [], []
    dt.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    dt._read()
    assert [n for n, _, _ in dt.ops] == ["k1", "k2", "Memcpy HtoD"]
    assert [n for n, _, _ in dt.calls] == ["cudaLaunchKernel",
                                            "cudaStreamSynchronize"]
    assert dt.busy_s() == pytest.approx(20e-6)
    gaps = dt.breakdown()["idle_gaps"]
    assert gaps == [["cudaStreamSynchronize before Memcpy HtoD",
                     pytest.approx(25e-6)]]
