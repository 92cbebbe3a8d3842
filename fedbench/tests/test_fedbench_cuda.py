"""Each cell at its own size on the card: a window of ``run_seconds`` (a
shorter one can hold no fold of the LM cell) comes out correct,
and the control (the reference in the configuration's
``control_precision``, put in the program's place) and the half-batch
fault planted in it fail at least one of the cell's numbers; a fold that
leaves the model as it was, planted in the program, fails ``fold_gap`` on
the window's own folds.  Marked
``cuda``; skips where there is no card.  On the H100:

    python -m pytest -q -m cuda fedbench/tests/test_fedbench_cuda.py
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)]

from fedbench import checks, harness  # noqa: E402

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # as fedbench/run.py runs every cell: the LM cell's 70+ GiB fragment
    # fixed segments
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    return torch.device("cuda", 0)


def window(cell, device, seed):
    from fedbench.reference.precision import exact_matmuls

    exact_matmuls()
    _, work, conf = harness.cell_spec(cell)
    run = harness.driver(conf["driver"]).Cell(conf, work, seed, device,
                                              False)
    run.setup()
    run.window(harness.benchmark()["run_seconds"])
    return run, work, conf


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_control_and_fault_on_card(card, cell):
    run, work, conf = window(cell, card, 2 ** 31 + 99)
    low = conf["control_precision"]
    got = checks.readings(run, (checks.PROGRAM, low, checks.HALF_BATCH))
    limits = work["limits"]
    assert all(got[checks.PROGRAM][k] <= v for k, v in limits.items()), got
    for kind in (low, checks.HALF_BATCH):
        assert any(got[kind][k] > limits[k] for k in got[kind]), (kind, got)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_dropped_fold_on_card(card, monkeypatch, cell):
    import faults

    faults.fold(monkeypatch, "dropped_fold")
    run, work, _ = window(cell, card, 2 ** 31 + 101)
    got = checks.readings(run, (checks.PROGRAM,))[checks.PROGRAM]
    print(f"{cell} dropped fold: {got}")
    assert got["fold_gap"] > work["limits"]["fold_gap"], got
