"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name.  CPU only; run from the repository root:

    python -m pytest -q fedbench/tests
"""

import io
import json
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from fedbench import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line_ok(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("item", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda x: x["name"])
def test_names_and_lines(item):
    assert NAME.match(item["name"])
    for key in ("why", "layer"):
        if key in item:
            assert line_ok(item[key])
    if item in BENCH["configs"]:
        assert line_ok(item["source"])
    if "unit" in item:
        assert UNIT.match(item["unit"])
        assert item["better"] in ("lower", "higher")


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith(BENCH["paths"][0] + "/")
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert (ROOT / "fedbench" / "drivers" / f"{data['driver']}.py").is_file()
    assert sorted(conf["reduced"]) == sorted(data["reduced"])
    assert len(conf["reduced"]) <= 16
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_and_metrics(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    entry, work, conf = harness.cell_spec(cell["name"], BENCH)
    assert work["config"] == cell["config"] == conf["name"]
    assert cell["traffic"] == work["name"]
    assert NAME.match(cell["traffic"])
    e2e = harness.cell_metrics(cell["name"], BENCH, trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = harness.cell_metrics(cell["name"], BENCH, trace=True)
    assert layer
    for m in e2e + layer:
        assert hasattr(harness.metric_reader(m["name"]), "read")
    for m in layer:
        assert m["moves"] in names
    assert set(work["limits"]) == {"loss_gap", "grad_gap", "change_gap",
                                   "fold_gap", "meta_mismatches"}
    assert work["limits"]["meta_mismatches"] == 0.0


def test_pairs_and_moves():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], m["layer"])
        for cell in m["workloads"]:
            assert cell in CELLS
            assert m["moves"] in {x["name"] for x in
                                  harness.cell_metrics(cell, BENCH, False)}
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


def test_check_budget_fits():
    n = 24
    total = (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("loaded,found", [
    (["repro"], ["repro"]), (["jax.numpy"], ["jax"]), (["jaxlib"], ["jaxlib"]),
    (["flax.linen"], ["flax"]), (["repro.core.store"], ["repro"]),
    (["repro_torch", "repro_torch.core"], []), (["reproduce"], [])])
def test_jax_check_by_whole_top_level_name(monkeypatch, loaded, found):
    fake = {k: v for k, v in sys.modules.items()
            if k.split(".")[0] not in harness.FORBIDDEN}
    for name in loaded:
        fake[name] = object()
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == found


def test_no_card_no_result(monkeypatch, capsys):
    """A measurement run without a card exits non-zero and prints no
    result line: it never falls back to the CPU."""
    import torch

    sys.path.insert(0, str(ROOT / "fedbench"))
    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", CELLS[0], "--seed", "3000000000",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert out.getvalue() == ""
