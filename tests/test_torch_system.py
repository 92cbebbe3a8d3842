"""The solar run end to end in both packages, and the port's isolation from
JAX.

``run_fedccl_solar`` runs on the CPU in the JAX package and in the port
from the same seed and the same JAX-initialised parameters
(``scripts/torch_parity.py``, which also prints the gap).  Clusters and
the asynchronous schedule's stats depend only on numpy draws and must be
equal; every Table II and §IV.E entry must agree within 1e-3 percentage
points (the port's CPU route is the kernels' plain versions).
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.solar_lstm import SolarLSTMConfig
from repro_torch.core.fedccl import FedCCL, FedCCLConfig
from repro_torch.models.lstm import SolarForecaster
from repro_torch.training.fed_solar import run_fedccl_solar

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from scripts.torch_parity import SMALL, solar_parity  # noqa: E402

PORT = REPO / "src" / "repro_torch"
TABLE_PP = 1e-3          # Table II / §IV.E agreement, percentage points


def test_solar_run_matches_jax_end_to_end():
    ref, got, gap = solar_parity(**SMALL)
    assert got["clusters"] == ref["clusters"]
    assert got["async_stats"] == ref["async_stats"]
    assert got["privacy"] == ref["privacy"]
    assert got["config"] == ref["config"]
    for table in ("table2", "independent"):
        assert got[table].keys() == ref[table].keys()
        for col in ref[table]:
            assert got[table][col].keys() == ref[table][col].keys()
            assert all(np.isfinite(v) for v in got[table][col].values())
    assert gap <= TABLE_PP
    np.testing.assert_allclose(got["fig4_example"]["predicted"],
                               ref["fig4_example"]["predicted"], atol=1e-5)


# ------------------------------------------------------------- no JAX
def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imports(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.training.fed_solar\n"
            "import repro_torch.kernels.build\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ------------------------------------------------------------- no fallback
def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fedccl_solar(n_sites=2, n_days=9, rounds=1, hidden=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedCCL(FedCCLConfig(), {"w": torch.zeros(2)}, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolarForecaster(SolarLSTMConfig(hidden_size=4)).init(
            torch.Generator().manual_seed(0))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(alone, tmp_path):
    script = REPO / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    # no visible card in the first case; no package beside it in the second
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if not alone:
        env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
