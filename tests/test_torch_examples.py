"""``examples/solar_forecasting_torch.py`` against
``examples/solar_forecasting.py``: for the same command line both make the
same ``run_fedccl_solar`` call (the torch example adds only its device,
CUDA unless ``--device`` says otherwise), and the torch example prints the
same sections and writes ``solar_report.json``.  Both packages'
``run_fedccl_solar`` are replaced by a recorder, so nothing trains."""

import importlib.util
import json
import pathlib
import sys

import pytest
import torch

import repro.training.fed_solar as jax_fed_solar
import repro_torch.training.fed_solar as torch_fed_solar

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
ROW = {"mean_error_power": 10.0, "mean_error_energy": 12.0,
       "mean_error_day_power": 11.0}
REPORT = {"table2": {"FederatedGlobal": ROW},
          "independent": {"FederatedGlobal": ROW},
          "async_stats": {"updates": 24},
          "privacy": {"dp": {"enabled": True},
                      "secure_agg": {"enabled": True, "rounds": 6,
                                     "dropout_recoveries": 0},
                      "per_client": {"site-0": {"epsilon": 73.0,
                                                "delta": 1e-5,
                                                "steps": 6}}}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorded_call(monkeypatch, package, example, argv):
    calls = []

    def record(**kw):
        calls.append(kw)
        return REPORT

    monkeypatch.setattr(package, "run_fedccl_solar", record)
    monkeypatch.setattr(sys, "argv", [f"{example}.py", *argv])
    load(example).main()
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("argv", [
    [], ["--full"],
    ["--dp-clip", "5", "--dp-noise-multiplier", "0.3", "--secure-agg"]],
    ids=["default", "full", "privacy"])
def test_torch_example_makes_the_reference_call(argv, monkeypatch, tmp_path,
                                                capsys):
    out = ["--out", str(tmp_path / "jax")]
    want = recorded_call(monkeypatch, jax_fed_solar, "solar_forecasting",
                         argv + out)
    jax_text = capsys.readouterr().out
    tout = ["--out", str(tmp_path / "torch")]
    got = recorded_call(monkeypatch, torch_fed_solar,
                        "solar_forecasting_torch", argv + tout)
    torch_text = capsys.readouterr().out
    assert got.pop("device") == "cuda"
    assert got == want
    # the same sections in the same order, the report written
    assert torch_text.replace(str(tmp_path / "torch"), "") == \
        jax_text.replace(str(tmp_path / "jax"), "")
    assert "=== Table II analog ===" in torch_text
    written = json.loads((tmp_path / "torch" / "solar_report.json")
                         .read_text())
    assert written == json.loads((tmp_path / "jax" / "solar_report.json")
                                 .read_text())


def test_torch_example_takes_a_device(monkeypatch, tmp_path):
    got = recorded_call(monkeypatch, torch_fed_solar,
                        "solar_forecasting_torch",
                        ["--device", "cpu", "--out", str(tmp_path)])
    assert got["device"] == "cpu"
    assert (tmp_path / "solar_report.json").is_file()


def test_torch_example_imports_nothing_of_the_reference():
    text = (EXAMPLES / "solar_forecasting_torch.py").read_text()
    assert "import repro." not in text and "from repro." not in text
    assert "jax" not in text


# ------------------------------------------------ examples/serve_batched*.py
def test_serve_batched_torch_matches_the_reference_example(monkeypatch,
                                                           capsys):
    """``examples/serve_batched_torch.py --device cpu`` against
    ``examples/serve_batched.py`` from the same weights (each of the JAX
    example's draws handed to the port through ``params_from_numpy``): the
    same archs, prompts and greedy tokens, ragged requests included, and
    the same lines but for their timings."""
    import re

    import jax
    import numpy as np

    import repro.models.model as jax_model
    import repro_torch.models.model as torch_model
    from repro_torch.utils.tree import params_from_numpy

    drawn = {}
    jax_init = jax_model.LanguageModel.init

    def record(self, key, dtype=None):
        drawn.setdefault(self.cfg.name, []).append(
            jax.jit(lambda k: jax_init(self, k, dtype))(key))
        return drawn[self.cfg.name][-1]

    def bridged(self, generator, device=None, dtype=None):
        return params_from_numpy(jax.tree.map(
            np.asarray, drawn[self.cfg.name].pop(0)), device)

    monkeypatch.setattr(jax_model.LanguageModel, "init", record)
    load("serve_batched").main()
    jax_text = capsys.readouterr().out
    monkeypatch.setattr(torch_model.LanguageModel, "init", bridged)
    got = load("serve_batched_torch").main(["--device", "cpu"])
    torch_text = capsys.readouterr().out

    def untimed(text):
        return re.sub(r"in +[\d.]+s \( *[\d.]+ tok/s\)", "", text)

    assert untimed(torch_text) == untimed(jax_text)
    assert list(got) == load("serve_batched").ARCHS + ["ragged"]
    assert all(v.shape == (4, 48) for k, v in got.items() if k != "ragged")
    assert got["ragged"].shape == (3, 16)


def test_serve_batched_torch_imports_nothing_of_the_reference():
    text = (EXAMPLES / "serve_batched_torch.py").read_text()
    assert "import repro." not in text and "from repro." not in text
    assert "jax" not in text
