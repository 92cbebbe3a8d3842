"""The port's launchers, in process on the CPU (``--device cpu``).

``launch.train``: reduced gemma-2b and mamba2-370m train with finite
losses on the CPU; ``--federated`` at a small fleet gives exactly the
report of ``run_fedccl_solar`` with the same arguments (one process: the
same ``PYTHONHASHSEED``).  ``launch.serve``: the greedy tokens equal
``ServeEngine.generate`` on the same parameters and prompts.  Without a
device the launchers take CUDA and raise where there is none.
"""

import json
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.launch import serve, train
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ServeEngine
from repro_torch.training.fed_solar import run_fedccl_solar

FLEET = dict(n_sites=3, n_days=9, rounds=1, seed=0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-370m"])
def test_train_launcher_runs_on_the_cpu(arch):
    argv = ["--arch", arch, "--steps", "3", "--batch", "2", "--seq", "16",
            "--device", "cpu"]
    state, losses = train.main(argv)
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert state.params["embed"].device.type == "cpu"


def test_federated_launcher_equals_run_fedccl_solar():
    argv = ["--federated", "--sites", str(FLEET["n_sites"]), "--days",
            str(FLEET["n_days"]), "--rounds", str(FLEET["rounds"]),
            "--seed", str(FLEET["seed"]), "--device", "cpu"]
    got = train.main(argv)
    want = run_fedccl_solar(**FLEET, device="cpu")
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)


def test_serve_launcher_equals_generate():
    argv = ["--batch", "2", "--prompt-len", "8", "--new-tokens", "6",
            "--device", "cpu"]
    out = serve.main(argv)
    cfg = reduced_for_smoke(get_config("gemma-2b"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = ServeEngine(model, params, max_len=8 + 6 + 1).generate(prompts, 6)
    assert out.shape == (2, 6)
    np.testing.assert_array_equal(out, want)


def test_serve_launcher_refuses_an_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_launchers_take_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main([])
