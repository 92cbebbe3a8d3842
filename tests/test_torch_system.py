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

from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.configs.solar_lstm import SolarLSTMConfig
from repro_torch.core.fedccl import FedCCL, FedCCLConfig
from repro_torch.core.protocol import Client, ClientSpec
from repro_torch.core.store import ModelStore
from repro_torch.models.lstm import SolarForecaster, build_forecaster
from repro_torch.models.model import build_model
from repro_torch.optim import sgd
from repro_torch.scenario import flash_crowd_burst, make_store, run_scenario
from repro_torch.training.fed_solar import run_fedccl_solar
from repro_torch.training.train_step import init_train_state
from repro_torch.utils.tree import tree_leaves

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from scripts.torch_parity import SMALL, solar_parity  # noqa: E402

PORT = REPO / "src" / "repro_torch"
TABLE_PP = 1e-3          # Table II / §IV.E agreement, percentage points


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
                         + [REPO / "chip_smoke.py"]
                         + sorted((REPO / "examples").glob("*_torch.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imports(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, mod)


CLOCK_READS = {"monotonic", "monotonic_ns", "time", "time_ns",
               "perf_counter", "perf_counter_ns"}


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_reads_clocks_only_through_obs_clock(path):
    """As the reference routes every clock read through ``repro.obs.clock``,
    the port reads clocks only through ``repro_torch.obs.clock``."""
    if path == PORT / "obs" / "clock.py":
        return
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in CLOCK_READS \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "time":
            raise AssertionError(f"{path}:{node.lineno}: time.{node.attr}")
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            assert not {a.name for a in node.names} & CLOCK_READS, path


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.training.fed_solar\n"
            "import repro_torch.kernels.build\n"
            "import repro_torch.obs, repro_torch.scenario\n"
            "import repro_torch.optim, repro_torch.training.train_step\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_obs_needs_no_torch():
    """The telemetry layer is stdlib-only, like the reference's: it imports
    with torch blocked too."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro', 'torch', 'numpy'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.obs\n"
            "from repro_torch.obs import metrics_json, Telemetry\n"
            "t = Telemetry()\n"
            "t.metrics.histogram('x').observe(3)\n"
            "print(metrics_json({'sites': [t.dump()]})['histograms']['x']"
            "['count'])\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1"


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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario(flash_crowd_burst(100, 2, n_clusters=2),
                     topology="single")
    for topology in ("single", "sharded", "process"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_store(topology, cluster_keys=["c0"])
    llm = build_model(reduced_for_smoke(get_config("mamba2-370m")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(llm, sgd(0.1), torch.Generator().manual_seed(0))


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


# ------------------------------------------------ item 5's two functions
def _scalar_train_fn(params, dataset, rng, anchor):
    """tests/test_protocol_store.py's scalar train_fn, in either package."""
    target, n = dataset
    w = params["w"]
    for _ in range(3):
        g = w - target
        if anchor is not None:
            g = g + anchor.lam * (w - anchor.anchor["w"])
        w = w - 0.3 * g
    return {"w": w}, n, 3


def test_client_full_round_matches_jax():
    import jax.numpy as jnp
    from repro.core.protocol import Client as JaxClient
    from repro.core.protocol import ClientSpec as JaxClientSpec
    from repro.core.store import ModelStore as JaxModelStore

    keys = ["loc:0", "loc:1"]

    def run(store, client):
        for _ in range(2):
            client.full_round(store)
        return store, client

    jstore, jclient = run(
        JaxModelStore({"w": jnp.zeros(())}, cluster_keys=keys),
        JaxClient(JaxClientSpec("a0", {}, (1.0, 50)), keys, _scalar_train_fn,
                  ewc_lambda=0.05, local_params={"w": jnp.zeros(())}))
    store, client = run(
        ModelStore({"w": torch.zeros(())}, cluster_keys=keys),
        Client(ClientSpec("a0", {}, (1.0, 50)), keys, _scalar_train_fn,
               ewc_lambda=0.05, local_params={"w": torch.zeros(())}))
    for level, key in [("global", None)] + [("cluster", k) for k in keys]:
        assert vars(store.meta(level, key)) == vars(jstore.meta(level, key))
        np.testing.assert_allclose(float(store.params(level, key)["w"]),
                                   float(jstore.params(level, key)["w"]),
                                   atol=1e-6)
    assert vars(client.local_meta) == vars(jclient.local_meta)
    np.testing.assert_allclose(float(client.local_params["w"]),
                               float(jclient.local_params["w"]), atol=1e-6)
    assert store.meta("global").round == 2


def test_build_forecaster_matches_jax():
    import jax
    from repro.configs.solar_lstm import SolarLSTMConfig as JaxSolarConfig
    from repro.models.lstm import build_forecaster as jax_build_forecaster

    for port_cfg, jax_cfg in ((None, None),
                              (SolarLSTMConfig(hidden_size=16),
                               JaxSolarConfig(hidden_size=16))):
        got, want = build_forecaster(port_cfg), jax_build_forecaster(jax_cfg)
        assert isinstance(got, SolarForecaster)
        assert repr(got.cfg) == repr(want.cfg)
        shapes = [tuple(x.shape) for x in tree_leaves(got.init(
            torch.Generator().manual_seed(0), "cpu"))]
        assert shapes == [tuple(x.shape) for x in jax.tree.leaves(
            want.init(jax.random.key(0)))]
