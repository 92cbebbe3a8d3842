"""The port's threaded runtime (``core/runtime_threaded.py``) against the
JAX package's ``AsyncThreadedRuntime``, and the thread safety of the
kernels' shared state (``kernels/build.py``).

The runs are ports of the reference's threaded tests
(``tests/test_protocol_store.py``, ``tests/test_batched_aggregation.py``,
``tests/test_privacy.py``) on the scalar ``train_fn`` and fleet of
``tests/test_torch_federation.py``.  Thread interleaving is not
deterministic, so the accounting (rounds, samples, updates, secure rounds,
pending queues) is held exactly and the folded values within a tolerance:
atol 1e-5 for the secure runs (a secure round folds a fixed member set, in
the order the threads submitted), as ``tests/test_torch_privacy.py`` holds
the sim runtime.

The kernels' launch counters and kept scratch are exercised by sending CPU
tensors down the CUDA route with a stand-in library whose launch
functions return 0, as ``tests/test_torch_lstm_seq.py`` reads the fold's
tables back.
"""

import ctypes
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.solar_lstm import SolarLSTMConfig as JaxSolarConfig
from repro.core.fedccl import ClusterSpaceConfig as JaxSpace
from repro.core.fedccl import FedCCL as JaxFedCCL
from repro.core.fedccl import FedCCLConfig as JaxFedCCLConfig
from repro.core.protocol import ClientSpec as JaxClientSpec
from repro.models.lstm import SolarForecaster as JaxForecaster
from repro.training.fed_solar import make_solar_fns as jax_solar_fns
from repro.training.fed_solar import make_train_fn as jax_train_fn
from repro_torch.configs.solar_lstm import SolarLSTMConfig
from repro_torch.core import aggregation as agg
from repro_torch.core.fedccl import ClusterSpaceConfig, FedCCL, FedCCLConfig
from repro_torch.core.protocol import ClientSpec
from repro_torch.core.runtime_threaded import AsyncThreadedRuntime
from repro_torch.core.store import ModelStore
from repro_torch.data.solar import generate_fleet
from repro_torch.data.windows import make_windows, split_windows
from repro_torch.kernels import build, launch_counts, reset_launch_counts
from repro_torch.kernels.dp_clip_noise import ops as dp_ops
from repro_torch.kernels.ewc_update import ops as ewc_ops
from repro_torch.kernels.fedavg_agg import ops as agg_ops
from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.models.lstm import SolarForecaster
from repro_torch.training.fed_solar import make_solar_fns, make_train_fn
from repro_torch.utils.tree import params_from_numpy, tree_leaves

from test_torch_federation import scalar_train_fn, specs_for

ATOL = 1e-5
SPACE = dict(eps=100.0, min_samples=2, metric="haversine")
N_CLIENTS = 6
# specs_for gives each group's clients 100, 110 and 120 samples
SAMPLES_A_ROUND = 2 * (100 + 110 + 120)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def threaded_fed(seed=5, **kw):
    fed = FedCCL(FedCCLConfig(spaces=(ClusterSpaceConfig("loc", **SPACE),),
                              ewc_lambda=0.05, seed=seed, runtime="threaded",
                              **kw),
                 {"w": torch.zeros(())}, scalar_train_fn, device="cpu")
    fed.setup(specs_for(ClientSpec, seed))
    return fed


def jax_threaded_fed(seed=5, **kw):
    jfed = JaxFedCCL(JaxFedCCLConfig(spaces=(JaxSpace("loc", **SPACE),),
                                     ewc_lambda=0.05, seed=seed,
                                     runtime="threaded", **kw),
                     {"w": jnp.zeros(())}, scalar_train_fn)
    jfed.setup(specs_for(JaxClientSpec, seed))
    return jfed


def levels(fed):
    return [("global", None)] + [("cluster", k)
                                 for k in sorted(fed.store.keys())]


def assert_meta_exact(fed, jfed):
    assert sorted(fed.store.keys()) == sorted(jfed.store.keys())
    for level, key in levels(fed):
        m, jm = fed.store.meta(level, key), jfed.store.meta(level, key)
        assert (m.samples_learned, m.epochs_learned, m.round) == \
            (jm.samples_learned, jm.epochs_learned, jm.round)


# --------------------------------------------------------- the scalar fed
def test_threaded_runtime_consistency():
    """Every update serialized by the model lock: exact rounds and sample
    counts, as the reference's and in its run."""
    fed, jfed = threaded_fed(), jax_threaded_fed()
    stats = fed.run(rounds=2)
    jfed.run(rounds=2)
    assert fed.store.meta("global").round == N_CLIENTS * 2
    assert fed.store.meta("global").samples_learned == 2 * SAMPLES_A_ROUND
    assert stats["updates"] == N_CLIENTS * 2 * 2      # a cluster + global
    assert stats["drain_timeouts"] == 0
    assert_meta_exact(fed, jfed)


def test_threaded_batched_runtime_accounting():
    fed = threaded_fed(batch_aggregation=True, max_coalesce=8)
    jfed = jax_threaded_fed(batch_aggregation=True, max_coalesce=8)
    stats, jstats = fed.run(rounds=2), jfed.run(rounds=2)
    assert stats["updates"] == jstats["updates"] == N_CLIENTS * 2 * 2
    assert stats["enqueued"] == stats["updates"]
    assert fed.store.meta("global").round == N_CLIENTS * 2
    assert fed.store.meta("global").samples_learned == 2 * SAMPLES_A_ROUND
    for level, key in levels(fed):
        assert fed.store.pending_depth(level, key) == 0
    assert stats["coalesce_factor"] >= 1.0
    assert stats["drain_timeouts"] == 0
    assert_meta_exact(fed, jfed)


def test_threaded_contention_no_lost_updates():
    """Many writer threads enqueue against one model while a drain thread
    sweeps: every update is folded exactly once (n_updates accounting and
    sample-mass conservation)."""
    store = ModelStore({"w": torch.zeros(())}, batch_aggregation=True,
                       max_coalesce=8)
    n_threads, per_thread = 8, 25

    def writer(t):
        rng = np.random.default_rng(t)
        for _ in range(per_thread):
            s = int(rng.integers(1, 100))
            store.handle_model_update(
                "global", None,
                {"w": torch.tensor(rng.uniform(-1, 1), dtype=torch.float32)},
                agg.ModelMeta(s, 1, 0), agg.UpdateDelta(s, 1, 1))

    stop = threading.Event()

    def drainer():
        while not stop.is_set():
            store.drain_all()
        store.drain_all()

    writers = [threading.Thread(target=writer, args=(t,))
               for t in range(n_threads)]
    d = threading.Thread(target=drainer)
    d.start()
    for t in writers:
        t.start()
    for t in writers:
        t.join()
    stop.set()
    d.join()

    total = n_threads * per_thread
    assert store.n_enqueued == total
    assert store.n_updates == total          # nothing lost, nothing doubled
    assert store.pending_depth("global") == 0
    expect_samples = 0
    for t in range(n_threads):
        rng = np.random.default_rng(t)
        for _ in range(per_thread):
            expect_samples += int(rng.integers(1, 100))
            rng.uniform(-1, 1)
    assert store.meta("global").samples_learned == expect_samples
    assert store.meta("global").round == total
    assert -1.0 <= float(store.params("global")["w"]) <= 1.0


def test_threaded_secure_full_round_drains():
    """Masked against unmasked in the port, and against the JAX package's
    threaded secure run of the same seed."""
    fm = threaded_fed(secure_agg=True)
    stats = fm.run(rounds=2)
    assert stats["updates"] == N_CLIENTS * 2 * 2
    assert stats["secure_rounds"] == 2 * (1 + len(fm.store.keys()))
    assert stats["secure_recoveries"] == 0
    assert fm.store.meta("global").round == 12
    fu = threaded_fed(secure_agg=True, secure_mask_scale=0.0)
    fu.run(rounds=2)
    jfed = jax_threaded_fed(secure_agg=True)
    jstats = jfed.run(rounds=2)
    assert stats == jstats                    # full rounds: deterministic
    assert_meta_exact(fm, jfed)
    for level, key in levels(fm):
        w = float(fm.store.params(level, key)["w"])
        np.testing.assert_allclose(
            w, float(fu.store.params(level, key)["w"]), rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            w, float(jfed.store.params(level, key)["w"]), rtol=0, atol=ATOL)


def test_threaded_secure_round_ids_never_repeat_across_runs():
    fed = threaded_fed(seed=9, secure_agg=True)
    fed.run(rounds=2)
    assert fed.store.secure_round_offset == 2
    fed.run(rounds=1)
    assert fed.store.secure_round_offset == 3
    assert fed.store.meta("global").round == N_CLIENTS * 3


def test_client_error_surfaces_from_run():
    def failing(params, dataset, rng, anchor):
        raise ValueError("client failed")

    for kw in ({}, {"batch_aggregation": True}, {"secure_agg": True}):
        fed = FedCCL(FedCCLConfig(spaces=(ClusterSpaceConfig("loc", **SPACE),),
                                  runtime="threaded", **kw),
                     {"w": torch.zeros(())}, failing, device="cpu")
        fed.setup(specs_for(ClientSpec, 5))
        with pytest.raises(ValueError, match="client failed"):
            fed.run(rounds=1)


def test_stuck_drain_worker_raises_within_join_timeout():
    """A drain worker that never returns: run() raises after the join
    timeout, and the store counts one drain timeout."""
    fed = threaded_fed(batch_aggregation=True, drain_timeout_s=0.3)
    release = threading.Event()

    def stuck():
        release.wait(30)
        return 0

    fed.store.drain_all = stuck
    t0 = time.perf_counter()
    try:
        with pytest.raises(RuntimeError, match="failed to stop within 0.3s"):
            fed.run(rounds=1)
        waited = time.perf_counter() - t0
    finally:
        release.set()
    assert fed.store.agg_stats()["drain_timeouts"] == 1
    assert waited < 15.0
    rt = AsyncThreadedRuntime(fed.clients, fed.store, 1, join_timeout=2.0)
    assert rt.join_timeout == 2.0 and rt.drain_poll_max == 0.008


def test_threaded_runtime_needs_a_device_or_a_card():
    """Without a GPU the entry point raises for device=None; it never
    falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError):
        FedCCL(FedCCLConfig(runtime="threaded"), {"w": torch.zeros(())},
               scalar_train_fn)


# ------------------------------------------------------- the solar fleet
def test_solar_threaded_secure_run_matches_jax():
    """Threaded secure aggregation with DP clipping (noise 0) at hidden 16,
    from JAX-initialised weights: the global and cluster models within the
    sim runtime's tolerance of JAX's threaded run."""
    fleet = generate_fleet(n_sites=4, n_days=9, seed=0)
    windows = {s.site_id: split_windows(make_windows(d), train_frac=0.8)[0]
               for s, d in fleet}
    jfc = JaxForecaster(JaxSolarConfig(hidden_size=16))
    init = jax.tree.map(np.asarray, jfc.init(jax.random.key(0)))
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=16))
    space = dict(eps=120.0, min_samples=2, metric="haversine")
    kw = dict(ewc_lambda=0.05, seed=3, runtime="threaded", secure_agg=True,
              dp_clip=1.0, dp_noise_multiplier=0.0)
    fed = FedCCL(FedCCLConfig(spaces=(ClusterSpaceConfig("loc", **space),),
                              **kw), params_from_numpy(init, "cpu"),
                 make_train_fn(make_solar_fns(fc, lr=1e-2)[0], epochs=1),
                 device="cpu")
    jfed = JaxFedCCL(JaxFedCCLConfig(spaces=(JaxSpace("loc", **space),),
                                     **kw), jax.tree.map(jnp.asarray, init),
                     jax_train_fn(jax_solar_fns(jfc, lr=1e-2)[0], epochs=1))
    rng = np.random.default_rng(0)
    speeds = [float(rng.uniform(0.5, 2.0)) for _ in fleet]
    assert fed.setup([ClientSpec(s.site_id, s.static_features,
                                 windows[s.site_id], speed=v)
                      for (s, _), v in zip(fleet, speeds, strict=True)]) == \
        jfed.setup([JaxClientSpec(s.site_id, s.static_features,
                                  windows[s.site_id], speed=v)
                    for (s, _), v in zip(fleet, speeds, strict=True)])
    stats, jstats = fed.run(rounds=2), jfed.run(rounds=2)
    assert stats == jstats
    assert stats["secure_rounds"] == 2 * (1 + len(fed.store.keys()))
    assert fed.privacy_report()["per_client"] == \
        jfed.privacy_report()["per_client"]
    assert_meta_exact(fed, jfed)
    for level, key in levels(fed):
        for g, w in zip(tree_leaves(fed.store.params(level, key)),
                        jax.tree.leaves(jfed.store.params(level, key)),
                        strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=ATOL)


# ------------------------------------------- the kernels' shared state
class FakeLibrary:
    """Launch functions that return 0 (success) and launch nothing."""

    def __getattr__(self, name):
        if name == "fedavg_leaf_fold_size":
            return lambda: ctypes.sizeof(agg_ops.LeafFold)
        return lambda *args: 0


@pytest.fixture
def cuda_route_on_cpu(monkeypatch):
    """CPU tensors down the wrappers' CUDA route, counted by
    ``build.count``, with fresh kept workspaces."""
    monkeypatch.setattr(build, "on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(build, "library", lambda: FakeLibrary())
    monkeypatch.setattr(build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(ewc_ops, "_workspaces", {})
    monkeypatch.setattr(dp_ops, "_workspaces", {})
    reset_launch_counts()
    yield
    reset_launch_counts()


def test_launch_counts_exact_under_16_threads(cuda_route_on_cpu):
    n_threads, calls = 16, 200
    g = torch.zeros(8)
    big = torch.zeros(dp_ops.CLUSTER_CAP + 1)       # the wide route's scratch
    trees = [{"a": torch.zeros(3), "b": torch.zeros(2)} for _ in range(2)]
    start = threading.Barrier(n_threads)
    errors = []

    def worker(i):
        try:
            start.wait()
            for k in range(calls):
                ewc_ops.ewc_penalty_grad_flat(0.1, g, g, g)
                dp_ops.privatize_flat(big if k % 50 == 0 else g,
                                      big if k % 50 == 0 else g, 1.0, 0.5)
                agg_ops.aggregate_pytrees(trees, [0.5, 0.5])
        except BaseException as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)         # switch threads as often as it can
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    counts = launch_counts()
    want = n_threads * calls
    assert counts["ewc_update"] == want
    assert counts["dp_clip_noise"] == want
    assert counts["fedavg_agg"] == want
    assert agg_ops.launches_leaves == want
    # one kept workspace each: a stream shares it, every thread found it
    assert list(ewc_ops._workspaces) == [(None, 0)]
    assert list(dp_ops._workspaces) == [(None, 0)]


def test_counters_and_workspaces_change_only_under_the_lock(
        cuda_route_on_cpu):
    """CPython seldom switches threads inside a counter's load, add and
    store, so a lost count is hard to provoke on demand; what is held here
    is that a wrapper's count (the cluster route, no workspace) and its
    first workspace (the wide route) each wait for ``build``'s lock."""
    small, big = torch.zeros(8), torch.zeros(dp_ops.CLUSTER_CAP + 1)
    for t, launched in ((small, 1), (big, 2)):
        done = threading.Event()

        def call(t=t, done=done):
            dp_ops.privatize_flat(t, t, 1.0, 0.5)
            done.set()

        with build._state_lock:
            worker = threading.Thread(target=call)
            worker.start()
            assert not done.wait(0.3)            # blocked on the lock
            assert dp_ops.launches == launched - 1
            assert not dp_ops._workspaces
        worker.join(10)
        assert done.is_set() and dp_ops.launches == launched
    assert list(dp_ops._workspaces) == [(None, 0)]


@pytest.mark.parametrize("scan", ["forward", "reverse"])
def test_sized_launches_wait_for_the_lock(cuda_route_on_cpu, scan):
    """The sequence scans' launchers set their kernel's shared-memory limit
    to the call's size and then launch; with the encoder's and the
    decoder's scans in two threads, one could lower the limit between the
    other's set and launch ("invalid argument" on the card).  What is held
    here is that a scan's launch waits for ``build``'s sized-launch lock."""
    t, b, i, h = 3, 2, 10, 128
    z = torch.zeros
    if scan == "forward":
        def call():
            lstm_ops.lstm_seq_fwd(z(t, b, i), z(b, h), z(b, h), z(i, 4 * h),
                                  z(h, 4 * h), z(4 * h))
    else:
        def call():
            lstm_ops.lstm_seq_bwd(z(t, b, h), z(b, h), z(b, h),
                                  z(t, b, 4 * h), z(t, b, h), z(b, h),
                                  z(h, 4 * h))
    done = threading.Event()

    def worker():
        call()
        done.set()

    with build._sized_lock:
        th = threading.Thread(target=worker)
        th.start()
        assert not done.wait(0.3)                # blocked on the lock
        assert lstm_ops.launches == 0
    th.join(10)
    assert done.is_set() and lstm_ops.launches == 1


def test_library_loads_once_under_concurrent_first_use(monkeypatch,
                                                        tmp_path):
    builds = []

    def fake_build():
        builds.append(threading.current_thread().name)
        time.sleep(0.05)                 # a slow build invites a race
        return tmp_path / "libkernels.so"

    class Loaded:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    loads = []

    def fake_cdll(path):
        loads.append(path)
        return Loaded()

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", fake_cdll)
    start = threading.Barrier(8)
    got = []

    def first_use():
        start.wait()
        got.append(build.library())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 8 and all(lib is got[0] for lib in got)
