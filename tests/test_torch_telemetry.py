"""Telemetry across the port's store tiers, its workers and the wire, held
against the reference's on the CPU.

* The reference's telemetry-parity schedule
  (``tests/test_store_equivalence.py``: 40 updates, 5 cluster keys,
  max_coalesce 5) through the port's flat, sharded, in-process and TCP
  stores: each gives the JAX flat store's ``staleness_at_fold`` histogram
  and one submit and one enqueue event per update, and the JAX store of
  its own kind's ``coalesce_batch``, ``queue_depth`` and ``submit_batch``
  histograms (the TCP store is held against the JAX in-process store: the
  parent's logic is the same whatever carries the frames).
* ``FedCCL(telemetry=True)`` under the sim, on the scalar fleet (flat and
  in-process workers) and on solar at hidden 4: the reference's report
  keys but the fold route's name, and equal histograms where they do not
  depend on time.
* Mixed fleets: a JAX parent over torch shard servers and a torch parent
  over JAX ones pull one site per worker by ``obsdump``.
* A sampled submit's trace id rides the frame into a torch server and
  comes back on its ``worker.fold`` event.

The loopback servers (two of the port's on the CPU, two of the
reference's) start once for this file; each store connection re-seeds
them.
"""

import functools
import pathlib
import signal
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import store as jstore
from repro.core import transport as jtransport
from repro.core.fedccl import ClusterSpaceConfig as JaxSpace
from repro.core.fedccl import FedCCL as JaxFedCCL
from repro.core.fedccl import FedCCLConfig as JaxFedCCLConfig
from repro.core.protocol import ClientSpec as JaxClientSpec
from repro.obs.export import merged_metrics as jmerged
from repro.obs.record import Telemetry as JaxTelemetry
from repro.training import fed_solar as jax_fed_solar
from repro_torch.core import aggregation as agg
from repro_torch.core import store as tstore
from repro_torch.core import transport
from repro_torch.core.fedccl import ClusterSpaceConfig, FedCCL, FedCCLConfig
from repro_torch.core.protocol import ClientSpec
from repro_torch.obs.export import merged_metrics
from repro_torch.obs.record import Telemetry
from repro_torch.training import fed_solar as torch_fed_solar

from test_torch_federation import scalar_train_fn, specs_for

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from scripts.torch_parity import SMALL, solar_parity  # noqa: E402

GLOBAL = tstore.GLOBAL_KEY
KEYS = [f"loc:{i}" for i in range(5)]
DETERMINISTIC = ("staleness_at_fold", "coalesce_batch", "queue_depth",
                 "submit_batch")
SPACE = dict(eps=100.0, min_samples=2, metric="haversine")


@pytest.fixture
def deadline():
    """Fail a test that talks to server processes after 120 s instead of
    letting it hang the run."""
    def expire(signum, frame):
        raise TimeoutError("the test's 120 s deadline passed")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def loopback():
    """(torch hosts, JAX hosts): two servers of each package on loopback
    ephemeral ports, one torch thread each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with transport.LoopbackShardServers(2, device="cpu",
                                            startup_timeout=90.0) as ts, \
                jtransport.LoopbackShardServers(2, startup_timeout=90.0) \
                as js:
            yield ts.hosts, js.hosts


# ------------------------------------------------------ the parity schedule
def make_schedule(rng, n_updates=40, fresh_frac=0.2):
    """The reference's ``make_schedule`` over [global] + KEYS, as numpy
    trees: (model, tree, samples, round)."""
    models = [GLOBAL] + KEYS
    counts = {m: 0 for m in models}
    events = []
    for _ in range(n_updates):
        m = models[int(rng.integers(len(models)))]
        s = int(rng.integers(1, 300))
        fresh = rng.random() < fresh_frac
        rnd = counts[m] + 1 if fresh else 1
        events.append((m, {"a": rng.standard_normal((4, 3)).astype(np.float32),
                           "b": rng.standard_normal(5).astype(np.float32)},
                       s, rnd))
        counts[m] += 1
    return events


def replay(store, events, port, drain_seed, many):
    """Feed the stream into a store, draining at seeded random points; with
    ``many`` each run of consecutive updates of one model goes in by one
    ``submit_many``."""
    tree, meta, delta = ((lambda t: {k: torch.from_numpy(v.copy())
                                     for k, v in t.items()},
                          agg.ModelMeta, agg.UpdateDelta) if port else
                         (lambda t: {k: jnp.asarray(v) for k, v in t.items()},
                          jagg.ModelMeta, jagg.UpdateDelta))
    lk = lambda m: ("global", None) if m == GLOBAL else ("cluster", m)
    drain_rng = np.random.default_rng(drain_seed)

    def maybe_drain(m):
        if drain_rng.random() < 0.3:
            if drain_rng.random() < 0.5:
                store.drain(*lk(m))
            else:
                store.drain_all()

    if many:
        runs = []
        for ev in events:
            if runs and runs[-1][0][0] == ev[0]:
                runs[-1].append(ev)
            else:
                runs.append([ev])
        for run in runs:
            store.submit_many(*lk(run[0][0]), [
                (tree(t), meta(s, 1, r), delta(s, 1, 1))
                for _, t, s, r in run])
            maybe_drain(run[0][0])
    else:
        for m, t, s, r in events:
            store.handle_model_update(*lk(m), tree(t), meta(s, 1, r),
                                      delta(s, 1, 1))
            maybe_drain(m)
    store.drain_all()


def build(port, kind, init, hosts):
    kw = dict(batch_aggregation=True, max_coalesce=5)
    if port:
        pkg, cfg = tstore, agg.AggregationConfig(sequential_fast_path=False)
        tel, init = Telemetry(), {k: torch.from_numpy(v.copy())
                                  for k, v in init.items()}
        kw.update(agg_cfg=cfg, telemetry=tel)
        dev = dict(device="cpu")
    else:
        pkg = jstore
        kw.update(agg_cfg=jagg.AggregationConfig(sequential_fast_path=False),
                  telemetry=JaxTelemetry())
        init = {k: jnp.asarray(v) for k, v in init.items()}
        dev = {}
    if kind == "flat":
        return pkg.ModelStore(init, KEYS, **kw)
    if kind == "sharded":
        return pkg.ShardedModelStore(init, KEYS, n_shards=4, **kw)
    if kind == "inprocess" or (kind == "tcp" and not port):
        return pkg.ProcessShardedModelStore(init, KEYS, n_shards=2,
                                            inprocess=True, **kw, **dev)
    return pkg.ProcessShardedModelStore(init, KEYS, server_hosts=hosts,
                                        drain_timeout_s=60.0, **kw, **dev)


def observed(store, port):
    dump = store.telemetry_dump()          # before close: obsdump needs
    if hasattr(store, "close"):            # live workers
        store.close()
    merged = (merged_metrics if port else jmerged)(dump)["histograms"]
    names = [ev[2] for site in dump["sites"] for ev in site["events"]]
    return dump, {name: merged.get(name) for name in DETERMINISTIC}, names


@pytest.mark.parametrize("many", [False, True], ids=["single", "many"])
@pytest.mark.parametrize("kind", ["flat", "sharded", "inprocess", "tcp"])
def test_parity_schedule_equals_reference(kind, many, loopback, deadline):
    rng = np.random.default_rng(42)
    init = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    events = make_schedule(rng)
    ref_flat = build(False, "flat", init, None)
    replay(ref_flat, events, False, 10, many)
    _, flat_hists, _ = observed(ref_flat, False)
    ref = build(False, kind, init, None)
    replay(ref, events, False, 11, many)
    _, ref_hists, ref_names = observed(ref, False)
    store = build(True, kind, init, loopback[0])
    replay(store, events, True, 11, many)
    dump, hists, names = observed(store, True)
    # one staleness observation per update, the same on every topology
    assert flat_hists["staleness_at_fold"]["count"] == len(events)
    assert hists["staleness_at_fold"] == flat_hists["staleness_at_fold"]
    assert hists == ref_hists
    for name in ("submit", "enqueue", "submit_many", "fold", "merge",
                 "worker.fold"):
        assert names.count(name) == ref_names.count(name), name
    if not many:
        assert names.count("submit") == names.count("enqueue") == len(events)
    else:
        assert hists["submit_batch"]["sum"] == len(events)
    n_sites = 1 if kind in ("flat", "sharded") else 3
    assert [s["site"] for s in dump["sites"]][:1] == ["parent"]
    assert len(dump["sites"]) == n_sites
    assert [s["site"] for s in dump["sites"][1:]] == \
        [f"shard-{i}" for i in range(n_sites - 1)]


# ----------------------------------------------------------------- FedCCL
def facade_pair(seed=5, **kw):
    fed = FedCCL(FedCCLConfig(spaces=(ClusterSpaceConfig("loc", **SPACE),),
                              ewc_lambda=0.05, seed=seed, **kw),
                 {"w": torch.zeros(())}, scalar_train_fn, device="cpu")
    jfed = JaxFedCCL(JaxFedCCLConfig(spaces=(JaxSpace("loc", **SPACE),),
                                     ewc_lambda=0.05, seed=seed, **kw),
                     {"w": jnp.zeros(())}, scalar_train_fn)
    assert fed.setup(specs_for(ClientSpec, seed)) == \
        jfed.setup(specs_for(JaxClientSpec, seed))
    return fed, jfed


def assert_reports_agree(rep, jrep):
    """The reference's report keys and values, but the timings; the fold
    route's name is ``host`` on the CPU in both packages."""
    assert set(rep) == set(jrep)
    assert rep["sites"] == jrep["sites"]
    assert rep["dropped_events"] == jrep["dropped_events"] == 0
    assert rep["counters"] == jrep["counters"]
    assert set(rep["histograms"]) == set(jrep["histograms"])
    for name in DETERMINISTIC:
        assert rep["histograms"].get(name) == jrep["histograms"].get(name)
    for name, h in rep["histograms"].items():
        assert h["count"] == jrep["histograms"][name]["count"], name


@pytest.mark.parametrize("option", [{}, {"server_processes": 2}],
                         ids=["flat", "inprocess"])
def test_fedccl_telemetry_sim_matches_reference(option, tmp_path):
    kw = dict(telemetry=True, batch_aggregation=True, max_coalesce=3,
              **option)
    fed, jfed = facade_pair(**kw)
    off, _ = facade_pair(**dict(kw, telemetry=False))
    assert fed.run(rounds=3) == jfed.run(rounds=3) == off.run(rounds=3)
    rep, jrep = fed.metrics_report("json"), jfed.metrics_report("json")
    assert_reports_agree(rep, jrep)
    assert rep["histograms"]["staleness_at_fold"]["count"] == \
        fed.store.n_drained
    # every line of the page is a TYPE comment or a sample, and the page
    # declares the reference's metric families (bucket lines follow the
    # timings; the obsdump pulls move the wire gauges)
    families = []
    for text in (fed.metrics_report("prometheus"),
                 jfed.metrics_report("prometheus")):
        lines = text.splitlines()
        for line in lines:
            assert line.startswith("# TYPE fedccl_") or (
                line.startswith("fedccl_") and len(line.split(" ")) == 2)
        families.append([line for line in lines if line.startswith("#")])
    assert families[0] == families[1]
    assert "# TYPE fedccl_staleness_at_fold histogram" in families[0]
    with pytest.raises(ValueError, match="metrics format"):
        fed.metrics_report("xml")
    fed.write_trace(tmp_path / "t.json")
    events = [e for e in __import__("json").loads(
        (tmp_path / "t.json").read_text())["traceEvents"] if e["ph"] == "X"]
    assert sum(e["name"] == "client.round" for e in events) == \
        len(fed.clients) * 3
    for f in (fed, jfed, off):
        f.shutdown()


def test_solar_telemetry_matches_reference(monkeypatch):
    """The solar run at hidden 4, batched, telemetry on in both packages:
    the same report (clusters, stats, Table II within 1e-3 pp) as with it
    off, and the same deterministic histograms."""
    made = {}
    for name, mod in (("ref", jax_fed_solar), ("port", torch_fed_solar)):
        monkeypatch.setattr(mod, "FedCCLConfig", functools.partial(
            mod.FedCCLConfig, telemetry=True, batch_aggregation=True,
            max_coalesce=8))
        cls = mod.FedCCL

        def capture(*a, _cls=cls, _name=name, **kw):
            made[_name] = _cls(*a, **kw)
            return made[_name]
        monkeypatch.setattr(mod, "FedCCL", capture)
    ref, got, gap = solar_parity(**dict(SMALL, hidden=4, epochs=1))
    assert got["clusters"] == ref["clusters"]
    assert got["async_stats"] == ref["async_stats"]
    assert gap <= 1e-3
    rep, jrep = (made[k].metrics_report("json") for k in ("port", "ref"))
    assert_reports_agree(rep, jrep)
    assert rep["histograms"]["drain_fold_ns_host"]["count"] > 0


def test_fedccl_telemetry_off_has_no_sites():
    fed, _ = facade_pair()
    assert fed.store.telemetry is None
    assert fed.metrics_report("json")["sites"] == []


# ----------------------------------------------------------- mixed fleets
def mixed_run(parent, hosts, batched):
    """A store of ``parent``'s package over ``hosts``, the parity schedule
    through it: (dump, merged histograms, names)."""
    rng = np.random.default_rng(7)
    init = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    events = make_schedule(rng, n_updates=24)
    port = parent == "torch"
    pkg = tstore if port else jstore
    tree = ((lambda t: {k: torch.from_numpy(v.copy()) for k, v in t.items()})
            if port else (lambda t: {k: jnp.asarray(v) for k, v in t.items()}))
    kw = dict(batch_aggregation=batched, max_coalesce=5,
              telemetry=Telemetry() if port else JaxTelemetry(),
              drain_timeout_s=60.0)
    if port:
        kw["device"] = "cpu"
    store = pkg.ProcessShardedModelStore(tree(init), KEYS, server_hosts=hosts,
                                         **kw)
    replay(store, events, port, 3, many=False)
    return observed(store, port)


@pytest.mark.parametrize("parent", ["jax", "torch"])
def test_mixed_fleet_pulls_worker_sites(parent, loopback, deadline):
    """A JAX parent over torch servers and a torch parent over JAX ones:
    one site per worker, whose folds the parent's merge counts; the same
    histograms as the parent over its own package's servers."""
    torch_hosts, jax_hosts = loopback
    other, own = ((torch_hosts, jax_hosts) if parent == "jax"
                  else (jax_hosts, torch_hosts))
    dump, hists, names = mixed_run(parent, other, batched=True)
    _, own_hists, own_names = mixed_run(parent, own, batched=True)
    assert [s["site"] for s in dump["sites"]] == \
        ["parent", "shard-0", "shard-1"]
    assert hists == own_hists
    assert names.count("worker.fold") == own_names.count("worker.fold") > 0
    for site in dump["sites"][1:]:
        assert site["metrics"]["histograms"]["staleness_at_fold"]["count"]


@pytest.mark.parametrize("parent", ["jax", "torch"])
def test_sampled_trace_reaches_a_torch_server_fold(parent, loopback,
                                                   deadline):
    """Unbatched, each submit drains inside its trace scope: the drain's
    frame carries the trace id into the torch server, which restores it
    around the dispatch, so its ``worker.fold`` event carries the id the
    parent's ``submit`` minted."""
    dump, _, _ = mixed_run(parent, loopback[0], batched=False)
    submits = {ev[3] for ev in dump["sites"][0]["events"]
               if ev[2] == "submit"}
    folds = [ev for site in dump["sites"][1:] for ev in site["events"]
             if ev[2] == "worker.fold"]
    assert folds and 0 not in submits
    assert {ev[3] for ev in folds} <= submits
    assert len({ev[3] for ev in folds}) > 1
