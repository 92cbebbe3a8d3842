"""The port's scenario engine (``repro_torch.scenario``) against the
reference's on the CPU.

Both engines draw the population, the participation and the client noise
from the same seeded numpy generator in the same order, so on the same
preset they must report the same run: ``submitted``, ``fetched``,
``population_peak``, the tick log, ``agg_stats()``, every SLO that is not
a timing, ε, the EWC kernel calls and season, and the telemetry
histograms that do not depend on time, exactly; final params and EWC
anchors within 1e-5 (the models are tensors in the port, numpy and JAX
in the reference).  The process and TCP topologies run on spawned CPU
workers and loopback CPU shard servers and are held against the
reference's thread-sharded run at the same shard count.
"""

import numpy as np
import pytest

from repro.scenario import PRESETS as JPRESETS
from repro.scenario import run_scenario as jrun
from repro_torch.core import transport
from repro_torch.scenario import (
    PRESETS,
    diurnal_churn,
    flash_crowd_burst,
    run_scenario,
)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ATOL = 1e-5
TIMING_SLOS = ("submit_p95_ns", "fetch_p95_ns", "drain_p95_ns")
DETERMINISTIC_HISTS = ("staleness_at_fold", "coalesce_batch", "queue_depth",
                       "submit_batch")
# the process and TCP stores' own stats keys
PROCESS_KEYS = ("processes", "transport", "respawns", "mirror_syncs",
                "shard_drain_timeouts", "wire_tx_bytes", "wire_rx_bytes",
                "replicas", "replica_pushes", "replica_drops")


def assert_reports_equal(port, ref, *, same_topology=True):
    for f in ("name", "n_clients", "n_ticks", "submitted", "fetched",
              "population_peak"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.ticks == ref.ticks
    stats = {k: v for k, v in port.stats.items() if k not in PROCESS_KEYS}
    if same_topology:
        assert stats == ref.stats
    else:
        # the workers reduce one partial each, the thread shards one a
        # max_coalesce chunk: the merge's arity differs, the fold does not
        stats.pop("global_partials")
        assert stats == {k: v for k, v in ref.stats.items() if k in stats}
    assert {k: v for k, v in port.slo.items() if k not in TIMING_SLOS} == \
        {k: v for k, v in ref.slo.items() if k not in TIMING_SLOS}
    for name in DETERMINISTIC_HISTS:
        if same_topology or name != "queue_depth":
            assert port.metrics["histograms"].get(name) == \
                ref.metrics["histograms"].get(name), name
    for k in ("kernel_calls", "season"):
        assert port.ewc[k] == ref.ewc[k], k
    np.testing.assert_allclose(port.ewc["penalty_last"],
                               ref.ewc["penalty_last"], rtol=1e-5, atol=ATOL)
    for part in ("anchors", "final_params"):
        assert sorted(port.ewc[part]) == sorted(ref.ewc[part])
        for key, v in port.ewc[part].items():
            assert v.dtype == np.float32
            np.testing.assert_allclose(v, np.asarray(ref.ewc[part][key]),
                                       atol=ATOL, rtol=0, err_msg=key)


PRESET_CASES = [
    ("diurnal_churn", dict()),
    ("flash_crowd", dict(dp_noise_multiplier=1.2)),
    ("region_outage", dict()),
    ("drift_ewc", dict(period=32, ewc_lambda=25.0)),
]


@pytest.mark.parametrize("topology", ["single", "sharded"])
@pytest.mark.parametrize("preset,kw", PRESET_CASES,
                         ids=[p for p, _ in PRESET_CASES])
def test_preset_reports_equal_reference(preset, kw, topology):
    n_ticks = 32 if preset == "drift_ewc" else 12
    args = (2_000, n_ticks)
    port = run_scenario(PRESETS[preset](*args, seed=13, **kw),
                        topology=topology, n_shards=3, device="cpu")
    ref = jrun(JPRESETS[preset](*args, seed=13, **kw), topology=topology,
               n_shards=3)
    assert_reports_equal(port, ref)
    port.assert_slo(lost_updates=0, effective_round_regressions=0,
                    drain_timeouts=0)
    assert port.submitted > 0 and port.fetched > 0
    if preset == "drift_ewc":
        assert port.ewc["kernel_calls"] > 0 and port.ewc["season"] == 1
        assert port.ewc["penalty_last"] > 0.0
    if "dp_noise_multiplier" in kw:
        assert port.slo["epsilon"] == ref.slo["epsilon"] > 0


def test_drift_ewc_retains_the_season_anchor():
    """The reference's ablation on the port: the EWC run ends nearer its
    season-A anchors than the lambda 0 run of the same seed."""
    mk = lambda lam: run_scenario(
        PRESETS["drift_ewc"](2_000, 32, period=32, ewc_lambda=lam, seed=13),
        topology="single", device="cpu")
    base, ewc = mk(0.0), mk(25.0)
    assert base.ewc["kernel_calls"] == 0 < ewc.ewc["kernel_calls"]
    d_base = sum(float(np.linalg.norm(base.ewc["final_params"][k] - a))
                 for k, a in ewc.ewc["anchors"].items())
    d_ewc = sum(float(np.linalg.norm(ewc.ewc["final_params"][k] - a))
                for k, a in ewc.ewc["anchors"].items())
    assert d_ewc < d_base


def test_process_topology_equals_reference(monkeypatch):
    """Spawned CPU workers fold the run the reference folds on threads."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    scen = dict(n_clusters=4, seed=5)
    port = run_scenario(flash_crowd_burst(2_000, 6, **scen),
                        topology="process", n_shards=2, device="cpu")
    ref = jrun(JPRESETS["flash_crowd"](2_000, 6, **scen), topology="sharded",
               n_shards=2)
    assert port.stats["processes"] == 2 and port.stats["respawns"] == 0
    assert_reports_equal(port, ref, same_topology=False)
    # the workers' folds reach the scenario's window through obsdump
    assert port.metrics["histograms"]["drain_fold_ns_host"]["count"] > 0


def test_tcp_topology_equals_reference(monkeypatch):
    """Two loopback port servers on the CPU fold the reference's run."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    scen = dict(n_clusters=4, seed=5)
    with transport.LoopbackShardServers(2, device="cpu",
                                        startup_timeout=90.0) as srv:
        port = run_scenario(flash_crowd_burst(2_000, 6, **scen),
                            topology="tcp", hosts=srv.hosts, device="cpu")
    ref = jrun(JPRESETS["flash_crowd"](2_000, 6, **scen), topology="sharded",
               n_shards=2)
    assert port.stats["transport"] == "tcp"
    assert_reports_equal(port, ref, same_topology=False)


def test_hundred_k_diurnal_churn_sharded():
    """The reference's acceptance run on the port: 10^5 clients, 24 ticks,
    4 shards, with the reference's SLO bounds."""
    rep = run_scenario(diurnal_churn(100_000, 24, seed=3),
                       topology="sharded", n_shards=4, device="cpu")
    assert rep.population_peak == 100_000
    assert rep.submitted > 1_000 and rep.fetched > 1_000
    rep.assert_slo(lost_updates=0, effective_round_regressions=0,
                   drain_timeouts=0, staleness_p95=4096)
    assert rep.slo["staleness_p95"] > 0
    assert len(rep.ticks) == 24
    row = rep.summary()
    assert row["slo_lost_updates"] == 0 and row["submits_per_s"] > 0


def test_assert_slo_reports_every_violation():
    rep = run_scenario(flash_crowd_burst(1_000, 4, n_clusters=2, seed=1),
                       topology="single", device="cpu")
    with pytest.raises(AssertionError) as ei:
        rep.assert_slo(submitted_nonsense=1, queue_depth_max=-1,
                       lost_updates=-1)
    msg = str(ei.value)
    for name in ("submitted_nonsense", "queue_depth_max", "lost_updates"):
        assert name in msg
    assert rep.assert_slo(lost_updates=0) is rep


def test_unknown_topology_and_missing_hosts_raise():
    from repro_torch.scenario import make_store

    with pytest.raises(ValueError, match="unknown topology"):
        make_store("ring", cluster_keys=["c0"], device="cpu")
    with pytest.raises(ValueError, match="needs hosts"):
        make_store("tcp", cluster_keys=["c0"], device="cpu")
