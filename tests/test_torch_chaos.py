"""The reference's chaos scenario (``tests/test_scenarios.py``,
``test_chaos_outage_migration_worker_kill``) on the port, on the CPU, at
the reference's size: ``regional_outage(5_000, 16, n_clusters=8,
seed=11)`` with a cluster migration at tick 6, on ``process`` and ``tcp``
the destination worker killed at tick 6 too, and on ``tcp`` server 0
killed and respawned at tick 10.  The reference's assertions hold, and
each run equals the JAX package's run of the same injections on the same
topology (``assert_reports_equal``): a killed worker's telemetry dies
with it in both packages, so the histograms match only topology for
topology (``ROADMAP.md`` §3 item 13).
"""

import dataclasses

import pytest

from repro.core.transport import LoopbackShardServers as JaxServers
from repro.scenario import regional_outage as jax_regional_outage
from repro.scenario import run_scenario as jax_run_scenario
from repro_torch.core.transport import LoopbackShardServers
from repro_torch.scenario import regional_outage, run_scenario
from test_torch_scenarios import PROCESS_KEYS, assert_reports_equal

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CHAOS = dict(n_clients=5_000, n_ticks=16, n_clusters=8, seed=11)


def chaos_inject(store, rep, *, kill: bool):
    """Mid-storm rebalance (+ optional crash): migrate the hottest
    cluster to the next shard, then sever the destination worker."""
    dst = (store.shard_of("c0") + 1) % store.n_shards
    store.migrate_cluster("c0", dst)
    if kill:
        store._debug_kill_worker(dst)


def chaos_run(run, scen, servers, topology, **kw):
    kill = topology != "sharded"
    inject = {6: lambda store, rep: chaos_inject(store, rep, kill=kill)}
    if topology == "tcp":
        with servers() as srv:
            inject[10] = lambda store, rep: (srv.kill(0), srv.respawn(0))
            return run(scen, topology="tcp", hosts=srv.hosts, inject=inject,
                       **kw)
    return run(scen, topology=topology, n_shards=2, inject=inject, **kw)


@pytest.mark.parametrize("topology", ["sharded", "process", "tcp"])
def test_chaos_outage_migration_worker_kill(topology, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rep = chaos_run(
        run_scenario, regional_outage(**CHAOS),
        lambda: LoopbackShardServers(2, device="cpu", startup_timeout=90.0),
        topology, device="cpu")
    assert rep.stats["cluster_migrations"] >= 1
    if topology != "sharded":
        assert rep.stats["respawns"] >= 1
    rep.assert_slo(lost_updates=0, effective_round_regressions=0)
    if topology == "tcp":
        assert rep.stats["respawns"] >= 2        # the worker and server 0

    ref = chaos_run(jax_run_scenario, jax_regional_outage(**CHAOS),
                    lambda: JaxServers(2), topology)
    # the tier's own keys (respawns, wire bytes) too: the same topology
    assert rep.stats == ref.stats
    assert_reports_equal(rep, dataclasses.replace(ref, stats={
        k: v for k, v in ref.stats.items() if k not in PROCESS_KEYS}))


def test_a_worker_takes_its_seed_from_its_queue_at_any_width(monkeypatch):
    """A spawned worker's seed blob goes by its command queue, not by the
    spawn's arguments, before and after a respawn: the child unpickles its
    arguments while it imports torch, so a blob wider than the pipe's
    buffer held the parent for that import before the next worker could
    start (the second worker of a store at the forecaster's width started
    ~9 s late on the H100).  The workers still fold what they were seeded
    with."""
    import torch

    from repro_torch.core import server_proc
    from repro_torch.core.aggregation import ModelMeta, UpdateDelta
    from repro_torch.scenario.engine import make_store

    spawned, context = [], server_proc.mp.get_context

    class Recording:
        def __init__(self, method):
            self._ctx = context(method)

        def __getattr__(self, name):
            return getattr(self._ctx, name)

        def Process(self, *a, **kw):
            spawned.append(kw["args"])
            return self._ctx.Process(*a, **kw)

    monkeypatch.setattr(server_proc.mp, "get_context", Recording)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    store = make_store("process", cluster_keys=["c0", "c1"], n_shards=2,
                       max_coalesce=16, param_dim=141_953, device="cpu")
    try:
        store._debug_kill_worker(store.shard_of("c0"))
        for key in ("c0", "c1"):
            store.handle_model_update(
                "cluster", key, {"w": torch.full((141_953,), 2.0)},
                ModelMeta(samples_learned=2, epochs_learned=1, round=1),
                UpdateDelta(2, 1, 1))
        store.drain_all()
        assert store.agg_stats()["respawns"] == 1
        assert len(spawned) == 3
        assert not any(isinstance(a, (bytes, bytearray))
                       for args in spawned for a in args)
        for key in ("c0", "c1"):
            w = store.request_model("cluster", key)[0]["w"]
            assert torch.equal(w, torch.full((141_953,), 2.0))
    finally:
        store.close()
