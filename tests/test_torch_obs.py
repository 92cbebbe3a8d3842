"""The port's telemetry layer (``repro_torch.obs``) against the reference's
(``repro.obs``): the counterparts of ``tests/test_obs.py``, each fed the
same inputs in both packages.

Histograms, merges, percentiles, rings, the trace context and sampling
must behave alike; every exporter must give equal output for the same
dump, whichever package recorded it; and the port's msgpack codec must
pack a dump to the reference's bytes and read the reference's back.
Nothing here depends on a clock reading except the timestamps, which both
exporters take from the dump itself.
"""

import json
import threading

import numpy as np
import pytest
import torch

from repro.checkpoint import msgpack_ckpt as jckpt
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import record as jrecord
from repro_torch.checkpoint import msgpack_ckpt as tckpt
from repro_torch.core.aggregation import (
    AggregationConfig,
    ModelMeta,
    UpdateDelta,
)
from repro_torch.core.store import ModelStore
from repro_torch.obs import export, metrics, record
from repro_torch.obs.record import Telemetry, current_trace, trace_scope

PKGS = [pytest.param((metrics, record, export), id="port"),
        pytest.param((jmetrics, jrecord, jexport), id="reference")]


# ----------------------------------------------------------------- metrics
def test_bucketing_by_bit_length_equals_reference():
    vals = (0, 1, 2, 3, 1000, -5, 1 << 40, (1 << 70))
    a, b = metrics.LogHistogram(), jmetrics.LogHistogram()
    for v in vals:
        a.observe(v)
        b.observe(v)
    s = a.snapshot()
    assert s == b.snapshot()
    assert s["buckets"][0] == 2 and s["buckets"][2] == 2
    assert s["buckets"][63] == 1                 # clamped to the last bucket
    assert [metrics.bucket_le(i) for i in range(64)] == \
        [jmetrics.bucket_le(i) for i in range(64)]


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_merge_equals_a_single_recorder(seed):
    vals = [int(v) for v in
            np.random.default_rng(seed).integers(0, 1 << 20, size=200)]
    one, a, b = (metrics.LogHistogram() for _ in range(3))
    for i, v in enumerate(vals):
        one.observe(v)
        (a if i % 2 else b).observe(v)
    merged = metrics.merge_hist_dumps(a.snapshot(), b.snapshot())
    assert merged == one.snapshot()
    assert merged == jmetrics.merge_hist_dumps(a.snapshot(), b.snapshot())


@pytest.mark.parametrize("q", [0.5, 0.95, 0.99, 1.0])
def test_percentiles_equal_reference(q):
    h = metrics.LogHistogram()
    for v in np.random.default_rng(3).integers(0, 1 << 16, size=300):
        h.observe(int(v))
    s = h.snapshot()
    p = metrics.percentile_from_buckets(s, q)
    assert p == jmetrics.percentile_from_buckets(s, q)
    assert p <= 2 * s["max"]
    empty = {"buckets": [0] * 64, "count": 0, "sum": 0, "max": 0}
    assert metrics.percentile_from_buckets(empty, q) == 0.0


def test_registry_merge_and_window_diff_equal_reference():
    regs = []
    for pkg in (metrics, jmetrics):
        r1, r2 = pkg.MetricsRegistry(), pkg.MetricsRegistry()
        r1.counter("folds").inc(3)
        r2.counter("folds").inc(4)
        r1.gauge("wire_tx_bytes").set(100)
        r2.gauge("wire_tx_bytes").set(50)
        r1.histogram("lat").observe(8)
        r2.histogram("lat").observe(9)
        win = pkg.MetricsWindow(r1.dump)
        r1.counter("folds").inc(2)
        r1.histogram("lat").observe(1 << 12)
        regs.append((pkg.merge_metric_dumps(r1.dump(), r2.dump()),
                     win.diff()))
    assert regs[0] == regs[1]
    merged, window = regs[0]
    assert merged["counters"]["folds"] == 9
    assert merged["gauges"]["wire_tx_bytes"] == 150.0
    assert window["counters"]["folds"] == 2
    assert window["histograms"]["lat"]["count"] == 1


# --------------------------------------------------- rings + trace context
@pytest.mark.parametrize("pkgs", PKGS)
def test_ring_overwrites_oldest_and_counts_dropped(pkgs):
    tel = pkgs[1].Telemetry(ring_cap=4)
    for i in range(7):
        tel.event(f"e{i}", t0_ns=i, dur_ns=0)
    dump = tel.dump()
    assert dump["dropped"] == 3
    assert [ev[2] for ev in dump["events"]] == ["e3", "e4", "e5", "e6"]


@pytest.mark.parametrize("pkgs", PKGS)
def test_dump_merges_threads_in_timestamp_order(pkgs):
    tel = pkgs[1].Telemetry()
    tel.event("main", t0_ns=5, dur_ns=0)
    t = threading.Thread(target=lambda: tel.event("worker", t0_ns=1,
                                                  dur_ns=0))
    t.start()
    t.join()
    events = tel.dump()["events"]
    assert [ev[2] for ev in events] == ["worker", "main"]
    assert events[0][4] != events[1][4]          # one ring (tid) a thread


def test_trace_scope_nests_restores_and_stays_thread_local():
    assert current_trace() == 0
    seen = {}
    with trace_scope(7):
        assert current_trace() == 7
        with trace_scope(9):
            assert current_trace() == 9
            t = threading.Thread(
                target=lambda: seen.setdefault("other", current_trace()))
            t.start()
            t.join()
        assert current_trace() == 7
        # the packages keep separate contexts: a reference scope is not
        # the port's and the reverse
        assert jrecord.current_trace() == 0
    assert current_trace() == 0
    assert seen["other"] == 0


@pytest.mark.parametrize("n", [1, 3, 64])
def test_sampling_equals_reference(n):
    a, b = Telemetry(sample_n=n), jrecord.Telemetry(sample_n=n)
    assert [a.sampled(i) for i in range(200)] == \
        [b.sampled(i) for i in range(200)]
    assert Telemetry().sample_n == 1
    with a.span("mirror_sync", trace=3, args={"shard": 1}):
        pass
    ((t0, dur, name, trace, tid, args),) = a.dump()["events"]
    assert (name, trace, args) == ("mirror_sync", 3, {"shard": 1})
    assert dur >= 0 and tid == threading.get_ident()


# ---------------------------------------------------------------- exporters
def _dump(pkgs, seed: int) -> dict:
    """A two-site dump recorded by one package: histograms from a seeded
    draw, a parent submit/enqueue chain and a worker fold joined by the
    wire seq, fixed anchors."""
    m, r, _ = pkgs
    rng = np.random.default_rng(seed)
    sites = []
    for name in ("parent", "shard-0"):
        tel = r.Telemetry(site=name)
        tel.anchor = (1_700_000_000_000_000_000 + seed, 1000 * seed)
        for v in rng.integers(0, 1 << 24, size=50):
            tel.metrics.histogram("submit_latency_ns").observe(int(v))
        for v in rng.integers(0, 40, size=30):
            tel.metrics.histogram("staleness_at_fold").observe(int(v))
        tel.metrics.counter("fetch_full").inc(int(rng.integers(1, 9)))
        tel.metrics.gauge("wire_tx_bytes").set(float(rng.integers(1, 1e6)))
        sites.append(tel)
    sites[0].event("submit", 100, 50, 10, None)
    sites[0].event("enqueue", 110, 10, 10, {"key": "c0", "seq": 9})
    sites[0].event("client.round", 120, 0, 0, {"client": "s1"})
    sites[1].event("worker.fold", 400, 30, 0,
                   {"key": "c0", "n": 2, "seqs": [9, 12]})
    return {"sites": [t.dump() for t in sites]}


@pytest.mark.parametrize("recorder", PKGS)
@pytest.mark.parametrize("seed", [0, 1])
def test_exporters_equal_reference_on_the_same_dump(recorder, seed):
    dump = _dump(recorder, seed)
    assert export.merged_metrics(dump) == jexport.merged_metrics(dump)
    assert export.metrics_json(dump) == jexport.metrics_json(dump)
    text = export.prometheus_text(dump)
    assert text == jexport.prometheus_text(dump)
    for line in text.splitlines():       # the exposition format's grammar
        assert line.startswith("# TYPE fedccl_") or \
            line.split(" ")[0].startswith("fedccl_")
    trace = export.perfetto_trace(dump)
    assert trace == jexport.perfetto_trace(dump)
    flows = [e for e in trace["traceEvents"] if e["ph"] in ("s", "t", "f")]
    assert {f["id"] for f in flows} == {10}     # trace 10 == seq 9 + 1
    assert {f["pid"] for f in flows} == {0, 1}


def test_mixed_sites_merge_in_either_package():
    """A port site and a reference site in one dump: both packages'
    exporters give the same merged metrics and chains."""
    dump = {"sites": [_dump((metrics, record, export), 3)["sites"][0],
                      _dump((jmetrics, jrecord, jexport), 4)["sites"][1]]}
    assert export.metrics_json(dump) == jexport.metrics_json(dump)
    assert export.perfetto_trace(dump) == jexport.perfetto_trace(dump)


@pytest.mark.parametrize("recorder", PKGS)
def test_dump_bytes_equal_reference(recorder):
    """The port's ``packb`` of a dump is the reference's bytes (events as
    arrays), and each package reads the other's back."""
    dump = _dump(recorder, 5)
    raw = tckpt.packb(["obsdumped", dump["sites"][1]])
    assert raw == jckpt.packb(["obsdumped", dump["sites"][1]])
    assert tckpt.unpackb(raw, "cpu") == jckpt.unpackb_np(raw)
    assert tckpt.unpackb(raw, "cpu")[1] == json.loads(json.dumps(
        dump["sites"][1]))


def test_write_perfetto_is_loadable_json(tmp_path):
    path = tmp_path / "trace.json"
    export.write_perfetto(_dump((metrics, record, export), 2), path)
    loaded = json.loads(path.read_text())
    assert loaded["displayTimeUnit"] == "ms"
    assert any(e.get("name") == "worker.fold"
               for e in loaded["traceEvents"])


# -------------------------------------------------------------- store hooks
def _tree(rng):
    return {"w": torch.from_numpy(rng.normal(size=8).astype(np.float32))}


def test_model_store_records_metrics_events_and_trace_chain():
    rng = np.random.default_rng(1)
    store = ModelStore(_tree(rng), ["c0"],
                       agg_cfg=AggregationConfig(sequential_fast_path=False),
                       batch_aggregation=True, max_coalesce=4,
                       telemetry=Telemetry())
    for _ in range(3):
        store.handle_model_update("cluster", "c0", _tree(rng),
                                  ModelMeta(5, 1, 1), UpdateDelta(5, 1, 1))
    store.drain_all()
    dump = store.telemetry_dump()
    assert [s["site"] for s in dump["sites"]] == ["parent"]
    m = export.merged_metrics(dump)["histograms"]
    assert m["submit_latency_ns"]["count"] == m["queue_depth"]["count"] == 3
    assert m["staleness_at_fold"]["count"] == 3
    assert m["drain_fold_ns_host"]["count"] >= 1    # a CPU tree: plain route
    by_name = {}
    for _, _, name, trace, _, _ in dump["sites"][0]["events"]:
        by_name.setdefault(name, []).append(trace)
    assert sorted(by_name["submit"]) == sorted(by_name["enqueue"])
    assert len(set(by_name["submit"])) == 3 and 0 not in by_name["submit"]
    assert current_trace() == 0


def test_telemetry_off_store_records_nothing():
    rng = np.random.default_rng(2)
    store = ModelStore(_tree(rng), ["c0"], batch_aggregation=True)
    store.handle_model_update("cluster", "c0", _tree(rng),
                              ModelMeta(5, 1, 1), UpdateDelta(5, 1, 1))
    store.drain_all()
    assert store.telemetry is None
    assert store.telemetry_dump() == {"sites": []}
    assert current_trace() == 0
