"""``examples/quickstart_torch.py`` against ``examples/quickstart.py`` on
the CPU, on each server topology, from the same weights: the JAX example's
``model.init(jax.random.key(0))`` reaches the port through
``params_from_numpy``.

Both runs must give the same cluster assignments, ``async_stats``, cluster
rounds and samples, join keys, telemetry histograms that do not depend on
time and trace flow chains, exactly, and print the same lines up to the
join; the global and cluster models agree within 1e-4 x max(1, max|p|)
after the run's 96 AdamW steps (4 organisations, 2 rounds, 3 trainings a
round of 4 steps each; the packages' f32 matmuls round differently).  The
process topology runs the sim's in-process emulation in both packages;
``tcp`` starts two loopback shard servers of its own package on the CPU.
"""

import argparse
import importlib.util
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core.fedccl as jax_fedccl
import repro_torch.core.fedccl as torch_fedccl
from repro_torch.utils.tree import params_from_numpy, tree_leaves

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
TOPOLOGIES = ("single", "sharded", "process", "tcp")
PARAMS_RTOL = 1e-4
DETERMINISTIC_HISTS = ("staleness_at_fold", "coalesce_batch", "queue_depth",
                       "submit_batch")


def load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recording(cls, log):
    """``cls`` that records its instance, its initial parameters and what
    ``setup``, ``run``, ``join`` and ``metrics_report`` return."""

    class Recorded(cls):
        def __init__(self, cfg, init_params, train_fn, **kw):
            super().__init__(cfg, init_params, train_fn, **kw)
            log.update(fed=self, init_params=init_params)

        def setup(self, specs):
            log["assignments"] = super().setup(specs)
            return log["assignments"]

        def run(self, rounds=1):
            log["stats"] = super().run(rounds)
            return log["stats"]

        def join(self, spec):
            log["join"] = super().join(spec)
            return log["join"]

        def metrics_report(self, fmt="json"):
            log["report"] = super().metrics_report(fmt)
            return log["report"]

    return Recorded


def jax_run(topology, tmp_path, monkeypatch, capsys):
    log = {}
    mod = load("quickstart")
    mod.FedCCL = recording(jax_fedccl.FedCCL, log)
    trace = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", [
        "quickstart.py", "--topology", topology, "--metrics",
        "--trace-out", str(trace)])
    mod.main()
    log["text"] = capsys.readouterr().out
    log["trace"] = json.loads(trace.read_text())
    return log


def torch_run(topology, init_params, tmp_path, monkeypatch, capsys):
    log = {}
    report = torch_fedccl.FedCCL.metrics_report

    def record(self, fmt="json"):
        log["report"] = report(self, fmt)
        return log["report"]

    monkeypatch.setattr(torch_fedccl.FedCCL, "metrics_report", record)
    trace = tmp_path / "torch.json"
    out = load("quickstart_torch").quickstart(
        topology, init_params=init_params, device="cpu", metrics=True,
        trace_out=str(trace))
    out.update(text=capsys.readouterr().out, report=log["report"],
               trace=json.loads(trace.read_text()))
    return out


def lines_to_join(text):
    """The printed lines up to the join's, the servers' ports left out."""
    lines = [ln for ln in text.splitlines()
             if not ln.startswith("loopback shard servers:")]
    end = next(i for i, ln in enumerate(lines)
               if ln.startswith("new org assigned to"))
    return lines[:end + 1]


def flows(trace):
    return sorted((e["id"], e["pid"], e["ph"]) for e in trace["traceEvents"]
                  if e["ph"] in ("s", "t", "f"))


def span_names(trace):
    return sorted({(e["name"], e["pid"]) for e in trace["traceEvents"]})


def model_gap(got, want):
    """(max abs difference, max(1, max|want|)) over one model's leaves."""
    got = tree_leaves(got)
    want = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    gap = max(float(np.max(np.abs(g.numpy() - w))) for g, w in
              zip(got, want, strict=True))
    top = max(1.0, max(float(np.max(np.abs(w))) for w in want))
    return gap, top


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_quickstart_matches_the_reference_example(topology, tmp_path,
                                                  monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ref = jax_run(topology, tmp_path, monkeypatch, capsys)
    init = params_from_numpy(jax.tree.map(np.asarray, ref["init_params"]),
                             "cpu")
    got = torch_run(topology, init, tmp_path, monkeypatch, capsys)

    assert got["assignments"] == ref["assignments"]
    assert got["stats"] == ref["stats"]
    assert lines_to_join(got["text"]) == lines_to_join(ref["text"])
    rfed = ref["fed"]
    assert sorted(got["metas"]) == sorted(rfed.store.keys())
    for key, meta in got["metas"].items():
        want = rfed.store.meta("cluster", key)
        assert (meta.round, meta.samples_learned) == \
            (want.round, want.samples_learned), key
    keys, params = got["join"]
    assert keys == ref["join"][0]
    (key,) = keys
    fed = got["fed"]
    for a, b in zip(tree_leaves(params),
                    tree_leaves(fed.store.params("cluster", key)),
                    strict=True):
        assert torch.equal(a, b)
    for level, k in [("global", None)] + [("cluster", k) for k in
                                          fed.store.keys()]:
        gap, top = model_gap(fed.store.params(level, k),
                             rfed.store.params(level, k))
        assert gap <= PARAMS_RTOL * top, (level, k, gap, top)
    if topology in ("process", "tcp"):
        assert got["server_stats"]["respawns"] == 0
        assert ref["fed"].store.agg_stats()["respawns"] == 0

    # --metrics: the same histograms, the deterministic ones equal
    hists, rhists = got["report"]["histograms"], ref["report"]["histograms"]
    assert sorted(hists) == sorted(rhists)
    assert got["report"]["sites"] == ref["report"]["sites"]
    for name in DETERMINISTIC_HISTS:
        assert hists.get(name) == rhists.get(name), name
    # --trace-out: the same flow chains and span names
    assert flows(got["trace"]) == flows(ref["trace"])
    assert span_names(got["trace"]) == span_names(ref["trace"])
    if topology in ("process", "tcp"):
        pids = {pid for _, pid, _ in flows(got["trace"])}
        assert 0 in pids and pids - {0}, "no flow chain reaches a worker"


def test_quickstart_torch_imports_nothing_of_the_reference():
    text = (EXAMPLES / "quickstart_torch.py").read_text()
    assert "import repro." not in text and "from repro." not in text
    assert "jax" not in text


def flags_of(main, monkeypatch, argv=None):
    """The command line ``main`` parses: {dest: (flags, default, choices)}."""
    seen = {}

    class Parsed(Exception):
        pass

    def grab(self, args=None, namespace=None):
        seen.update({a.dest: (a.option_strings, a.default, a.choices)
                     for a in self._actions if a.dest != "help"})
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Parsed):
        main() if argv is None else main(argv)
    monkeypatch.undo()
    return seen


def test_quickstart_torch_takes_the_reference_flags_and_a_device(monkeypatch):
    want = flags_of(load("quickstart").main, monkeypatch)
    got = flags_of(load("quickstart_torch").main, monkeypatch, [])
    assert got.pop("device") == (["--device"], "cuda", None)
    assert got == want


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device exists")
def test_quickstart_torch_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load("quickstart_torch").main(["--topology", "single"])
