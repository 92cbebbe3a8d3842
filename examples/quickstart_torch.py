"""Quickstart on the PyTorch port (``repro_torch``), on any server topology:
the run, flags and printed lines of ``examples/quickstart.py``, with the
hand-written CUDA kernels on the GPU.

Four organisations in two geographic regions federate a (reduced) Gemma
model: pre-training DBSCAN clusters them, each trains locally, the server
aggregates per Algorithm 2 into cluster + global models, and a fifth org
joining later immediately receives its region's specialized model
(Predict & Evolve).

    PYTHONPATH=src python examples/quickstart_torch.py --topology single
    PYTHONPATH=src python examples/quickstart_torch.py --topology sharded
    PYTHONPATH=src python examples/quickstart_torch.py --topology process
    PYTHONPATH=src python examples/quickstart_torch.py --topology tcp

It runs on CUDA (and raises where there is none) unless ``--device cpu``
is given; the CPU runs the kernels' plain PyTorch versions.  ``tcp``
spawns two standalone shard servers (``python -m
repro_torch.launch.shard_server``) on loopback ports, folding on the same
device, via ``LoopbackShardServers``.  ``--metrics`` prints the telemetry
summary at exit; ``--trace-out spans.json`` also writes a Perfetto-loadable
trace whose flow arrows follow each sampled submit across the parent ->
worker process/TCP boundary:

    PYTHONPATH=src python examples/quickstart_torch.py --topology tcp \\
        --metrics --trace-out spans.json
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.core.fedccl import ClusterSpaceConfig, FedCCL, FedCCLConfig
from repro_torch.core.protocol import ClientSpec
from repro_torch.data.lm_synth import lm_batch
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import adamw
from repro_torch.training.train_step import TrainState, build_train_step
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves

TOPOLOGIES = ("single", "sharded", "process", "tcp")


def make_config(topology: str, hosts, telemetry: bool = False) -> FedCCLConfig:
    base = dict(spaces=(ClusterSpaceConfig(
        "loc", eps=150.0, min_samples=2, metric="haversine"),),
        ewc_lambda=0.01, seed=0, telemetry=telemetry)
    if topology == "single":
        return FedCCLConfig(**base)
    base["batch_aggregation"] = True
    if topology == "sharded":
        return FedCCLConfig(server_shards=2, **base)
    if topology == "process":
        return FedCCLConfig(server_processes=2, **base)
    if topology == "tcp":
        return FedCCLConfig(server_hosts=tuple(hosts),
                            mirror_sync_every=4, drain_timeout_s=120.0,
                            **base)
    raise ValueError(f"unknown topology {topology!r}")


def print_metrics_summary(fed: FedCCL) -> None:
    """One screen: merged cross-site percentiles for the run."""
    rep = fed.metrics_report()
    print(f"telemetry sites: {rep['sites']} "
          f"(dropped events: {rep['dropped_events']})")
    for name, h in sorted(rep["histograms"].items()):
        unit = " us" if name.endswith("_ns") else ""
        scale = 1e3 if name.endswith("_ns") else 1.0
        print(f"  {name:<22} n={h['count']:<6} "
              f"p50={h['p50'] / scale:>10.1f}{unit} "
              f"p95={h['p95'] / scale:>10.1f}{unit} "
              f"p99={h['p99'] / scale:>10.1f}{unit} "
              f"max={h['max'] / scale:>10.1f}{unit}")
    for name, v in sorted(rep["gauges"].items()):
        print(f"  {name:<22} {v}")


def quickstart(topology: str = "single", *, cfg=None, init_params=None,
               device=None, metrics: bool = False,
               trace_out: str | None = None) -> dict:
    """The example's run on ``topology``: ``reduced_for_smoke`` of
    gemma-2b unless ``cfg`` is given, weights drawn from seed 0 on the
    device unless ``init_params`` is given.  Returns the assignments, the
    run's stats, each cluster's meta, the join's keys and params, and the
    ``FedCCL`` (shut down; its store's mirrors stay readable)."""
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}")
    telemetry = metrics or trace_out is not None
    dev = resolve_device(device)
    cfg = cfg or reduced_for_smoke(get_config("gemma-2b"))
    model = build_model(cfg)
    opt = adamw(1e-3)
    step = build_train_step(model, cfg, opt)
    if init_params is None:
        init_params = model.init(torch.Generator(device=dev).manual_seed(0),
                                 dev)

    def train_fn(params, dataset, rng, anchor):
        """Each org fine-tunes on its private token stream."""
        state = TrainState(params, opt.init(params))
        n_batches, bsz, seq = 4, 4, 32
        for _ in range(n_batches):
            batch = lm_batch(rng, bsz, seq, cfg.vocab_size)
            state, _ = step(state, batch)
        return state.params, n_batches * bsz, 1

    servers = None
    if topology == "tcp":
        from repro_torch.core.transport import LoopbackShardServers

        servers = LoopbackShardServers(2, device=str(dev))
        print("loopback shard servers:", servers.hosts)
    try:
        fed = FedCCL(make_config(topology, servers.hosts if servers
                                 else (), telemetry),
                     init_params=init_params, train_fn=train_fn, device=dev)

        orgs = [
            ClientSpec("org-vienna-1", {"loc": np.array([48.21, 16.37])},
                       None),
            ClientSpec("org-vienna-2", {"loc": np.array([48.30, 16.40])},
                       None),
            ClientSpec("org-berlin-1", {"loc": np.array([52.52, 13.40])},
                       None),
            ClientSpec("org-berlin-2", {"loc": np.array([52.45, 13.30])},
                       None),
        ]
        assignments = fed.setup(orgs)
        print(f"topology {topology}: cluster assignments:", assignments)

        stats = fed.run(rounds=2)
        print("async stats:", stats)
        fed.store.sync_mirrors()       # no-op except under lazy mirror sync
        metas = {}
        for key in fed.store.keys():
            metas[key] = meta = fed.store.meta("cluster", key)
            print(f"  cluster {key}: round={meta.round} "
                  f"samples={meta.samples_learned}")
        server_stats = fed.store.agg_stats()
        if "transport" in server_stats:
            print(f"  transport={server_stats['transport']} "
                  f"respawns={server_stats['respawns']} "
                  f"wire_rx_bytes={server_stats['wire_rx_bytes']}")

        # Predict & Evolve: a new Vienna org joins, gets the Vienna model
        keys, params = fed.join(
            ClientSpec("org-vienna-new", {"loc": np.array([48.25, 16.35])},
                       None))
        print(f"new org assigned to {keys}; received specialized params "
              f"({sum(x.numel() for x in tree_leaves(params)):,} weights)")
        if telemetry:
            # dump before shutdown: the obsdump RPC needs live workers
            if trace_out:
                fed.write_trace(trace_out)
                print(f"wrote Perfetto trace to {trace_out} "
                      f"(open at ui.perfetto.dev)")
            print_metrics_summary(fed)
        fed.shutdown()
    finally:
        if servers is not None:
            servers.close()
    return {"assignments": assignments, "stats": stats, "metas": metas,
            "server_stats": server_stats, "join": (keys, params), "fed": fed}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--topology", choices=TOPOLOGIES, default="single",
                    help="federation server flavor (see the README "
                         "topology table / docs/ARCHITECTURE.md)")
    ap.add_argument("--metrics", action="store_true",
                    help="enable telemetry and print a metrics summary at "
                         "exit (docs/OBSERVABILITY.md)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-loadable trace-event JSON of the "
                         "run's span chains (implies --metrics)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    return quickstart(args.topology, device=args.device,
                      metrics=args.metrics, trace_out=args.trace_out)


if __name__ == "__main__":
    main()
