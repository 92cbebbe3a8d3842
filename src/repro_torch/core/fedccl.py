"""FedCCL facade: wires clustering, store, protocol, continual learning and
the runtime into one object — the library's main entry point.

    fed = FedCCL(FedCCLConfig(...), init_params, train_fn, device="cuda")
    fed.setup(client_specs)          # pre-training DBSCAN clustering
    fed.run(rounds=5)                # async training (sim or threaded)
    keys, params = fed.join(new_spec)  # Predict & Evolve for a new client

The port runs the single-lock ``ModelStore``; with ``server_shards`` the
thread-sharded ``ShardedModelStore`` (per-shard drain workers, two-level
global fold, live cluster migration); with ``server_processes`` or
``server_hosts`` the ``ProcessShardedModelStore`` (shard workers as
spawned processes, the in-process emulation under the sim runtime, or
standalone TCP shard servers, each folding on its own device), under the
deterministic sim runtime or the threaded one, with the privacy layer (DP
privatization, pairwise-mask secure aggregation, RDP accounting;
``repro_torch.privacy``) and the read tier (``fetch_from_workers``:
conditional fetches served by the shard servers; ``repro_torch.core.
fetch``) and telemetry (``telemetry=True``: spans, histograms and trace
chains across the parent and every worker, read by ``metrics_report`` and
``write_trace``; ``repro_torch.obs``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.clustering import IncrementalDBSCAN
from repro_torch.core.fetch import FetchClient
from repro_torch.core.predict_evolve import ClusterSpace, PredictEvolve
from repro_torch.core.protocol import Client, ClientSpec
from repro_torch.core.runtime_sim import AsyncSimRuntime
from repro_torch.core.runtime_threaded import AsyncThreadedRuntime
from repro_torch.core.store import (
    ModelStore,
    ProcessShardedModelStore,
    ShardedModelStore,
)
from repro_torch.obs.export import (
    metrics_json,
    prometheus_text,
    write_perfetto,
)
from repro_torch.obs.record import Telemetry
from repro_torch.privacy.accountant import RDPAccountant
from repro_torch.privacy.dp import DPConfig, DPPrivatizer
from repro_torch.privacy.secure_agg import PairwiseMasker
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


@dataclass(frozen=True)
class ClusterSpaceConfig:
    name: str                       # must match a static_features key
    eps: float
    min_samples: int = 3
    metric: str = "euclidean"


@dataclass(frozen=True)
class FedCCLConfig:
    spaces: tuple = (
        ClusterSpaceConfig("loc", eps=150.0, min_samples=3, metric="haversine"),
        ClusterSpaceConfig("ori", eps=25.0, min_samples=3, metric="cyclic"),
    )
    ewc_lambda: float = 0.0          # continual-learning anchor strength
    runtime: str = "sim"             # "sim" | "threaded"
    seed: int = 0
    dropout_prob: float = 0.0        # client-unavailability resilience knob
    batch_aggregation: bool = False  # coalescing server path (queue + drain)
    max_coalesce: int = 16           # max queued updates folded per drain
    # server sharding: 0 = single ModelStore; K >= 1 = ShardedModelStore
    # with K per-cluster shards (per-shard drain workers in the threaded
    # runtime, two-level global fold)
    server_shards: int = 0
    # shard workers: K >= 1 runs each shard in a worker of its own (a
    # spawned process under the threaded runtime, the deterministic
    # in-process emulation under the sim), folding on FedCCL's device;
    # takes precedence over server_shards
    server_processes: int = 0
    # standalone shard servers (repro_torch.launch.shard_server, or the
    # reference's), "host:port" each, reached over TCP (wire v4); an entry
    # "owner:port|replica:port" adds read replicas.  Takes precedence over
    # server_processes; len(server_hosts) fixes the shard count
    server_hosts: tuple = ()
    # read tier: serve model_for's fetches from the shard servers over
    # read-only sessions (conditional: not-modified acks and deltas), with
    # the parent as fallback
    fetch_from_workers: bool = False
    # process/TCP stores: workers ship params with every Nth drain reply
    # per model only; reads, checkpoints and shutdown sync dirty mirrors
    mirror_sync_every: int = 1
    # virtual nodes per shard on the consistent-hash ownership ring
    ring_vnodes: int = 64
    # FedCCL.rebalance() policy: None = manual only (migrate_cluster);
    # "load" moves the hottest shard's deepest-queued cluster to the
    # coldest shard when the hot shard carries more than
    # rebalance_hot_ratio times the cold shard's submits
    rebalance_policy: str | None = None
    rebalance_hot_ratio: float = 2.0
    # bounded drain deadline: drain-worker joins in the threaded runtime;
    # expiries surface as agg_stats()["drain_timeouts"] instead of silent
    # partial drains
    drain_timeout_s: float = 30.0
    # ---- privacy subsystem (repro_torch.privacy)
    dp_clip: float | None = None     # L2 clip of update deltas; None = DP off
    dp_noise_multiplier: float = 1.0 # noise std = multiplier * dp_clip
    secure_agg: bool = False         # pairwise-mask secure aggregation
    target_delta: float = 1e-5       # delta for (epsilon, delta) reporting
    # pair-mask std; 0.0 = unmasked parity baseline.  Must be set on the
    # order of n_samples * dp_clip to actually hide the weighted deltas —
    # see the magnitude caveat in repro_torch.privacy.secure_agg
    secure_mask_scale: float = 1.0
    # ---- telemetry (repro_torch.obs)
    # True wires a Telemetry sink through the store, its workers and the
    # fetch client: submit, enqueue and fold spans in per-thread rings and
    # log-bucketed latency, queue-depth and staleness histograms, read by
    # FedCCL.metrics_report() and write_trace().  Off: the stores hold None
    # and the hot paths pay one attribute check.  Telemetry changes no
    # result.
    telemetry: bool = False
    # trace-sample every Nth submit (1: every submit gets a span chain
    # across processes); metrics and events are always recorded
    trace_sample_n: int = 1


class FedCCL:
    def __init__(self, cfg: FedCCLConfig, init_params, train_fn, *,
                 device=None):
        if cfg.runtime not in ("sim", "threaded"):
            raise ValueError(f"unknown runtime {cfg.runtime!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_fn = train_fn
        # `.to` returns the same tensor when it already lies on the device;
        # sharing it is safe because nothing updates parameters in place
        init_params = tree_map(lambda x: x.to(self.device), init_params)
        self.masker = (PairwiseMasker(seed=cfg.seed,
                                      mask_scale=cfg.secure_mask_scale)
                       if cfg.secure_agg else None)
        self.accountant = (RDPAccountant(target_delta=cfg.target_delta)
                           if cfg.dp_clip is not None else None)
        tel = (Telemetry(sample_n=cfg.trace_sample_n)
               if cfg.telemetry else None)
        if cfg.server_hosts:
            self.store = ProcessShardedModelStore(
                init_params, server_hosts=list(cfg.server_hosts),
                batch_aggregation=cfg.batch_aggregation,
                max_coalesce=cfg.max_coalesce, masker=self.masker,
                drain_timeout_s=cfg.drain_timeout_s,
                mirror_sync_every=cfg.mirror_sync_every,
                ring_vnodes=cfg.ring_vnodes, device=self.device,
                telemetry=tel)
        elif cfg.server_processes > 0:
            self.store = ProcessShardedModelStore(
                init_params, n_shards=cfg.server_processes,
                batch_aggregation=cfg.batch_aggregation,
                max_coalesce=cfg.max_coalesce, masker=self.masker,
                drain_timeout_s=cfg.drain_timeout_s,
                mirror_sync_every=cfg.mirror_sync_every,
                ring_vnodes=cfg.ring_vnodes,
                inprocess=(cfg.runtime == "sim"), device=self.device,
                telemetry=tel)
        elif cfg.server_shards > 0:
            self.store = ShardedModelStore(
                init_params, n_shards=cfg.server_shards,
                batch_aggregation=cfg.batch_aggregation,
                max_coalesce=cfg.max_coalesce, masker=self.masker,
                drain_timeout_s=cfg.drain_timeout_s,
                ring_vnodes=cfg.ring_vnodes, telemetry=tel)
        else:
            self.store = ModelStore(
                init_params, batch_aggregation=cfg.batch_aggregation,
                max_coalesce=cfg.max_coalesce, masker=self.masker,
                drain_timeout_s=cfg.drain_timeout_s, telemetry=tel)
        self.spaces = [
            ClusterSpace(s.name, IncrementalDBSCAN(s.eps, s.min_samples, s.metric))
            for s in cfg.spaces]
        self.pe = PredictEvolve(self.spaces, self.store)
        self.clients: list[Client] = []
        self._clients_by_id: dict[str, Client] = {}
        self._init_params = init_params
        self._runtime = None
        # read tier: worker-served where the store has TCP endpoints,
        # parent-served (with the conditional wire cache) otherwise
        self.fetcher = (FetchClient(self.store, device=self.device,
                                    telemetry=tel)
                        if cfg.fetch_from_workers else None)

    def _make_privatizer(self, client_id: str, index: int):
        if self.cfg.dp_clip is None:
            return None
        return DPPrivatizer(
            DPConfig(clip=self.cfg.dp_clip,
                     noise_multiplier=self.cfg.dp_noise_multiplier),
            client_id=client_id, seed=self.cfg.seed + 2000 + index,
            accountant=self.accountant)

    # ----------------------------------------------------------------- setup
    def setup(self, specs: list[ClientSpec]) -> dict[str, list[str]]:
        assignments = self.pe.bootstrap(specs)
        for i, spec in enumerate(specs):
            c = Client(spec=spec,
                       cluster_keys=assignments[spec.client_id],
                       train_fn=self.train_fn,
                       ewc_lambda=self.cfg.ewc_lambda,
                       rng=np.random.default_rng(self.cfg.seed + 1000 + i),
                       privatizer=self._make_privatizer(spec.client_id, i))
            c.local_params = self._init_params
            self.clients.append(c)
            self._clients_by_id[spec.client_id] = c
        return assignments

    # ------------------------------------------------------------------- run
    def run(self, rounds: int = 1):
        if self.cfg.runtime == "threaded":
            rt = AsyncThreadedRuntime(self.clients, self.store, rounds)
            rt.run()
            self._runtime = rt
            return self.store.agg_stats()
        rt = AsyncSimRuntime(self.clients, self.store, seed=self.cfg.seed,
                             dropout_prob=self.cfg.dropout_prob)
        rt.run(rounds)
        self._runtime = rt
        return rt.stats()

    def shutdown(self):
        """Release server resources: the fetch client's read sessions and
        a process-sharded store's workers (bounded joins; TCP servers go
        back to accepting).  A no-op for the in-thread stores.  Model
        state stays readable: the parent keeps mirrors of every tier."""
        if self.fetcher is not None:
            self.fetcher.close()
        close = getattr(self.store, "close", None)
        if close is not None:
            close()

    # ------------------------------------------------- elastic membership
    def migrate_cluster(self, cluster_key: str, dst_shard: int) -> int:
        """Move one cluster model to another shard, live (no restart, no
        lost updates).  Returns the new ownership epoch; the flat store
        raises ``RuntimeError``."""
        return self.store.migrate_cluster(cluster_key, dst_shard)

    def rebalance(self) -> list[tuple[str, int, int]]:
        """Apply ``FedCCLConfig.rebalance_policy`` once; returns the
        migrations performed as ``(cluster_key, dst_shard, epoch)``.

        Policy ``"load"``: read per-shard submit counts from
        ``agg_stats()["shard_enqueued"]``; when the hottest shard carries
        more than ``rebalance_hot_ratio`` times the coldest shard's
        submits, migrate the hot shard's deepest-queued cluster to the
        cold shard.  ``None`` never migrates."""
        policy = self.cfg.rebalance_policy
        if policy is None:
            return []
        if policy != "load":
            raise ValueError(f"unknown rebalance_policy {policy!r} "
                             "(expected None or 'load')")
        enqueued = self.store.agg_stats().get("shard_enqueued")
        if not enqueued or len(enqueued) < 2:
            return []
        hot = max(range(len(enqueued)), key=lambda i: enqueued[i])
        cold = min(range(len(enqueued)), key=lambda i: enqueued[i])
        if hot == cold or (enqueued[hot] <=
                           self.cfg.rebalance_hot_ratio
                           * max(enqueued[cold], 1)):
            return []
        keys = self.store.shard_cluster_keys(hot)
        if not keys:
            return []
        key = max(keys, key=lambda k: self.store.pending_depth("cluster", k))
        epoch = self.store.migrate_cluster(key, cold)
        return [(key, cold, epoch)]

    # ----------------------------------------------------- Predict & Evolve
    def join(self, spec: ClientSpec) -> tuple[list[str], object]:
        """New client: immediate specialized model, then becomes participant."""
        keys, params = self.pe.join(spec)
        idx = len(self.clients)
        c = Client(spec=spec, cluster_keys=keys, train_fn=self.train_fn,
                   ewc_lambda=self.cfg.ewc_lambda,
                   rng=np.random.default_rng(self.cfg.seed + 5000 + idx),
                   privatizer=self._make_privatizer(spec.client_id, 3000 + idx))
        c.local_params = params
        self.clients.append(c)
        self._clients_by_id[spec.client_id] = c
        return keys, params

    # --------------------------------------------------------------- privacy
    def privacy_report(self) -> dict:
        """(epsilon, delta) budgets and secure-aggregation round accounting
        for the run so far (see ``repro_torch.privacy``), in the reference's
        shape: ``per_client`` and ``per_model`` appear when DP is on."""
        report = {
            "dp": {
                "enabled": self.cfg.dp_clip is not None,
                "clip": self.cfg.dp_clip,
                "noise_multiplier": self.cfg.dp_noise_multiplier,
                "target_delta": self.cfg.target_delta,
            },
            "secure_agg": {
                "enabled": self.cfg.secure_agg,
                "rounds": self.store.n_secure_rounds,
                "dropout_recoveries": self.store.n_secure_recoveries,
            },
        }
        if self.accountant is not None:
            report["per_client"] = self.accountant.client_report()
            report["per_model"] = self.accountant.model_report()
        return report

    # ------------------------------------------------------------- telemetry
    def metrics_report(self, fmt: str = "json"):
        """Telemetry merged across sites (``FedCCLConfig.telemetry=True``):
        the parent and every worker, pulled over the wire by ``obsdump``.

        ``fmt="json"`` returns a dict of counters, gauges and p50, p95, p99,
        mean and max per histogram (``submit_latency_ns``,
        ``drain_fold_ns_host`` or ``drain_fold_ns_cuda``, ``queue_depth``,
        ``staleness_at_fold``, ...); ``fmt="prometheus"`` the text
        exposition page of a scrape endpoint."""
        dump = self.store.telemetry_dump()
        if fmt == "prometheus":
            return prometheus_text(dump)
        if fmt != "json":
            raise ValueError(f"unknown metrics format {fmt!r} "
                             "(expected 'json' or 'prometheus')")
        return metrics_json(dump)

    def write_trace(self, path) -> None:
        """Write the run's spans as Chrome trace-event JSON, loadable in
        Perfetto or chrome://tracing: one process per telemetry site, flow
        arrows along each sampled submit's chain across the parent and its
        workers."""
        write_perfetto(self.store.telemetry_dump(), path)

    # ------------------------------------------------------------- inference
    def _serve_params(self, level: str, key: str | None = None):
        """One served read: through the fetch client when the read tier is
        on, else a snapshot of the parent's mirror."""
        if self.fetcher is not None:
            return self.fetcher.fetch(level, key)[0]
        return self.store.params(level, key)

    def model_for(self, client_id: str, level: str = "auto"):
        client = self._clients_by_id.get(client_id)
        if client is None:
            known = sorted(self._clients_by_id)
            shown = ", ".join(repr(k) for k in known[:8])
            if len(known) > 8:
                shown += f", ... ({len(known)} clients total)"
            raise KeyError(f"unknown client_id {client_id!r}; "
                           f"known clients: [{shown}]")
        if level == "local":
            return client.local_params, "local"
        if level == "global":
            return self._serve_params("global"), "global"
        if level.startswith("cluster"):
            if ":" in level:
                key = level.split(":", 1)[1]
            elif client.cluster_keys:
                key = client.cluster_keys[0]
            else:
                # noise client (DBSCAN label -1): no cluster model exists,
                # fall back to the global tier instead of crashing
                return self._serve_params("global"), "global"
            return self._serve_params("cluster", key), f"cluster:{key}"
        return self.pe.choose_inference_model(client, serve=self._serve_params)
