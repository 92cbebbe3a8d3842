"""Vectorized trace replay against any store topology of the port.

The reference's engine (``repro.scenario.engine``) with the model side on
the store's device.  The population stays flat numpy (presence, region,
cluster assignment, held rounds, straggler cadence) and every draw comes
from the scenario's one ``np.random.Generator`` in the reference's order
and shapes, so the port replays the reference's workload draw for draw.
The server under test is real: every submit, fetch and migration goes
through the store's entry points (``submit_many``, ``request_model``,
``effective_round``, ``migrate_cluster``, ``drain*``) on a ``single``,
``sharded``, ``process`` or ``tcp`` topology.

Per tick the engine:

1. applies the tick's trace events (``repro_torch.scenario.traces``);
2. draws the available, then the participating clients;
3. "trains": each cluster's submitters move the fetched cluster params
   toward the cluster's current target (plus per-client noise); with
   ``ewc_lambda > 0`` the step's gradient runs through the ``ewc_update``
   kernel (``repro_torch.core.continual.ewc_adjusted_gradient``) anchored
   at the last season boundary.  Target, gradient, step and ``w + noise``
   are tensors on the store's device; the noise is drawn in numpy and
   moved there once a batch;
4. batch-submits per cluster (``store.submit_many``) plus a global slice;
5. fetches for a sampled subset (stragglers on their cadence only);
6. drains by queue pressure and every ``drain_every`` ticks, checking that
   ``effective_round`` never goes back;
7. runs injected chaos callbacks (``inject={tick: fn(store, engine)}``).

The run ends with ``drain_all`` and ``sync_mirrors``; the scenario's
telemetry window and ``agg_stats()`` become the SLO verdicts
(``repro_torch.scenario.slo``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.aggregation import (
    AggregationConfig,
    ModelMeta,
    UpdateDelta,
)
from repro_torch.core.continual import EWCState, ewc_adjusted_gradient
from repro_torch.core.store import (
    GLOBAL_KEY,
    ModelStore,
    ProcessShardedModelStore,
    ShardedModelStore,
)
from repro_torch.obs import clock
from repro_torch.obs.metrics import MetricsWindow, merge_metric_dumps
from repro_torch.obs.record import Telemetry
from repro_torch.scenario.slo import ScenarioReport, compute_slos
from repro_torch.scenario.traces import TraceEvent, by_tick
from repro_torch.utils.device import resolve_device

TOPOLOGIES = ("single", "sharded", "process", "tcp")


@dataclass
class ScenarioConfig:
    """Knobs of one scenario run, the reference's."""

    name: str = "scenario"
    n_clients: int = 10_000
    n_ticks: int = 24
    n_clusters: int = 8
    n_regions: int = 1
    param_dim: int = 16
    participation: float = 0.02   # share of available clients per tick
    fetch_frac: float = 0.05      # share of available clients fetching
    global_frac: float = 0.25     # share of submitters also hitting global
    samples_per_client: int = 64
    drain_every: int = 1          # drain_all cadence in ticks
    seed: int = 0
    lr: float = 0.3
    client_noise: float = 0.05
    ewc_lambda: float = 0.0       # > 0 trains through the ewc_update kernel
    dp_noise_multiplier: float = 0.0   # > 0 runs the RDP epsilon ledger
    target_delta: float = 1e-5


@dataclass
class Scenario:
    """A config plus its composed trace: what :func:`run_scenario` runs."""

    cfg: ScenarioConfig
    events: list[TraceEvent]


def make_store(topology: str, *, cluster_keys, n_shards: int = 4,
               hosts=None, telemetry=None, max_coalesce: int = 16,
               device=None, **kw):
    """Build a store of the given topology with the scenario defaults
    (batched aggregation: the replayer is queue-driven end to end).

    ``device`` (``None``: CUDA) holds the initial tree
    (``torch.zeros(param_dim)``) and is where the ``process`` topology's
    spawned workers fold; ``tcp`` servers fold on the device they were
    started with (``--device``).  The reference's ``use_pallas`` has no
    counterpart: the device decides the fold's route."""
    dev = resolve_device(device)
    init = {"w": torch.zeros(int(kw.pop("param_dim", 16)),
                             dtype=torch.float32, device=dev)}
    common = dict(agg_cfg=AggregationConfig(), batch_aggregation=True,
                  max_coalesce=max_coalesce, telemetry=telemetry, **kw)
    if topology == "single":
        return ModelStore(init, cluster_keys, **common)
    if topology == "sharded":
        return ShardedModelStore(init, cluster_keys, n_shards=n_shards,
                                 **common)
    if topology == "process":
        return ProcessShardedModelStore(init, cluster_keys,
                                        n_shards=n_shards, device=dev,
                                        **common)
    if topology == "tcp":
        if not hosts:
            raise ValueError("tcp topology needs hosts=[...]")
        return ProcessShardedModelStore(init, cluster_keys,
                                        server_hosts=hosts, device=dev,
                                        **common)
    raise ValueError(f"unknown topology {topology!r}; "
                     f"expected one of {TOPOLOGIES}")


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of a device tensor as host float32 numpy."""
    return t.detach().to("cpu", torch.float32).numpy().copy()


class _Replayer:
    """One scenario run's mutable state (flat arrays + store handles)."""

    def __init__(self, scenario: Scenario, store, topology: str,
                 device: torch.device):
        cfg = scenario.cfg
        self.cfg = cfg
        self.store = store
        self.topology = topology
        self.device = device
        self.rng = np.random.default_rng(cfg.seed)
        n = cfg.n_clients
        # ---- flat per-client state (the whole population) ----
        self.present = np.zeros(n, dtype=bool)
        self.region = self.rng.integers(0, cfg.n_regions, n).astype(np.int16)
        self.cluster = self.rng.integers(0, cfg.n_clusters, n).astype(np.int32)
        self.held_round = np.zeros(n, dtype=np.int64)     # cluster tier
        self.held_round_g = np.zeros(n, dtype=np.int64)   # global tier
        self.fetch_every = np.ones(n, dtype=np.int32)     # 1 = normal cadence
        self.last_fetch = np.full(n, -1, dtype=np.int64)
        self.submit_count = np.zeros(n, dtype=np.int64)
        # ---- environment ----
        self.avail = np.ones(cfg.n_regions, dtype=np.float64)
        self.dark = np.zeros(cfg.n_regions, dtype=bool)
        self.recovered = np.zeros(cfg.n_regions, dtype=bool)
        self.boost = 1.0
        self.drift_phase = 0.0
        self.season = 0
        # ---- per-cluster model-side state, on the device ----
        self.keys = [f"c{j}" for j in range(cfg.n_clusters)]
        base = self.rng.normal(0.0, 1.0, (cfg.n_clusters, cfg.param_dim))
        shift = self.rng.normal(0.0, 1.0, (cfg.n_clusters, cfg.param_dim))
        self.target_base = torch.from_numpy(
            base.astype(np.float32)).to(device)
        self.target_shift = torch.from_numpy(
            shift.astype(np.float32)).to(device)
        self.ewc_states: list[EWCState | None] = [None] * cfg.n_clusters
        self.ewc_calls = 0
        # the last penalty stays a device scalar until the report reads
        # it, so an anchored step never waits for the card
        self._penalty_last = None
        # ---- tallies ----
        self.submitted = 0
        self.fetched = 0
        self.population_peak = 0
        self.round_regressions = 0
        self._round_watermark: dict[str, int] = {}
        self.ticklog: list[dict] = []
        self.accountant = None
        if cfg.dp_noise_multiplier > 0:
            from repro_torch.privacy.accountant import RDPAccountant

            self.accountant = RDPAccountant(target_delta=cfg.target_delta)

    @property
    def ewc_penalty_last(self) -> float:
        return 0.0 if self._penalty_last is None \
            else float(self._penalty_last)

    # ------------------------------------------------------------ events
    def apply_event(self, ev: TraceEvent):
        if ev.kind == "join":
            self.present[ev.clients] = True
        elif ev.kind == "leave":
            self.present[ev.clients] = False
        elif ev.kind == "straggle":
            self.fetch_every[ev.clients] = ev.args["fetch_every"]
        elif ev.kind == "avail":
            frac = np.asarray(ev.args["frac"], np.float64)
            self.avail = np.broadcast_to(frac, (self.cfg.n_regions,)).copy()
        elif ev.kind == "boost":
            self.boost = float(ev.args["factor"])
        elif ev.kind == "outage_start":
            self.dark[ev.args["region"]] = True
        elif ev.kind == "outage_end":
            r = ev.args["region"]
            self.dark[r] = False
            self.recovered[r] = True      # burst of deferred submits
        elif ev.kind == "drift":
            self.drift_phase = float(ev.args["phase"])
            season = int(ev.args.get("season", 0))
            if season != self.season:
                self.season = season
                self._anchor_clusters()

    def _anchor_clusters(self):
        """Season boundary = task boundary: re-anchor every cluster's EWC
        state at its current folded params.  The anchor holds the store's
        tensor without a copy: nothing updates a stored tensor in place."""
        if self.cfg.ewc_lambda <= 0:
            return
        for j, key in enumerate(self.keys):
            params, _ = self.store.request_model("cluster", key)
            self.ewc_states[j] = EWCState(
                anchor=params["w"].to(torch.float32), fisher=None,
                lam=self.cfg.ewc_lambda)

    # ------------------------------------------------------------- ticks
    def target_for(self, j: int) -> torch.Tensor:
        """Cluster j's current true regression target under drift."""
        return self.target_base[j] + self.drift_phase * self.target_shift[j]

    def _train_cluster(self, j: int, fetched_w: torch.Tensor) -> torch.Tensor:
        """One local-training step for cluster ``j``'s submitters: descend
        the quadratic task loss toward the drifted target; with EWC on, the
        step's gradient runs through the ``ewc_update`` kernel."""
        grad = fetched_w - self.target_for(j)
        state = self.ewc_states[j]
        if state is not None:
            grad, pen = ewc_adjusted_gradient(grad, fetched_w, state)
            self.ewc_calls += 1
            self._penalty_last = pen
        return fetched_w - self.cfg.lr * grad

    def tick(self, t: int, events: list[TraceEvent]):
        cfg, rng = self.cfg, self.rng
        for ev in events:
            self.apply_event(ev)
        self.population_peak = max(self.population_peak,
                                   int(self.present.sum()))
        # availability: present, region not dark, diurnal fraction
        u = rng.random(cfg.n_clients)
        lit = ~self.dark[self.region]
        available = self.present & lit & (u < self.avail[self.region])
        # participation (+ flash-crowd boost, + outage-recovery burst)
        p = np.full(cfg.n_clients, cfg.participation * self.boost)
        if self.recovered.any():
            p[self.recovered[self.region]] *= 4.0     # deferred submits land
            self.recovered[:] = False
        submitters = available & (rng.random(cfg.n_clients) < p)
        # fetchers: sampled, but stragglers only on their cadence
        due = (t - self.last_fetch) >= self.fetch_every
        fetchers = available & due & (rng.random(cfg.n_clients)
                                      < cfg.fetch_frac)
        self._do_fetches(t, fetchers)
        self._do_submits(t, submitters)
        drained = self._do_drains(t)
        self._check_monotone()
        self.ticklog.append({"t": t, "available": int(available.sum()),
                             "submitted": int(submitters.sum()),
                             "fetched": int(fetchers.sum()),
                             "drained": drained})

    def _do_fetches(self, t: int, fetchers: np.ndarray):
        if not fetchers.any():
            return
        ids = np.flatnonzero(fetchers)
        self.fetched += len(ids)
        self.last_fetch[ids] = t
        # one effective_round read per touched cluster, fanned out to its
        # fetchers (the model bytes are the same for every fetcher of a
        # cluster; _do_submits reads them once a tick)
        for j in np.unique(self.cluster[ids]):
            r = self.store.effective_round("cluster", self.keys[j])
            self.held_round[ids[self.cluster[ids] == j]] = r
        rg = self.store.effective_round("global")
        self.held_round_g[ids] = rg

    def _noisy_batch(self, w: torch.Tensor, n: int) -> torch.Tensor:
        """``n`` rows of ``w`` plus per-client noise: the noise is drawn in
        numpy (the reference's draw) and moved to the device in one
        copy."""
        noise = self.rng.normal(0.0, self.cfg.client_noise,
                                (n, self.cfg.param_dim)).astype(np.float32)
        return w.unsqueeze(0) + torch.from_numpy(noise).to(self.device)

    def _do_submits(self, t: int, submitters: np.ndarray):
        cfg, rng = self.cfg, self.rng
        if not submitters.any():
            return
        ids = np.flatnonzero(submitters)
        self.submit_count[ids] += 1
        gmask = rng.random(len(ids)) < cfg.global_frac
        for j in np.unique(self.cluster[ids]):
            members = ids[self.cluster[ids] == j]
            key = self.keys[j]
            params, _meta = self.store.request_model("cluster", key)
            w = self._train_cluster(j, params["w"].to(torch.float32))
            rows = self._noisy_batch(w, len(members))
            rounds = self.held_round[members] + 1
            batch = [({"w": rows[i]},
                      ModelMeta(cfg.samples_per_client, 1, int(rounds[i])),
                      UpdateDelta(cfg.samples_per_client, 1, 1))
                     for i in range(len(members))]
            self.store.submit_many("cluster", key, batch)
            self.submitted += len(batch)
            if self.accountant is not None:
                for cid in members:
                    self.accountant.record(f"client{cid}", key,
                                           cfg.dp_noise_multiplier)
        # global tier: a slice of the same submitters
        gids = ids[gmask]
        if len(gids):
            params, _ = self.store.request_model("global")
            rows = self._noisy_batch(params["w"].to(torch.float32),
                                     len(gids))
            rounds = self.held_round_g[gids] + 1
            batch = [({"w": rows[i]},
                      ModelMeta(cfg.samples_per_client, 1, int(rounds[i])),
                      UpdateDelta(cfg.samples_per_client, 1, 1))
                     for i in range(len(gids))]
            self.store.submit_many("global", None, batch)
            self.submitted += len(batch)
            if self.accountant is not None:
                for cid in gids:
                    self.accountant.record(f"client{cid}", GLOBAL_KEY,
                                           cfg.dp_noise_multiplier)

    def _do_drains(self, t: int) -> int:
        store, cfg = self.store, self.cfg
        drained = 0
        # pressure-driven: any queue at or past the coalesce width
        if store.pending_depth("global") >= store.max_coalesce:
            drained += store.drain("global")
        for key in self.keys:
            if store.pending_depth("cluster", key) >= store.max_coalesce:
                drained += store.drain("cluster", key)
        # cadence-driven: full sweep every drain_every ticks
        if cfg.drain_every and (t + 1) % cfg.drain_every == 0:
            drained += store.drain_all()
        return drained

    def _check_monotone(self):
        """The staleness reference must never go back under a reader."""
        for key in (None, *self.keys):
            level, ck = ("global", None) if key is None else ("cluster", key)
            r = self.store.effective_round(level, ck)
            name = ck or GLOBAL_KEY
            if r < self._round_watermark.get(name, 0):
                self.round_regressions += 1
            self._round_watermark[name] = max(
                r, self._round_watermark.get(name, 0))


def run_scenario(scenario: Scenario, *, topology: str = "sharded",
                 store=None, hosts=None, n_shards: int = 4,
                 telemetry_sample_n: int = 64, max_coalesce: int = 16,
                 inject=None, close_store: bool | None = None,
                 assert_population: bool = True,
                 device=None) -> ScenarioReport:
    """Replay a scenario and return its :class:`ScenarioReport`.

    ``store=None`` builds a fresh store of ``topology`` on ``device``
    (``None``: CUDA; it raises without a card) with telemetry on, since the
    SLO verdicts need the histograms; a store passed in is reused, on its
    own device, and its telemetry window is scenario-scoped either way.
    ``inject`` maps tick -> ``fn(store, replayer)`` for chaos actions fired
    before that tick's events.  ``ewc["anchors"]`` and
    ``ewc["final_params"]`` are host float32 numpy copies.
    """
    cfg = scenario.cfg
    if store is None:
        dev = resolve_device(device)
        tel = Telemetry(sample_n=telemetry_sample_n, site="parent")
        store = make_store(topology, cluster_keys=[f"c{j}" for j in
                                                  range(cfg.n_clusters)],
                           n_shards=n_shards, hosts=hosts, telemetry=tel,
                           max_coalesce=max_coalesce,
                           param_dim=cfg.param_dim, device=dev)
        if close_store is None:
            close_store = True
    else:
        dev = store.params("global")["w"].device
    if assert_population:
        from repro_torch.scenario.traces import replay_population

        replay_population(cfg.n_clients, scenario.events)

    def dump_metrics():
        sites = store.telemetry_dump()["sites"]
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for site in sites:
            out = merge_metric_dumps(out, site["metrics"])
        return out

    window = MetricsWindow(dump_metrics)
    rep = _Replayer(scenario, store, topology, dev)
    ticks = by_tick(scenario.events)
    inject = inject or {}
    t0 = clock.monotonic_ns()
    try:
        for t in range(cfg.n_ticks):
            if t in inject:
                inject[t](store, rep)
            rep.tick(t, ticks.get(t, []))
        store.drain_all()
        store.sync_mirrors()
        rep._check_monotone()
        wall_s = (clock.monotonic_ns() - t0) / 1e9
        stats = store.agg_stats()
        metrics = window.diff()
        # snapshot before the store closes: the drift checks compare final
        # cluster params with the season anchors for EWC runs and their
        # lambda = 0 baselines alike
        ewc = {"kernel_calls": rep.ewc_calls,
               "penalty_last": rep.ewc_penalty_last,
               "season": rep.season,
               "anchors": {rep.keys[j]: _host(st.anchor)
                           for j, st in enumerate(rep.ewc_states)
                           if st is not None},
               "final_params": {
                   k: _host(store.request_model("cluster", k)[0]["w"])
                   for k in rep.keys}}
    finally:
        if close_store and hasattr(store, "close"):
            store.close()
    epsilon = None
    if rep.accountant is not None:
        eps_by_client = rep.accountant.client_report()
        epsilon = max((r["epsilon"] for r in eps_by_client.values()),
                      default=0.0)
    slo = compute_slos(submitted=rep.submitted, stats=stats,
                       metrics=metrics,
                       round_regressions=rep.round_regressions,
                       epsilon=epsilon)
    return ScenarioReport(
        name=cfg.name, topology=topology, n_clients=cfg.n_clients,
        n_ticks=cfg.n_ticks, submitted=rep.submitted, fetched=rep.fetched,
        population_peak=rep.population_peak, wall_s=wall_s, stats=stats,
        metrics=metrics, slo=slo, ewc=ewc, ticks=rep.ticklog)
