"""Predict & Evolve (paper contribution 2).

"Predict": a newly joining client is assigned to clusters by incremental
DBSCAN over its *static* characteristics and immediately receives the
matching specialized model(s) — zero training rounds needed.

"Evolve": once the client starts contributing data it becomes a normal
protocol participant, refining the cluster models it belongs to.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.clustering import NOISE, IncrementalDBSCAN
from repro_torch.core.protocol import Client, ClientSpec
from repro_torch.core.store import ModelStore


@dataclass
class ClusterSpace:
    """One clustering namespace, e.g. 'loc' (haversine over lat/lon) or
    'ori' (cyclic over azimuth)."""

    name: str
    clusterer: IncrementalDBSCAN

    def key(self, label: int) -> str | None:
        return None if label == NOISE else f"{self.name}:{label}"


class PredictEvolve:
    def __init__(self, spaces: list[ClusterSpace], store: ModelStore):
        self.spaces = spaces
        self.store = store
        # client_id -> {space name: (insert index, features)}.  A client that
        # leaves and later re-joins with unchanged features must NOT be
        # re-inserted: duplicate points count toward min_samples density, so
        # repeated joins would self-promote an isolated (NOISE) client into a
        # phantom singleton cluster.  Re-read the stored row's current label
        # instead (it may legitimately have changed via merges).
        self._seen: dict[str, dict[str, tuple[int, np.ndarray]]] = {}

    def _insert(self, space: ClusterSpace, client_id: str,
                feats: np.ndarray) -> int:
        prior = self._seen.get(client_id, {}).get(space.name)
        if prior is not None and np.array_equal(prior[1], feats):
            return int(space.clusterer.labels[prior[0]])
        label = space.clusterer.insert(feats)
        idx = len(space.clusterer.labels) - 1
        self._seen.setdefault(client_id, {})[space.name] = (idx, feats)
        return label

    # ------------------------------------------------------------- bootstrap
    def bootstrap(self, specs: list[ClientSpec]) -> dict[str, list[str]]:
        """Pre-training clustering over the initial population (paper §II.B).
        Returns client_id -> cluster keys."""
        assignments: dict[str, list[str]] = {s.client_id: [] for s in specs}
        for space in self.spaces:
            idx = {}
            for spec in specs:
                feats = np.asarray(spec.static_features[space.name],
                                   np.float64)
                self._insert(space, spec.client_id, feats)
                idx[spec.client_id] = \
                    self._seen[spec.client_id][space.name][0]
                # labels can merge/shift as later points arrive; re-read after
            # final labels after all inserts
            for spec in specs:
                label = int(space.clusterer.labels[idx[spec.client_id]])
                key = space.key(label)
                if key is not None:
                    assignments[spec.client_id].append(key)
                    self.store.ensure_cluster(key)
        return assignments

    # ------------------------------------------------------------ new client
    def join(self, spec: ClientSpec) -> tuple[list[str], object]:
        """Predict phase: assign clusters, hand back the best model snapshot
        (first cluster model if any, else global)."""
        keys = []
        for space in self.spaces:
            label = self._insert(
                space, spec.client_id,
                np.asarray(spec.static_features[space.name], np.float64))
            key = space.key(label)
            if key is not None:
                keys.append(key)
                self.store.ensure_cluster(key)
        if keys:
            params, _ = self.store.request_model("cluster", keys[0])
        else:
            params, _ = self.store.request_model("global")
        return keys, params

    def choose_inference_model(self, client: Client, serve=None):
        """Paper §VI open question — we implement the pragmatic default:
        prefer the first cluster model, else global.

        ``serve(level, key=None) -> params`` overrides the read path so a
        caller can route the chosen tier through its serving tier (the
        FedCCL facade passes its ``_serve_params``, which fetches
        worker-side when the read tier is on); default is a parent read.
        """
        if client.cluster_keys:
            key = client.cluster_keys[0]
            if serve is not None:
                return serve("cluster", key), f"cluster:{key}"
            params, _ = self.store.request_model("cluster", key)
            return params, f"cluster:{key}"
        if serve is not None:
            return serve("global"), "global"
        params, _ = self.store.request_model("global")
        return params, "global"
