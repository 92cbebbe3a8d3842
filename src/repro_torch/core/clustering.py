"""Pre-training clustering (paper §II.B): DBSCAN over *static* client

characteristics + the incremental variant used by Predict & Evolve to assign
new clients to existing clusters without re-clustering.

Implemented from scratch (no sklearn in this environment) in numpy.
Supports euclidean, haversine (geo coordinates) and cyclic (panel azimuth)
metrics.  Noise points get label -1 and fall back to the global model only.
"""

from __future__ import annotations

from dataclasses import dataclass
from collections.abc import Callable

import numpy as np

NOISE = -1
UNVISITED = -2


def haversine_km(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Great-circle distance in km. a: (n, 2) [lat, lon] deg; b: (m, 2)."""
    a = np.radians(np.atleast_2d(a))
    b = np.radians(np.atleast_2d(b))
    dlat = a[:, None, 0] - b[None, :, 0]
    dlon = a[:, None, 1] - b[None, :, 1]
    h = (np.sin(dlat / 2) ** 2
         + np.cos(a[:, None, 0]) * np.cos(b[None, :, 0]) * np.sin(dlon / 2) ** 2)
    return 2 * 6371.0 * np.arcsin(np.sqrt(np.clip(h, 0, 1)))


def euclidean(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    return np.sqrt(((a[:, None] - b[None, :]) ** 2).sum(-1))


def cyclic_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance on a 360-degree circle (panel azimuth)."""
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    d = np.abs(a[:, None, 0] - b[None, :, 0]) % 360.0
    return np.minimum(d, 360.0 - d)


METRICS: dict[str, Callable] = {
    "euclidean": euclidean,
    "haversine": haversine_km,
    "cyclic": cyclic_deg,
}


@dataclass
class DBSCAN:
    """Ester et al. 1996.  eps in metric units; min_samples incl. the point."""

    eps: float
    min_samples: int = 3
    metric: str = "euclidean"

    labels_: np.ndarray | None = None
    X_: np.ndarray | None = None
    n_clusters_: int = 0

    def _dist(self, a, b):
        return METRICS[self.metric](a, b)

    def fit(self, X: np.ndarray) -> "DBSCAN":
        X = np.asarray(X, dtype=np.float64)
        n = len(X)
        D = self._dist(X, X)
        neighbors = [np.flatnonzero(D[i] <= self.eps) for i in range(n)]
        core = np.array([len(nb) >= self.min_samples for nb in neighbors])
        labels = np.full(n, UNVISITED, dtype=np.int64)

        cid = 0
        for i in range(n):
            if labels[i] != UNVISITED or not core[i]:
                continue
            # BFS expand cluster from core point i
            labels[i] = cid
            frontier = list(neighbors[i])
            while frontier:
                j = frontier.pop()
                if labels[j] == NOISE:
                    labels[j] = cid           # border point adopted
                if labels[j] != UNVISITED:
                    continue
                labels[j] = cid
                if core[j]:
                    frontier.extend(neighbors[j])
            cid += 1
        labels[labels == UNVISITED] = NOISE
        self.labels_ = labels
        self.X_ = X
        self.core_ = core
        self.n_clusters_ = cid
        return self

    # --- incremental assignment (Predict phase) ----------------------------
    def assign(self, x: np.ndarray) -> int:
        """Assign a new point to the nearest cluster whose *core* point is
        within eps; NOISE otherwise.  Does not mutate the fit."""
        if self.X_ is None or len(self.X_) == 0:
            return NOISE
        d = self._dist(np.asarray(x, np.float64)[None], self.X_)[0]
        ok = (d <= self.eps) & self.core_ & (self.labels_ != NOISE)
        if not ok.any():
            return NOISE
        return int(self.labels_[ok][np.argmin(d[ok])])


@dataclass
class IncrementalDBSCAN:
    """Ester & Wittmann 1998-style incremental insertion.

    Inserting a point can (a) join an existing cluster, (b) create a new one
    if it upgrades neighbors to core status, or (c) *merge* clusters when it
    density-connects them.  Deletion is not needed by FedCCL (clients leaving
    keep their cluster models) and is not implemented.
    """

    eps: float
    min_samples: int = 3
    metric: str = "euclidean"

    def __post_init__(self):
        self.X = np.zeros((0, 0), np.float64)
        self.labels = np.zeros((0,), np.int64)
        self._next_cid = 0

    def _dist(self, a, b):
        return METRICS[self.metric](a, b)

    @property
    def n_clusters(self) -> int:
        return len(set(self.labels[self.labels >= 0]))

    def _neighbors(self, idx: int) -> np.ndarray:
        d = self._dist(self.X[idx][None], self.X)[0]
        return np.flatnonzero(d <= self.eps)

    def _is_core(self, idx: int) -> bool:
        return len(self._neighbors(idx)) >= self.min_samples

    def insert(self, x: np.ndarray) -> int:
        """Insert a point; returns its cluster label (NOISE possible)."""
        x = np.asarray(x, np.float64).reshape(1, -1)
        if self.X.size == 0:
            self.X = x
            self.labels = np.array([NOISE], np.int64)
            return NOISE
        self.X = np.vstack([self.X, x])
        self.labels = np.append(self.labels, NOISE)
        i = len(self.X) - 1

        nbrs = self._neighbors(i)
        # core points in the neighborhood after insertion (incl. upgrades)
        core_nbrs = [j for j in nbrs if self._is_core(j)]
        touched = sorted({int(self.labels[j]) for j in core_nbrs
                          if self.labels[j] != NOISE})
        if not core_nbrs:
            return NOISE
        if not touched:
            # brand-new cluster seeded by upgraded cores
            cid = self._next_cid
            self._next_cid += 1
        else:
            cid = touched[0]
            # merge any additional clusters connected through the new point
            for other in touched[1:]:
                self.labels[self.labels == other] = cid
        # absorb the new point + all density-reachable neighbors of new cores
        for j in core_nbrs:
            for kk in self._neighbors(j):
                if self.labels[kk] == NOISE:
                    self.labels[kk] = cid
        # the new point always joins cid here: either it is core itself or it
        # is a border point of a core neighbor (core_nbrs is non-empty)
        self.labels[i] = cid
        return int(self.labels[i])

    def fit_batch(self, X: np.ndarray) -> np.ndarray:
        for row in np.asarray(X, np.float64):
            self.insert(row)
        return self.labels
