"""RDP (moments) accountant for the Gaussian mechanism (paper's privacy
budget across federated rounds).

Pure Python, with the JAX package's arithmetic in the same order, so the
port's (epsilon, delta) reports equal the reference's exactly.

Every privatized client update is one release of the Gaussian mechanism with
sensitivity ``dp_clip`` and noise std ``noise_multiplier * dp_clip`` — i.e.
normalized noise multiplier sigma.  Its Renyi divergence at order alpha is

    RDP(alpha) = alpha / (2 * sigma^2)            (Mironov 2017, Prop. 7)

RDP composes additively across releases, so the accountant accumulates one
RDP vector (over a fixed grid of orders) per client and per server model,
then converts to (epsilon, delta) with

    epsilon(delta) = min_alpha [ RDP(alpha) + log(1/delta) / (alpha - 1) ]

Clients train on their full local dataset each round (no Poisson
subsampling), so no subsampling amplification is applied — the bound is
conservative if a subsampled variant ever lands.

Tracked granularities:
  * per client  — composition of every release of that client's data
    (all cluster models + the global model);
  * per model   — privacy of one server model w.r.t. a single client's data:
    the worst-case (max-epsilon) client among its contributors.
"""

from __future__ import annotations

import math
import threading
from collections import defaultdict

DEFAULT_ORDERS = (1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0,
                  10.0, 12.0, 16.0, 20.0, 24.0, 32.0, 48.0, 64.0)


def gaussian_rdp(noise_multiplier: float, order: float) -> float:
    """RDP of one Gaussian-mechanism release at one order (sensitivity 1,
    noise std = noise_multiplier)."""
    if noise_multiplier <= 0.0:
        return math.inf
    return order / (2.0 * noise_multiplier ** 2)


def rdp_to_epsilon(rdp, orders, delta: float) -> float:
    """Tightest epsilon over the order grid for a target delta."""
    if delta <= 0 or delta >= 1:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    eps = math.inf
    for r, a in zip(rdp, orders, strict=True):
        if a <= 1.0 or not math.isfinite(r):
            continue
        eps = min(eps, r + math.log(1.0 / delta) / (a - 1.0))
    return eps


class RDPAccountant:
    """Thread-safe accumulator of per-client / per-model RDP vectors."""

    def __init__(self, target_delta: float = 1e-5, orders=DEFAULT_ORDERS):
        self.target_delta = float(target_delta)
        self.orders = tuple(orders)
        self._lock = threading.Lock()
        zero = lambda: [0.0] * len(self.orders)
        self._client_rdp: dict[str, list] = defaultdict(zero)
        self._client_steps: dict[str, int] = defaultdict(int)
        # (model_key, client_id) -> rdp of that client's releases into it
        self._model_client_rdp: dict[tuple, list] = defaultdict(zero)
        self._model_client_steps: dict[tuple, int] = defaultdict(int)

    def record(self, client_id: str, model_key: str, noise_multiplier: float):
        """One privatized update from ``client_id`` into ``model_key``."""
        step = [gaussian_rdp(noise_multiplier, a) for a in self.orders]
        with self._lock:
            for vecs, key in ((self._client_rdp, client_id),
                              (self._model_client_rdp, (model_key, client_id))):
                acc = vecs[key]
                for i, r in enumerate(step):
                    acc[i] += r
            self._client_steps[client_id] += 1
            self._model_client_steps[(model_key, client_id)] += 1

    # ------------------------------------------------------------- reporting
    def client_epsilon(self, client_id: str, delta: float = None) -> float:
        delta = self.target_delta if delta is None else delta
        with self._lock:
            rdp = list(self._client_rdp.get(client_id) or [])
        if not rdp:
            return 0.0
        return rdp_to_epsilon(rdp, self.orders, delta)

    def client_report(self, delta: float = None) -> dict:
        delta = self.target_delta if delta is None else delta
        with self._lock:
            ids = list(self._client_rdp)
        return {cid: {"epsilon": self.client_epsilon(cid, delta),
                      "delta": delta,
                      "steps": self._client_steps[cid]} for cid in ids}

    def model_report(self, delta: float = None) -> dict:
        """Per server model: worst-case epsilon over contributing clients."""
        delta = self.target_delta if delta is None else delta
        with self._lock:
            items = {k: list(v) for k, v in self._model_client_rdp.items()}
            steps = dict(self._model_client_steps)
        out: dict = {}
        for (model_key, cid), rdp in items.items():
            eps = rdp_to_epsilon(rdp, self.orders, delta)
            cur = out.setdefault(model_key, {"epsilon": 0.0, "delta": delta,
                                             "worst_client": None, "steps": 0})
            cur["steps"] += steps[(model_key, cid)]
            if eps >= cur["epsilon"]:
                cur["epsilon"], cur["worst_client"] = eps, cid
        return out
