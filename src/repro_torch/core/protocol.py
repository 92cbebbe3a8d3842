"""FedCCL client protocol — paper Algorithm 1.

Each client, per training round:
  1. trains its local model on private data (with the continual-learning
     anchor, §II.E),
  2. for every cluster it belongs to: RequestModel -> TrainModel ->
     ComputeModelMetaDelta -> HandleModelUpdate,
  3. the same against the global model.

The client is runtime-agnostic; ``train_fn`` abstracts the optimization.
It must return new tensors and leave the ones it was given as they were:
clients share the initial parameters and the store's snapshots.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.aggregation import ModelMeta, UpdateDelta
from repro_torch.core.continual import EWCState, make_anchor
from repro_torch.core.store import ModelStore

# train_fn(params, dataset, rng, anchor: EWCState|None) ->
#     (new_params, n_samples, n_epochs)
TrainFn = Callable


def build_update(fetched_meta: ModelMeta, new_params, n_samples: int,
                 n_epochs: int = 1):
    """ComputeModelMetaDelta: package one trained model into the
    ``(params, updated_meta, delta)`` triple the server folds
    (``round = fetched.round + 1``)."""
    updated_meta = ModelMeta(
        samples_learned=n_samples,
        epochs_learned=fetched_meta.epochs_learned + n_epochs,
        round=fetched_meta.round + 1)
    return new_params, updated_meta, UpdateDelta(n_samples, n_epochs, 1)


@dataclass
class ClientSpec:
    client_id: str
    static_features: dict            # {"loc": np.array([lat, lon]), "ori": ...}
    dataset: object                  # opaque to the protocol
    speed: float = 1.0               # relative training speed (async sim)


@dataclass
class Client:
    spec: ClientSpec
    cluster_keys: list               # e.g. ["loc:2", "ori:0"]
    train_fn: TrainFn
    ewc_lambda: float = 0.0
    rng: np.random.Generator = field(default_factory=lambda: np.random.default_rng(0))

    local_params: object = None
    local_meta: ModelMeta = field(default_factory=ModelMeta)
    _local_anchor: EWCState | None = None

    # ------------------------------------------------------------ local tier
    def train_local(self):
        if self.local_params is None:
            raise RuntimeError("seed the client's local model first")
        anchor = self._local_anchor if self.ewc_lambda else None
        new_params, n_samples, n_epochs = self.train_fn(
            self.local_params, self.spec.dataset, self.rng, anchor)
        self.local_params = new_params
        self.local_meta = self.local_meta.accumulate(
            UpdateDelta(n_samples, n_epochs, 1))
        if self.ewc_lambda:
            self._local_anchor = make_anchor(new_params, lam=self.ewc_lambda)
        return n_samples

    # ----------------------------------------------------- shared-tier round
    def fetch(self, store: ModelStore, level: str, cluster_key=None):
        """RequestModel: snapshot the shared model (start of async round)."""
        return store.request_model(level, cluster_key)

    def train_update(self, fetched_params, fetched_meta: ModelMeta):
        """TrainModel + ComputeModelMetaDelta on a fetched snapshot."""
        anchor = (make_anchor(fetched_params, lam=self.ewc_lambda)
                  if self.ewc_lambda else None)
        new_params, n_samples, n_epochs = self.train_fn(
            fetched_params, self.spec.dataset, self.rng, anchor)
        return build_update(fetched_meta, new_params, n_samples, n_epochs)

    def submit(self, store: ModelStore, level: str, cluster_key,
               new_params, updated_meta, delta) -> bool:
        return store.handle_model_update(level, cluster_key, new_params,
                                         updated_meta, delta)
