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
from repro_torch.utils.tree import flatten_params, unflatten_params

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
    # DP update privatization hook (repro_torch.privacy.dp.DPPrivatizer);
    # when set, every shared-tier update delta is clipped + noised before
    # submission
    privatizer: object | None = None

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
    def fetch(self, store: ModelStore, level: str, cluster_key=None, *,
              fetcher=None):
        """RequestModel: snapshot the shared model (start of async round).
        With a ``fetcher`` (``repro_torch.core.fetch.FetchClient``) the
        snapshot comes through the read tier instead, from the shard
        servers where the topology allows; both give the same bytes."""
        if fetcher is not None:
            return fetcher.fetch(level, cluster_key)
        return store.request_model(level, cluster_key)

    def train_update(self, fetched_params, fetched_meta: ModelMeta,
                     model_key: str = "__global__", *, privatize: bool = True):
        """TrainModel + ComputeModelMetaDelta on a fetched snapshot.

        With a ``privatizer`` attached the raw trained parameters never leave
        this method: the update delta is clipped + noised first, and the
        release is recorded against ``model_key`` in the RDP accountant.
        ``privatize=False`` defers DP to the caller — the secure path
        privatizes the flat delta directly, avoiding a tree round trip."""
        anchor = (make_anchor(fetched_params, lam=self.ewc_lambda)
                  if self.ewc_lambda else None)
        new_params, n_samples, n_epochs = self.train_fn(
            fetched_params, self.spec.dataset, self.rng, anchor)
        if privatize and self.privatizer is not None:
            new_params = self.privatizer.privatize(fetched_params, new_params,
                                                   model_key=model_key)
        return build_update(fetched_meta, new_params, n_samples, n_epochs)

    def submit(self, store: ModelStore, level: str, cluster_key,
               new_params, updated_meta, delta) -> bool:
        return store.handle_model_update(level, cluster_key, new_params,
                                         updated_meta, delta)

    # -------------------------------------------- secure-aggregation round
    def secure_round_update(self, store: ModelStore, level: str, cluster_key,
                            expected_ids, round_id: int):
        """One shared-tier step under secure aggregation: fetch -> train
        (+DP privatization) -> pairwise-mask the weighted delta -> submit.
        ``expected_ids`` is the round's full member set for this model; the
        masks are derived against all of them so dropouts are recoverable
        via seed reconstruction at drain time."""
        if store.masker is None:
            raise RuntimeError("a secure round needs a masker on the store")
        model_key = store.model_key(level, cluster_key)
        fetched, meta = self.fetch(store, level, cluster_key)
        new_params, _, delta = self.train_update(fetched, meta,
                                                 model_key=model_key,
                                                 privatize=False)
        # privatize + mask in one flat-domain pass (no tree round trips)
        delta_flat = flatten_params(new_params) - flatten_params(fetched)
        if self.privatizer is not None:
            delta_flat = self.privatizer.privatize_delta(delta_flat, model_key)
        masked = unflatten_params(
            store.masker.mask_delta_flat(
                delta_flat, self.spec.client_id, expected_ids, round_id,
                model_key, weight=delta.samples_learned),
            fetched)
        store.submit_secure(level, cluster_key, self.spec.client_id,
                            round_id, masked, delta)
        return delta

    # ------------------------------------------------- one full Alg.1 round
    def full_round(self, store: ModelStore):
        """Synchronous-in-client convenience: local + all clusters + global.
        The async runtimes interleave fetch/submit instead of calling this."""
        self.train_local()
        for key in self.cluster_keys:
            p, m = self.fetch(store, "cluster", key)
            store_args = self.train_update(p, m, store.model_key("cluster", key))
            self.submit(store, "cluster", key, *store_args)
        p, m = self.fetch(store, "global", None)
        store_args = self.train_update(p, m, store.model_key("global"))
        self.submit(store, "global", None, *store_args)
