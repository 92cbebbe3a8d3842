"""Cluster-parallel training -- FedCCL's cluster tier mapped onto the pod axis.

The paper's server trains K cluster models from asynchronous client
updates.  At datacenter scale the same computation becomes *synchronous
within a round*: each pod (mesh axis "pod") owns one cluster model and its
clients' shards; one step trains every cluster model (the stacked cluster
axis), and the global model is the sample-weighted FedAvg across the
cluster axis -- an all-reduce over "pod" on a multi-pod mesh, i.e.
Algorithm 2 as a collective schedule instead of an RPC pattern.

The reference maps its inner train step over the cluster axis with
``jax.vmap``.  ``torch.func.vmap`` cannot enter the kernels' C calls, so
``step`` runs the inner step once a cluster, on slice ``k`` of the stacked
state and batch, and stacks the new states and the (K,) metrics: the same
arithmetic as K independent steps.

The asynchronous protocol (core.protocol / runtimes) remains the
deployment-faithful path; this module is the throughput path when clusters
are co-scheduled on one fleet.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.optim.optimizers import Optimizer
from repro_torch.sharding.logical import Rules
from repro_torch.training.train_step import TrainState, build_train_step
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


class ClusterParallel:
    """K cluster models trained in lock-step, one per pod slice."""

    def __init__(self, model, cfg: ModelConfig, optimizer: Optimizer,
                 n_clusters: int, *, rules: Rules | None = None,
                 grad_clip: float = 1.0, n_microbatches: int | None = None):
        self.model = model
        self.cfg = cfg
        self.optimizer = optimizer
        self.n_clusters = n_clusters
        self.rules = rules
        self._inner = build_train_step(model, cfg, optimizer, rules=rules,
                                       grad_clip=grad_clip,
                                       n_microbatches=n_microbatches)

    def _stack(self, x):
        # a broadcast view: every cluster reads the same storage until its
        # first step (nothing in the port updates a tensor in place)
        return x[None].expand((self.n_clusters,) + tuple(x.shape))

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, device=None) -> TrainState:
        """Stacked state: every leaf gains a leading (K,) cluster axis.
        All clusters start from the same global initialization (the paper
        seeds cluster models from the global model).  CUDA unless the
        caller says."""
        params = self.model.init(generator, resolve_device(device))
        opt_state = self.optimizer.init(params)
        return TrainState(tree_map(self._stack, params),
                          tree_map(self._stack, opt_state))

    # ------------------------------------------------------------------ step
    def step(self, state: TrainState, batches: dict):
        """batches: every leaf (K, B_per_cluster, ...).  One synchronous
        FedCCL round for all K cluster models."""
        states, metrics = [], []
        for k in range(self.n_clusters):
            take = lambda x, k=k: x[k]
            new, m = self._inner(
                TrainState(tree_map(take, state.params),
                           tree_map(take, state.opt_state)),
                {key: torch.as_tensor(v)[k] for key, v in batches.items()})
            states.append(new)
            metrics.append(m)
        stack = lambda *xs: torch.stack(xs)
        new_state = TrainState(
            tree_map(stack, *(s.params for s in states)),
            tree_map(stack, *(s.opt_state for s in states)))
        return new_state, tree_map(stack, *metrics)    # metrics leaves: (K,)

    # ------------------------------------------------------------ global tier
    def global_params(self, state: TrainState, sample_counts):
        """Algorithm-2 sample-weighted FedAvg across the cluster axis --
        the global-model tier; an all-reduce over "pod" on a multi-pod
        mesh.  f32 weights and sums, cast back to each leaf's type."""
        w = torch.as_tensor(sample_counts, dtype=torch.float32)
        w = w / torch.clamp(w.sum(), min=1e-9)

        def avg(x):
            xf = x.to(torch.float32)
            return torch.tensordot(w.to(xf.device), xf,
                                   dims=([0], [0])).to(x.dtype)

        return tree_map(avg, state.params)

    def broadcast_global(self, state: TrainState, global_params) -> TrainState:
        """Optional periodic re-sync: reseed every cluster model from the
        global model (the continual 'pull' toward shared knowledge)."""
        return TrainState(tree_map(self._stack, global_params), state.opt_state)
