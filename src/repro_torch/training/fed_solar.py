"""FedCCL on the solar case study — the paper's §III/§IV experiment.

Builds a synthetic central-European fleet, clusters it by location and
panel orientation, runs the asynchronous FedCCL protocol, trains the two
centralized baselines, and produces a Table-II-shaped report:

  columns: CentralizedAll / CentralizedContinual / FederatedGlobal /
           FederatedLocation / FederatedOrientation / FederatedLocal
  rows:    mean/max power error, mean energy error, daytime variants

plus the §IV.E population-independent evaluation on held-out sites.

On CUDA every LSTM scan (one launch forward, one backward), every server
fold, every anchored SGD update and every DP release runs through the
port's hand-written kernels (``repro_torch.kernels``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.solar_lstm import SolarLSTMConfig
from repro_torch.core.continual import EWCState, ewc_adjusted_gradient
from repro_torch.core.fedccl import ClusterSpaceConfig, FedCCL, FedCCLConfig
from repro_torch.core.protocol import ClientSpec
from repro_torch.data.solar import generate_fleet
from repro_torch.data.windows import batch_iter, make_windows, split_windows
from repro_torch.models.lstm import SolarForecaster
from repro_torch.training.losses import solar_loss
from repro_torch.training.metrics import summarize_errors
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import (
    flatten_params,
    params_from_numpy,
    tree_leaves,
    tree_map,
    unflatten_params,
)

# ---------------------------------------------------------------------------
# train / predict for the forecaster
# ---------------------------------------------------------------------------


def make_solar_fns(forecaster: SolarForecaster, lr: float = 5e-3):
    """``sgd_step(params, batch, anchor) -> (new_params, task_loss)`` and
    ``predict(params, history, forecast) -> (b, 96)``.

    ``anchor`` is None or an ``EWCState`` whose ``anchor`` is the flat
    anchor vector.  The step takes the task gradient through the LSTM
    ``autograd.Function``, adds the anchor gradient ``lam * (p - anchor)``
    with the ewc_update kernel (F = 1, L2-SP) and returns ``p - lr * g`` as
    new tensors — the same update as the reference's autodiff of
    ``loss + 0.5 * lam * sum (p - anchor)^2``.  The given params are left
    as they were."""

    def sgd_step(params, batch, anchor: EWCState | None):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = solar_loss(forecaster, live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        g = torch.cat([x.reshape(-1) for x in grads])
        p = flatten_params(params)
        if anchor is not None:
            g, _ = ewc_adjusted_gradient(g, p, anchor)
        return unflatten_params(p - lr * g, params), loss.detach()

    @torch.no_grad()
    def predict(params, history, forecast):
        return forecaster.forward(params, history, forecast)

    return sgd_step, predict


def make_train_fn(sgd_step, *, epochs: int = 3, batch_size: int = 8):
    """Adapts the SGD step into the FedCCL protocol's train_fn.  Batches
    move to the device the params lie on."""

    def train_fn(params, dataset, rng: np.random.Generator, anchor):
        windows = dataset
        n = len(windows["target"])
        device = tree_leaves(params)[0].device
        flat_anchor = (EWCState(flatten_params(anchor.anchor), None,
                                anchor.lam) if anchor is not None else None)
        for _ in range(epochs):
            for batch in batch_iter(windows, batch_size, rng):
                tb = {k: torch.from_numpy(batch[k]).to(device)
                      for k in ("history", "forecast", "target")}
                params, _ = sgd_step(params, tb, flat_anchor)
        return params, n * epochs, epochs

    return train_fn


# ---------------------------------------------------------------------------
# the experiment
# ---------------------------------------------------------------------------

# the federation's clustering spaces: sites by location and by orientation
SOLAR_SPACES = (
    ClusterSpaceConfig("loc", eps=120.0, min_samples=2, metric="haversine"),
    ClusterSpaceConfig("ori", eps=30.0, min_samples=2, metric="cyclic"))


def run_fedccl_solar(n_sites: int = 9, n_days: int = 60, rounds: int = 3,
                     seed: int = 0, hidden: int = 64, epochs: int = 3,
                     n_independent: int = 2, ewc_lambda: float = 0.05,
                     lr: float = 1e-2, eval_sites: str = "all",
                     dp_clip: float = None, dp_noise_multiplier: float = 1.0,
                     secure_agg: bool = False,
                     target_delta: float = 1e-5, *, device=None,
                     init_params=None, runtime: str = "sim") -> dict:
    """One experimental run.  Returns the Table-II-shaped report dict.

    ``device`` defaults to CUDA and raises when there is none.
    ``init_params`` (a tree of numpy arrays, e.g. JAX params through
    ``np.asarray``) replaces the port's own initialisation, which cannot
    reproduce JAX's PRNG.  ``runtime`` is ``FedCCLConfig.runtime``: the
    deterministic "sim" or "threaded" (client threads; ``async_stats`` is
    then the store's ``agg_stats()``).  With ``dp_clip`` / ``secure_agg``
    set, client updates are privatized (clip + Gaussian noise) and/or
    aggregated under pairwise masking; the report's ``privacy`` section
    then carries (epsilon, delta) budgets.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    fleet = generate_fleet(n_sites=n_sites + n_independent, n_days=n_days,
                           seed=seed)
    train_fleet, indep_fleet = fleet[:n_sites], fleet[n_sites:]

    cfg = SolarLSTMConfig(hidden_size=hidden)
    forecaster = SolarForecaster(cfg)
    if init_params is None:
        init_params = forecaster.init(torch.Generator().manual_seed(seed),
                                      device)
    else:
        init_params = params_from_numpy(init_params, device)
    sgd_step, predict_t = make_solar_fns(forecaster, lr=lr)
    train_fn = make_train_fn(sgd_step, epochs=epochs)

    def predict(params, history, forecast):
        return predict_t(params, torch.from_numpy(history).to(device),
                         torch.from_numpy(forecast).to(device)).cpu().numpy()

    # ---- per-site windows + split
    site_splits = {}
    for site, data in fleet:
        tr, te = split_windows(make_windows(data), train_frac=0.8)
        site_splits[site.site_id] = (site, tr, te)

    # ---- FedCCL federation over the training population
    fed_cfg = FedCCLConfig(
        spaces=SOLAR_SPACES, ewc_lambda=ewc_lambda, seed=seed, runtime=runtime,
        dp_clip=dp_clip, dp_noise_multiplier=dp_noise_multiplier,
        secure_agg=secure_agg, target_delta=target_delta)
    fed = FedCCL(fed_cfg, init_params, train_fn, device=device)
    specs = [ClientSpec(site.site_id, site.static_features,
                        site_splits[site.site_id][1],
                        speed=float(rng.uniform(0.5, 2.0)))
             for site, _ in train_fleet]
    assignments = fed.setup(specs)
    stats = fed.run(rounds=rounds)

    # ---- centralized baselines -------------------------------------------
    def concat(ws):
        return {k: np.concatenate([w[k] for w in ws]) for k in ws[0]}

    all_train = concat([site_splits[s.site_id][1] for s, _ in train_fleet])
    cen_all = init_params
    crng = np.random.default_rng(seed + 1)
    for _ in range(rounds):
        cen_all, _, _ = train_fn(cen_all, all_train, crng, None)

    cen_cont = init_params
    crng2 = np.random.default_rng(seed + 2)
    for _ in range(rounds):
        for s, _ in train_fleet:                     # sites arrive progressively
            cen_cont, _, _ = train_fn(cen_cont, site_splits[s.site_id][1],
                                      crng2, None)

    # ---- evaluation --------------------------------------------------------
    def site_errors(params, site):
        _, _, te = site_splits[site.site_id]
        preds = predict(params, te["history"], te["forecast"])
        return summarize_errors(preds, te["target"], te["minute"])

    def mean_rows(per_site):
        return {k: float(np.mean([p[k] for p in per_site]))
                for k in per_site[0]}

    def eval_model(params, sites):
        return mean_rows([site_errors(params, site) for site, _ in sites])

    def cluster_model_for(client_id, namespace):
        keys = [k for k in assignments[client_id] if k.startswith(namespace)]
        return fed.store.params("cluster", keys[0]) if keys else \
            fed.store.params("global")

    def eval_fed_cluster(namespace, sites):
        return mean_rows([
            site_errors(cluster_model_for(site.site_id, namespace)
                        if site.site_id in assignments
                        else fed.store.params("global"), site)
            for site, _ in sites])

    def eval_fed_local(sites):
        return mean_rows([
            site_errors(next(c for c in fed.clients
                             if c.spec.client_id == site.site_id).local_params,
                        site)
            for site, _ in sites])

    table2 = {
        "CentralizedAll": eval_model(cen_all, train_fleet),
        "CentralizedContinual": eval_model(cen_cont, train_fleet),
        "FederatedGlobal": eval_model(fed.store.params("global"), train_fleet),
        "FederatedLocation": eval_fed_cluster("loc", train_fleet),
        "FederatedOrientation": eval_fed_cluster("ori", train_fleet),
        "FederatedLocal": eval_fed_local(train_fleet),
    }

    # ---- §IV.E population-independent (Predict phase for unseen sites) ----
    indep = {}
    if indep_fleet:
        # Global model on unseen sites
        indep["FederatedGlobal"] = eval_model(fed.store.params("global"),
                                              indep_fleet)
        # Predict & Evolve: assign clusters via incremental DBSCAN
        for namespace, col in (("loc", "FederatedLocation"),
                               ("ori", "FederatedOrientation")):
            per_site = []
            for site, _ in indep_fleet:
                keys, params = fed.pe.join(
                    ClientSpec(site.site_id + f"-join-{namespace}",
                               site.static_features,
                               site_splits[site.site_id][1]))
                keys = [k for k in keys if k.startswith(namespace)]
                params = (fed.store.params("cluster", keys[0]) if keys
                          else fed.store.params("global"))
                per_site.append(site_errors(params, site))
            indep[col] = mean_rows(per_site)

    # ---- Fig. 4/5 analogs: example day predictions (centroid-nearest site,
    # paper's test-site selection rule) --------------------------------------
    def _centroid_site(sites):
        lats = np.array([s.lat for s, _ in sites])
        lons = np.array([s.lon for s, _ in sites])
        c = np.array([lats.mean(), lons.mean()])
        d = (lats - c[0]) ** 2 + (lons - c[1]) ** 2
        return sites[int(np.argmin(d))][0]

    fig4_site = _centroid_site(train_fleet)
    _, _, te4 = site_splits[fig4_site.site_id]
    loc_params = cluster_model_for(fig4_site.site_id, "loc")
    fig4 = {
        "site": fig4_site.site_id,
        "minute": te4["minute"][0].tolist(),
        "actual": te4["target"][0].tolist(),
        "predicted": predict(loc_params, te4["history"][:1],
                             te4["forecast"][:1])[0].tolist(),
    }

    return {
        "table2": table2,
        "independent": indep,
        "clusters": {k: v for k, v in assignments.items()},
        "async_stats": stats,
        "privacy": fed.privacy_report(),
        "fig4_example": fig4,
        "config": {"n_sites": n_sites, "n_days": n_days, "rounds": rounds,
                   "hidden": hidden, "seed": seed,
                   "ewc_lambda": ewc_lambda, "dp_clip": dp_clip,
                   "dp_noise_multiplier": dp_noise_multiplier,
                   "secure_agg": secure_agg},
    }
