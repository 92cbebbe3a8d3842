"""Faults planted in the program's timed path, for the tests that see
``correct`` come out false: a step that returns its state unchanged, half
of the batch left out (the mean taken over the rest), an update altered
where the client produces it, a fold altered where the server produces
it, and a fold that leaves the model as it was."""

from repro_torch.core import aggregation, store
from repro_torch.training import fed_solar
from repro_torch.training import train_step as ts

CLIENT = ("unchanged", "half_batch", "altered_update")
SERVER = ("altered_fold", "dropped_fold")


def solar_step(monkeypatch, fault):
    make = fed_solar.make_solar_fns

    def broken(forecaster, lr=5e-3):
        sgd, predict = make(forecaster, lr=lr)

        def step(params, batch, anchor):
            if fault == "half_batch":
                n = max(1, batch["target"].shape[0] // 2)
                batch = {k: v[:n] for k, v in batch.items()}
            new, loss = sgd(params, batch, anchor)
            if fault == "unchanged":
                return params, loss
            if fault == "altered_update":
                new = dict(new, head_b=new["head_b"] + 0.05)
            return new, loss

        return step, predict

    monkeypatch.setattr(fed_solar, "make_solar_fns", broken)


def lm_step(monkeypatch, fault):
    build = ts.build_train_step

    def broken(*a, **kw):
        step = build(*a, **kw)

        def wrapped(state, batch):
            if fault == "half_batch":
                n = max(1, len(batch["tokens"]) // 2)
                batch = {k: v[:n] for k, v in batch.items()}
            new, metrics = step(state, batch)
            if fault == "unchanged":
                return ts.TrainState(state.params, new.opt_state), metrics
            if fault == "altered_update":
                p = dict(new.params, embed=new.params["embed"] * 1.05)
                return ts.TrainState(p, new.opt_state), metrics
            return new, metrics

        return wrapped

    monkeypatch.setattr(ts, "build_train_step", broken)


def fold(monkeypatch, fault):
    if fault == "altered_fold":
        agg = aggregation.aggregate_pytrees

        def scaled(trees, weights):
            out = agg(trees, weights)
            return {k: (v if isinstance(v, dict) else v * 1.25)
                    for k, v in out.items()}

        monkeypatch.setattr(aggregation, "aggregate_pytrees", scaled)
        return

    def pair(base, bmeta, params, meta, delta,
             cfg=aggregation.AggregationConfig()):
        return base, bmeta.accumulate(delta)

    def many(base, bmeta, updates, cfg=aggregation.AggregationConfig()):
        updates = list(updates)
        plan = aggregation.plan_coalesce(
            bmeta, [(m, d) for _, m, d in updates], cfg)
        return aggregation.CoalesceResult(base, plan.meta, len(updates), 1,
                                          plan.n_fast_path)

    monkeypatch.setattr(store, "aggregate_models", pair)
    monkeypatch.setattr(store, "coalesced_aggregate", many)


def plant(monkeypatch, driver, fault):
    if fault in SERVER:
        fold(monkeypatch, fault)
    elif driver == "solar":
        solar_step(monkeypatch, fault)
    else:
        lm_step(monkeypatch, fault)
