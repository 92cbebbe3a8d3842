"""The solar federation (FedCCL paper §III): sites train the LSTM
forecaster under the L2 anchor and the server folds their updates into a
global and per-cluster models.

Built from the program's public API as ``repro_torch.training.fed_solar``
builds it: ``make_solar_fns`` for the anchored SGD step, ``make_train_fn``
for a client's epochs, ``FedCCL`` with the workload file's clustering
spaces.  The fleet comes from the benchmark's own generator and the
weights from the seed, drawn on the card.

The check (``fedbench/checks.py``): the run's first client update (from
the benchmark's weights) and a sample of updates started in the window,
each computed again by ``reference/solar.py`` from the same starting
parameters (the program's snapshot: the reference cannot follow the
asynchronous federation itself), data and batch order; a sample of the
folds that the store made in the window; every model's metadata.
"""

from __future__ import annotations

import copy
import gc

import numpy as np
import torch

from fedbench import harness
from fedbench.reference import compare, solar as ref
from fedbench.traffic.solar_fleet import generate_fleet
from repro_torch.configs.solar_lstm import SolarLSTMConfig
from repro_torch.core.fedccl import FedCCL
from repro_torch.core.protocol import ClientSpec
from repro_torch.models.lstm import SolarForecaster
from repro_torch.sharding.logical import schema_shapes
from repro_torch.training.fed_solar import make_solar_fns, make_train_fn

ROUNDS = 10 ** 9        # more than any window holds; the window stops it


class Cell:
    def __init__(self, conf: dict, work: dict, seed: int, device, trace: bool):
        self.conf, self.work, self.seed = conf, work, seed
        self.device, self.trace = device, trace
        check = work["check"]
        self.rec = harness.Recorder(
            seed, check["updates"], check["folds"],
            sync=(torch.cuda.synchronize if device.type == "cuda" else None))
        self.fed = None

    # ------------------------------------------------------------- set-up
    def setup(self):
        m, t = self.conf["model"], self.conf["training"]
        fleet = generate_fleet(self.seed, **self.work["fleet"])
        forecaster = SolarForecaster(SolarLSTMConfig(
            hidden_size=m["hidden_size"],
            history_channels=m["history_channels"],
            forecast_channels=m["forecast_channels"]))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        init = harness.init_tree(schema_shapes(forecaster.schema()),
                                 self.conf["init"], gen, self.device)
        sgd_step, _ = make_solar_fns(forecaster, lr=t["lr"])
        rec = self.rec

        def step(params, batch, anchor):
            new, loss = sgd_step(params, batch, anchor)
            rec.step(int(batch["target"].shape[0]))
            sample = rec.current_sample()
            if sample is not None:
                sample["losses"].append(loss)
                sample.setdefault("after_first", new)
            return new, loss

        train_fn = make_train_fn(step, epochs=t["epochs_per_update"],
                                 batch_size=t["batch_size"])
        self.fed = FedCCL(harness.federation_config(self.work, t, self.seed,
                                                    self.trace),
                          init, rec.wrap_train_fn(train_fn, self._capture),
                          device=self.device)
        self.fed.setup([ClientSpec(s["id"],
                                   {"loc": np.array([s["lat"], s["lon"]]),
                                    "ori": np.array([s["azimuth"]])},
                                   s["train"]) for s in fleet])
        rec.instrument(self.fed)
        self.fed.run(rounds=1)          # warm-up: every shape, every path

    @staticmethod
    def _capture(params, dataset, rng, anchor):
        return {"params": params, "dataset": dataset,
                "rng": copy.deepcopy(rng.bit_generator.state),
                "anchor": None if anchor is None else anchor.anchor,
                "lam": 0.0 if anchor is None else anchor.lam}

    # ------------------------------------------------------------- window
    def window(self, seconds: float):
        harness.run_window(self.rec, seconds,
                           lambda: self.fed.run(rounds=ROUNDS))

    def stats(self) -> dict:
        return self.fed.store.agg_stats()

    def telemetry(self):
        return self.fed.metrics_report("json") if self.trace else None

    # -------------------------------------------------------------- check
    @staticmethod
    def start_of(s) -> list:
        return ref.leaves(s["params"])

    def program_of(self, s):
        lr = self.conf["training"]["lr"]
        grad = [(a.float() - b.float()) / lr for a, b in
                zip(ref.leaves(s["params"]), ref.leaves(s["after_first"]))]
        return ([float(x) for x in s["losses"]], compare.norms(grad),
                ref.leaves(s["out"]))

    def reference_of(self, s, precision, half_batch=False):
        t = self.conf["training"]
        losses, grad, final = ref.client_update(
            s["params"], s["anchor"], s["lam"], t["lr"], s["dataset"],
            s["rng"], t["batch_size"], t["epochs_per_update"], self.device,
            precision, half_batch)
        return [float(x) for x in losses], compare.norms(grad), final

    def free(self):
        if self.fed is not None:
            self.fed.shutdown()
            self.fed = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
