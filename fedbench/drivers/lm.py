"""A language model federated with FedCCL (the paper's model-agnostic
claim; ``examples/federated_llm_torch.py``): organisations in location
clusters fine-tune one model, each update a few AdamW steps from fresh
moments on the organisation's own token rows, and the server folds the
updates into the cluster and global models.

Built from the program's public API: ``build_model`` and its parameter
shapes, ``adamw`` and ``build_train_step`` for the step, ``FedCCL`` on
the deterministic sim runtime.  The train_fn is the benchmark's own copy
of the example's pattern, with the device synchronised at its end so that
its span holds its work.  Weights come from the seed, drawn on the card in
two calls; token rows from the benchmark's own generator.

The check: the first update of the run (from the benchmark's weights) and
a sample of updates started in the window, each computed again by
``reference/mamba2.py`` from the same start (the program's snapshot: the
reference cannot follow the federation itself) and the same rows; a
sample of the folds that the store made in the window, against
``reference/fold.py``; every model's metadata.
"""

from __future__ import annotations

import copy
import dataclasses
import gc

import numpy as np
import torch

from fedbench import harness
from fedbench.reference import compare, mamba2 as ref
from fedbench.traffic.lm_tokens import lm_batch, zipf_probs
from repro_torch.configs import get_config
from repro_torch.core.fedccl import FedCCL
from repro_torch.core.protocol import ClientSpec
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import adamw
from repro_torch.training.train_step import TrainState, build_train_step

ROUNDS = 10 ** 9
SSM_KEYS = ("d_state", "head_dim", "expand", "chunk_size", "n_groups",
            "conv_width")


def port_config(m: dict):
    """The program's config of the file's model: its published config with
    the file's sizes; the file is the authority."""
    base = get_config(m["arch"])
    ssm = dataclasses.replace(base.ssm, **{k: m[k] for k in SSM_KEYS})
    return base.replace(n_layers=m["n_layers"], d_model=m["d_model"],
                        vocab_size=m["vocab_size"], ssm=ssm,
                        tie_embeddings=m["tie_embeddings"], dtype=m["dtype"],
                        norm_eps=m["norm_eps"])


class Cell:
    def __init__(self, conf: dict, work: dict, seed: int, device, trace: bool):
        self.conf, self.work, self.seed = conf, work, seed
        self.device, self.trace = device, trace
        self.on_card = device.type == "cuda"
        check = work["check"]
        self.rec = harness.Recorder(
            seed, check["updates"], check["folds"],
            sync=torch.cuda.synchronize if self.on_card else None)
        self.fed = None

    def setup(self):
        m, t, w = self.conf["model"], self.conf["training"], self.work
        up = w["update"]
        cfg = port_config(m)
        model = build_model(cfg)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.init = harness.init_tree(model.param_shapes(), self.conf["init"],
                                      gen, self.device)
        opt = adamw(t["lr"], b1=t["b1"], b2=t["b2"], eps=t["eps"],
                    moment_dtype=getattr(torch, t["moment_dtype"]))
        step = build_train_step(model, cfg, opt, grad_clip=t["grad_clip"])
        probs = zipf_probs(m["vocab_size"])
        rec, on_card = self.rec, self.on_card
        rows, seq, n_steps = up["batch"], up["seq"], up["steps"]

        def train_fn(params, dataset, rng, anchor):
            state = TrainState(params, opt.init(params))
            sample = rec.current_sample()
            for i in range(n_steps):
                batch = lm_batch(rng, rows, seq, m["vocab_size"],
                                 up["structure"], probs)
                state, metrics = step(state, batch)
                rec.step(rows * seq)
                if sample is not None:
                    sample["losses"].append(metrics["loss"])
                    if i == 0:
                        sample["m1"] = torch.stack([
                            torch.linalg.vector_norm(x.float()) for _, x in
                            ref.leaf_slices(state.opt_state["m"],
                                            m["n_layers"])])
            if on_card:
                torch.cuda.synchronize()
            return state.params, n_steps * rows, 1

        self.train_fn = rec.wrap_train_fn(train_fn, self._capture)
        self.fed = FedCCL(harness.federation_config(w, t, self.seed,
                                                    self.trace),
                          self.init, self.train_fn, device=self.device)
        orgs = w["organisations"]
        rng = np.random.default_rng(self.seed)
        self.fed.setup([ClientSpec(f"org{i}", {"loc": np.array(
            orgs["centers"][i % len(orgs["centers"])])
            + rng.normal(0, orgs["spread_deg"], 2)}, None)
            for i in range(orgs["count"])])
        rec.instrument(self.fed)
        # warm-up: one update of the window's shapes from the weights
        self.train_fn(self.init, None, np.random.default_rng(self.seed + 1),
                      None)

    @staticmethod
    def _capture(params, dataset, rng, anchor):
        return {"params": params,
                "rng": copy.deepcopy(rng.bit_generator.state)}

    def window(self, seconds: float):
        harness.run_window(self.rec, seconds,
                           lambda: self.fed.run(rounds=ROUNDS))

    def stats(self) -> dict:
        return self.fed.store.agg_stats()

    def telemetry(self):
        return self.fed.metrics_report("json") if self.trace else None

    @staticmethod
    def _slices(tree, n_layers) -> list:
        return [x for _, x in ref.leaf_slices(tree, n_layers)]

    def start_of(self, s) -> list:
        return self._slices(s["params"], self.conf["model"]["n_layers"])

    def program_of(self, s):
        b1 = self.conf["training"]["b1"]
        return ([float(x) for x in s["losses"]],
                [x / (1 - b1) for x in s["m1"].double().tolist()],
                self._slices(s["out"], self.conf["model"]["n_layers"]))

    def reference_of(self, s, precision, half_batch=False):
        m, t, up = (self.conf["model"], self.conf["training"],
                    self.work["update"])
        rng = np.random.default_rng()
        rng.bit_generator.state = s["rng"]
        probs = zipf_probs(m["vocab_size"])
        batches = []
        for _ in range(up["steps"]):
            b = lm_batch(rng, up["batch"], up["seq"], m["vocab_size"],
                         up["structure"], probs)
            batches.append((b["tokens"], b["labels"]))
        cfg = {k: m[k] for k in ("n_layers", "d_model", "norm_eps",
                                 *SSM_KEYS)}
        losses, grad, final = ref.client_update(
            ref.leaf_slices(s["params"], m["n_layers"]), batches, cfg,
            t["lr"], t["grad_clip"], t["b1"], t["b2"], t["eps"], precision,
            half_batch)
        return [float(x) for x in losses], compare.norms(grad), final

    def free(self):
        if self.fed is not None:
            self.fed.shutdown()
            self.fed = None
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()
