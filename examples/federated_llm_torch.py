"""FedCCL over language models on the PyTorch port (``repro_torch``): the
same run, reduced configs and flags as ``examples/federated_llm.py``, with
the hand-written CUDA kernels on the GPU.  Four organisations in two
geographic clusters train a language model with AdamW (three steps a
round, the EWC anchor on) and the server folds their updates into the
cluster and global models; the eval loss of the global model must fall.

    PYTHONPATH=src python examples/federated_llm_torch.py [--arch mamba2-370m] [--device cpu]

The port has the dense and SSM families (gemma-2b, mamba2-370m);
``--arch deepseek-moe-16b`` raises the port's not-ported error (MoE is
``ROADMAP.md`` §1 item 6.3).  It runs on CUDA (and raises where there is
none) unless ``--device cpu`` is given; the CPU runs the kernels' plain
PyTorch versions.
"""

import argparse

import numpy as np
import torch

ARCHS = ("gemma-2b", "mamba2-370m")


def federate(arch: str, n_orgs: int = 4, rounds: int = 2, *, cfg=None,
             device=None) -> dict:
    """One federated run of ``arch`` (``reduced_for_smoke`` of its config
    unless ``cfg`` is given, e.g. the full config on the card).  Returns
    the run's stats and the global model's eval loss before and after."""
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.core.fedccl import ClusterSpaceConfig, FedCCL, FedCCLConfig
    from repro_torch.core.protocol import ClientSpec
    from repro_torch.data.lm_synth import lm_batch
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.training.train_step import (
        TrainState,
        build_eval_step,
        build_train_step,
    )
    from repro_torch.utils.device import resolve_device

    cfg = cfg or reduced_for_smoke(get_config(arch))
    model = build_model(cfg)
    dev = resolve_device(device)
    opt = adamw(2e-3)
    step = build_train_step(model, cfg, opt)
    eval_step = build_eval_step(model, cfg)
    eval_batch = lm_batch(np.random.default_rng(99), 4, 32, cfg.vocab_size)

    def train_fn(params, dataset, rng, anchor):
        state = TrainState(params, opt.init(params))
        for _ in range(3):
            b = lm_batch(rng, 4, 32, cfg.vocab_size, structure=1.0)
            state, _ = step(state, b)
        return state.params, 12, 1

    init_params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    loss0 = float(eval_step(init_params, eval_batch)["loss"])

    fed = FedCCL(FedCCLConfig(
        spaces=(ClusterSpaceConfig("loc", eps=150.0, min_samples=2,
                                   metric="haversine"),),
        ewc_lambda=0.01, seed=0), init_params, train_fn, device=dev)

    rng = np.random.default_rng(0)
    centers = [(48.2, 16.4), (52.5, 13.4)]
    specs = [ClientSpec(f"org{i}",
                        {"loc": np.array(centers[i % 2])
                         + rng.normal(0, 0.1, 2)}, None)
             for i in range(n_orgs)]
    fed.setup(specs)
    stats = fed.run(rounds=rounds)
    loss1 = float(eval_step(fed.store.params("global"), eval_batch)["loss"])
    print(f"{arch:20s} eval loss {loss0:.3f} -> {loss1:.3f}  "
          f"updates={stats['updates']} "
          f"staleness={stats['mean_staleness']:.2f} "
          f"fast_path={stats['fast_path_frac']:.2f}")
    assert loss1 < loss0, "federated training should reduce eval loss"
    return {"stats": stats, "loss0": loss0, "loss1": loss1, "fed": fed,
            "init_params": init_params}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="single arch id; default: one per family the port "
                         "has")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    for arch in [args.arch] if args.arch else ARCHS:
        federate(arch, device=args.device)


if __name__ == "__main__":
    main()
