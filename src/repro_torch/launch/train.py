"""Training launcher.

Two entry modes:
  * ``--federated``: FedCCL end-to-end on the solar case study (the paper's
    deployment) -- clients, clustering, async rounds, Table-II style eval.
  * default: single-model LM training on synthetic data for a reduced
    assigned architecture (f32, head_dim 64: on the card the attention
    runs the f32 ``local_attn`` kernels forward and backward).

``--device`` picks the device (CUDA unless given); ``main(argv)`` runs in
process.  A multi-card run would start one process a GPU with a mesh
(``launch.mesh``); this launcher drives one device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.obs import clock


def train_lm(arch: str, steps: int, batch: int, seq: int, lr: float,
             log_every: int = 10, *, device=None):
    """Returns (final state, per-step losses as floats)."""
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.data.lm_synth import audio_batch, lm_batch, vlm_batch
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.training.train_step import build_train_step, init_train_state
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = reduced_for_smoke(get_config(arch))
    model = build_model(cfg)
    opt = adamw(warmup_cosine(lr, steps // 10 + 1, steps))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(model, opt, gen, dev)
    step_fn = build_train_step(model, cfg, opt)
    rng = np.random.default_rng(0)

    losses = []
    for i in range(steps):
        if cfg.family == "audio":
            b = audio_batch(rng, batch, seq, cfg.frontend.embed_dim, cfg.vocab_size)
        elif cfg.family == "vlm":
            b = vlm_batch(rng, batch, seq, 4, cfg.frontend.embed_dim, cfg.vocab_size)
        else:
            b = lm_batch(rng, batch, seq, cfg.vocab_size)
        state, metrics = step_fn(state, {k: torch.as_tensor(v, device=dev)
                                         for k, v in b.items()})
        losses.append(float(metrics["loss"]))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"ce {float(metrics['ce']):.4f}")
    return state, losses


def train_federated(n_sites: int, n_days: int, rounds: int, seed: int, *,
                    device=None):
    from repro_torch.training.fed_solar import run_fedccl_solar

    report = run_fedccl_solar(n_sites=n_sites, n_days=n_days, rounds=rounds,
                              seed=seed, device=device)
    print(json.dumps(report, indent=2, default=str))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--federated", action="store_true")
    ap.add_argument("--sites", type=int, default=9)
    ap.add_argument("--days", type=int, default=60)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    t0 = clock.monotonic()
    if args.federated:
        out = train_federated(args.sites, args.days, args.rounds, args.seed,
                              device=args.device)
    else:
        out = train_lm(args.arch, args.steps, args.batch, args.seq, args.lr,
                       device=args.device)
    print(f"[train] done in {clock.monotonic() - t0:.1f}s")
    return out


if __name__ == "__main__":
    main()
