"""Serving launcher: batched generation with a KV-cached decode loop on a
reduced assigned architecture (the full-scale decode path is what the
decode dry-runs place on the production mesh).

``--device`` picks the device (CUDA unless given); ``main(argv)`` runs in
process and returns the generated tokens.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.obs import clock


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = reduced_for_smoke(get_config(args.arch))
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    engine = ServeEngine(model, params,
                         max_len=args.prompt_len + args.new_tokens + 1,
                         temperature=args.temperature)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    t0 = clock.monotonic()
    out = engine.generate(prompts, args.new_tokens)
    dt = clock.monotonic() - t0
    tok_s = args.batch * args.new_tokens / dt
    print(f"[serve] arch={args.arch} batch={args.batch} "
          f"new={args.new_tokens} tokens  {dt:.2f}s  ({tok_s:.1f} tok/s)")
    print(out[:, :16])
    return out


if __name__ == "__main__":
    main()
