"""Batched serving on the PyTorch port (``repro_torch``): the same run as
``examples/serve_batched.py``.  KV-cached decode across architecture
families (dense GQA cache, MoE + MLA latent cache, SSM constant state,
hybrid RG-LRU + rolling local window), then continuous batching of
requests of different lengths.

    PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]

Weights are random from seed 0 (a ``torch.Generator``, so they differ from
the JAX example's draws).  It runs on CUDA (and raises where there is
none) unless ``--device cpu`` is given.  Decoding runs no kernel: it
attends over the cache in plain PyTorch, as the reference's does.
"""

import argparse
import time

import numpy as np

ARCHS = ["gemma-2b", "deepseek-v3-671b", "mamba2-370m", "recurrentgemma-9b"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(args.device)

    def engine(arch):
        cfg = reduced_for_smoke(get_config(arch))
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        return ServeEngine(model, params, max_len=96), cfg

    rng = np.random.default_rng(0)
    out = {}
    for arch in ARCHS:
        eng, cfg = engine(arch)
        prompts = rng.integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)
        t0 = time.time()
        gen = eng.generate(prompts, 48)
        dt = time.time() - t0
        out[arch] = gen
        print(f"{arch:20s} generated {gen.shape[0]}x{gen.shape[1]} tokens "
              f"in {dt:5.2f}s ({gen.shape[0] * gen.shape[1] / dt:6.1f} tok/s) "
              f"sample: {gen[0, :8].tolist()}")

    # continuous batching: requests of different lengths share one decode
    # loop, each sequence at its own KV-cache offset (pos is a vector)
    eng, cfg = engine("gemma-2b")
    reqs = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in (5, 11, 23)]
    ragged = eng.generate_ragged(reqs, 16)
    out["ragged"] = ragged
    print(f"continuous-batching   3 ragged requests (len 5/11/23) -> "
          f"{ragged.shape[1]} new tokens each; sample: "
          f"{ragged[:, :6].tolist()}")
    return out


if __name__ == "__main__":
    main()
