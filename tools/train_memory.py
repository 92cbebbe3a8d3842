"""How deep each LLM config trains at full width on one card, by remat.

    python3 tools/train_memory.py [--archs deepseek-moe-16b,...]
                                  [--remats full,none] [--steps 2]
                                  [--start hubert-xlarge=48,...] [--only]
                                  [--lr X] [--fixed-segments]

The configs of ``chip_smoke.REMAT_TRAIN`` by default: the MoE, hybrid,
audio and VLM families (deepseek-moe-16b, recurrentgemma-9b,
hubert-xlarge, internvl2-76b) and the dense configs at D 128
(deepseek-7b, glm4-9b, granite-8b).  For each config and each remat,
``chip_smoke.train_steps``' step (full width, the config's bf16, AdamW
with bf16 moments at ``--lr``, the config's batch of
``chip_smoke.LLM_TRAIN``: 2 x 2048 for the three dense ones) at growing
depths, one whole repeated unit at a time (recurrentgemma's (rec, rec,
attn) group; deepseek-moe keeps its dense first layer), from the unit's
smallest depth (or ``--start``'s; hubert-xlarge's full 48 by default)
up to the config's own depth or the
first out-of-memory (``--only``: the start depth alone).  Each depth
prints its peak memory over ``--steps`` steps and at the start of the
update (the forward's and backward's peak, ``chip_smoke.step_parts``),
the last step's wall time and each step's loss, or where the
out-of-memory struck (forward, backward, or the AdamW update) and what
was allocated then; each config and remat the deepest depth whose peak
leaves ``chip_smoke.TRAIN_SPARE_GIB`` of the card free.  Then the card's
name and power limit.  All in one process, the cache emptied between
depths, the allocator's segments expandable (``--fixed-segments``: not),
as the smoke runs them.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
START = "hubert-xlarge=48"


def one_depth(dev, arch, remat, depth, steps, lr, at) -> dict:
    import numpy as np
    import torch

    import chip_smoke as s
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import TrainState, build_train_step

    rec = {"arch": arch, "remat": remat, "depth": depth}
    peak = grad_peak = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        at.part = "init"
        cfg, model, params = s.llm_model(arch, dev, depth=depth)
        cfg = cfg.replace(remat=remat)
        b, seq = s.LLM_TRAIN[arch]
        data = s.llm_batch(cfg, np.random.default_rng(4), b, seq,
                           structure=1.0)
        opt = adamw(lr, moment_dtype=torch.bfloat16)
        step = build_train_step(build_model(cfg), cfg, opt)
        state = TrainState(params, opt.init(params))
        del params
        for _ in range(steps):
            peak = max(peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            at.grad_peak = None
            t0 = time.perf_counter()
            state, metrics = step(state, data)
            torch.cuda.synchronize()
            rec["step_s"] = time.perf_counter() - t0
            grad_peak = max(grad_peak, at.grad_peak)
            rec.setdefault("losses", []).append(metrics["loss"].item())
    except torch.OutOfMemoryError as e:
        rec.update(oom=at.part, message=str(e).split(". ")[0],
                   allocated_gib=torch.cuda.memory_allocated() / 2**30)
    rec["peak_gib"] = max(peak, torch.cuda.max_memory_allocated()) / 2**30
    if grad_peak:
        rec["grad_peak_gib"] = grad_peak / 2**30
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="deepseek-moe-16b,recurrentgemma-9b,"
                                       "hubert-xlarge,internvl2-76b,"
                                       "deepseek-7b,glm4-9b,granite-8b")
    ap.add_argument("--remats", default="full,none")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--start", default=START)
    ap.add_argument("--lr", type=float, default=None,
                    help="AdamW's rate (default: chip_smoke.TRAIN_LR)")
    ap.add_argument("--only", action="store_true",
                    help="the start depth alone")
    ap.add_argument("--fixed-segments", action="store_true",
                    help="the allocator's fixed segments (the smoke's "
                         "families run with expandable ones)")
    args = ap.parse_args(argv)
    start = {a: int(d) for a, d in (kv.split("=") for kv in
                                    filter(None, args.start.split(",")))}
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch

    import chip_smoke as s
    from repro_torch.configs import get_config

    if not torch.cuda.is_available():
        print("train_memory: no CUDA device", file=sys.stderr)
        return 1
    s.phase_build()
    dev = torch.device("cuda", 0)
    total = torch.cuda.get_device_properties(dev).total_memory / 2**30
    with contextlib.ExitStack() as stack:
        at = stack.enter_context(s.step_parts())
        if not args.fixed_segments:
            stack.enter_context(s.expandable_segments())
        for arch in args.archs.split(","):
            unit, first = s.train_unit(arch)
            full = get_config(arch).n_layers
            for remat in args.remats.split(","):
                best = None
                depth0 = start.get(arch, first)
                for depth in range(depth0, depth0 + 1 if args.only
                                   else full + 1, unit):
                    rec = one_depth(dev, arch, remat, depth, args.steps,
                                    args.lr or s.TRAIN_LR, at)
                    gc.collect()
                    torch.cuda.empty_cache()
                    print(f"[train_memory] {json.dumps(rec)}", flush=True)
                    if "oom" in rec:
                        break
                    if rec["peak_gib"] <= total - s.TRAIN_SPARE_GIB:
                        best = depth
                print(f"[train_memory] {arch} remat {remat}: deepest depth "
                      f"with {s.TRAIN_SPARE_GIB} GiB of {total:.2f} to spare:"
                      f" {best}", flush=True)
    print(s.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
