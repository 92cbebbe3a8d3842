"""What bounds the quickstart at gemma-2b's full width, and how fast a
process store's spawned workers come up, on the card.

    python3 tools/quickstart_memory.py [--depths 3,4,6,18] [--cold-starts]

``--depths``: ``chip_smoke.quickstart_full`` (phase 16 (c): gemma-2b at
full width in bf16 on the sharded store, 96 AdamW steps) at each depth in
turn, each in a fresh process, printing its peak memory, or where it ran
out of memory and how much was allocated then.  ``--cold-starts``: a
``process`` store of the scenario engine (2 spawned CUDA workers) at width
16 and at the forecaster's 141,953, printing each worker's cold start
(spawn to ready); it imports only ``repro_torch``, so it runs on an older
checkout too (``PYTHONPATH=<checkout>/src``).  Then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
REDUCED_INFO = {"assignments": {"org-vienna-1": ["loc:0"],
                                "org-vienna-2": ["loc:0"],
                                "org-berlin-1": ["loc:1"],
                                "org-berlin-2": ["loc:1"]},
                "join": ["loc:0"]}


def one_depth(depth: int) -> dict:
    import torch

    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import chip_smoke

    chip_smoke.QUICKSTART_FULL_DEPTH = depth
    chip_smoke.phase_build()
    try:
        chip_smoke.quickstart_full(torch.device("cuda", 0), REDUCED_INFO)
    except torch.OutOfMemoryError as e:
        return {"depth": depth, "oom": str(e).split(". ")[0],
                "allocated_gib": torch.cuda.memory_allocated() / 2**30,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return {"depth": depth,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def cold_starts() -> list:
    from repro_torch.kernels import build
    from repro_torch.scenario.engine import make_store

    build.build()
    out = []
    for width in (16, 141_953):
        store = make_store("process", cluster_keys=[f"c{j}" for j in
                                                    range(8)],
                           n_shards=2, max_coalesce=16, param_dim=width,
                           device="cuda")
        out.append({"width": width, "cold_starts_s": [
            sh.handle.cold_start_s for sh in store._proc_shards]})
        store.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", default="")
    ap.add_argument("--cold-starts", action="store_true")
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one_depth(args.one)))
        return 0
    for depth in filter(None, args.depths.split(",")):
        proc = subprocess.run(
            [sys.executable, __file__, "--one", depth], capture_output=True,
            text=True, env=dict(os.environ, PYTHONHASHSEED="0"))
        lines = proc.stdout.strip().splitlines()
        print(f"[depth {depth}] exit {proc.returncode}: "
              f"{lines[-1] if lines else proc.stderr[-500:]}")
    if args.cold_starts:
        for row in cold_starts():
            print(f"[cold starts] {json.dumps(row)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
