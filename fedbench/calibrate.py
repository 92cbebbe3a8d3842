"""Readings behind the limits of ``correct``: for each seed, one run of the
cell's window, then every number compared, for the program and for the
control (the reference computed in the configuration's
``control_precision``, put in the program's place) and for two faults
planted in that reference (half of the batch left out; a fold that leaves
the base as it was), all against the float32 reference.  All seeds in one
process, so the kernels build once.

    python3 fedbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 10

Prints one ``CALIBRATE {json}`` line a seed, then the largest program
reading and the smallest control and fault readings of each number.
Needs the card.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="seeds (the first ones) that also read the "
                         "control and the fault")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")     # as run.py
    import gc

    import torch

    from fedbench import checks, harness
    from fedbench.reference.precision import exact_matmuls

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    exact_matmuls()
    _, work, conf = harness.cell_spec(args.workload)
    low = conf["control_precision"]
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = harness.driver(conf["driver"]).Cell(
            conf, work, seed, torch.device("cuda"), False)
        cell.setup()
        cell.window(args.seconds)
        kinds = ((checks.PROGRAM, low, checks.HALF_BATCH,
                  checks.DROPPED_FOLD) if i < args.control_seeds
                 else (checks.PROGRAM,))
        got = checks.readings(cell, kinds)
        row = {"seed": seed, "program": got[checks.PROGRAM],
               "control": got.get(low), "control_precision": low,
               "half_batch": got.get(checks.HALF_BATCH),
               "dropped_fold": got.get(checks.DROPPED_FOLD),
               "samples": 1 + sum(s is not None for s in cell.rec.samples),
               "folds": [len(ups) for _, _, ups, _, _ in cell.rec.folds],
               "folds_seen": cell.rec.fold_seen,
               "wall_s": time.perf_counter() - t0}
        print("CALIBRATE " + json.dumps(row), flush=True)
        rows.append(row)
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    for name in rows[0]["program"]:
        hi = max(r["program"][name] for r in rows)
        ctl = [r for r in rows if r["control"] is not None]
        lo = min(r["control"][name] for r in ctl)
        half = min(r["half_batch"].get(name, float("nan")) for r in ctl)
        drop = min(r["dropped_fold"].get(name, float("nan")) for r in ctl)
        print(f"{name}: program max {hi!r}, control min {lo!r}, half-batch "
              f"fault min {half!r}, dropped-fold fault min {drop!r}, limit "
              f"{work['limits'][name]!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
