"""Hold a dry-run's records to the JAX package's analytic model, on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] --out runs.jsonl
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_check.py runs.jsonl [...]

For every record of the files (``launch.dryrun``'s ``--out`` lines): its
status, and for each ``ok`` record whether its ``analytic`` equals
``repro.launch.roofline.analytic_costs`` for the same config, shape and
mesh (remat only for training shapes, f32 moments, the long-context
window of the dense, MoE and VLM families at ``long_500k``, MLA absorbed),
as ``tests/test_torch_dryrun.py`` holds it for a few.  Prints a line a
record that differs or is not ok, then the counts; exits 1 on an error or
a difference.
"""

from __future__ import annotations

import json
import sys
from collections import Counter


def main(paths) -> int:
    from repro.configs import INPUT_SHAPES, get_config
    from repro.launch.roofline import analytic_costs

    status, bad = Counter(), 0
    for path in paths:
        for line in open(path):
            rec = json.loads(line)
            status[rec["status"]] += 1
            if rec["status"] != "ok":
                if rec["status"] != "skipped":
                    bad += 1
                print(f"{rec['arch']} {rec['shape']} multi_pod="
                      f"{rec.get('multi_pod')}: {rec['status']} "
                      f"{rec.get('error', rec.get('reason', ''))}")
                continue
            cfg = get_config(rec["arch"])
            shape = INPUT_SHAPES[rec["shape"]]
            if shape.mode == "train":
                cfg = cfg.replace(remat=rec["remat"])
            mesh = ({"pod": 2, "data": 16, "model": 16} if rec["multi_pod"]
                    else {"data": 16, "model": 16})
            want = analytic_costs(
                cfg, shape, 512 if rec["multi_pod"] else 256, mesh,
                remat=rec["remat"] if shape.mode == "train" else "none",
                moment_bytes=4,
                window_override=cfg.long_context_window
                if rec["shape"] == "long_500k"
                and cfg.family in ("dense", "moe", "vlm") else None,
                mla_absorb=rec["mla_absorb"])
            if rec["analytic"] != want:
                bad += 1
                print(f"{rec['arch']} {rec['shape']} multi_pod="
                      f"{rec['multi_pod']}: analytic {rec['analytic']}, "
                      f"the reference's {want}")
    print(f"[dryrun_check] {dict(status)}; {bad} not ok or not equal")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
