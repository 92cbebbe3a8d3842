"""Run one cell of the benchmark once, on the card, and print its result.

    python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Each run is a new process: it builds the cell's federation from the seed
(weights drawn on the card, data made on the host), warms up, measures a
window of ``--seconds`` in which every client trains again as soon as its
submit returns, checks sampled updates and folds against the plain
reference in ``fedbench/reference/``, and prints one JSON object as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, read from a device trace of the window), ``device`` and,
traced, ``breakdown``, then ``checks`` (each number compared, beside its
limit), which standard error's last lines repeat.

Exits non-zero without a result where there is no CUDA card, where the
program's sources are missing, or where JAX or the JAX package was loaded.
Kernel builds go to ``build/`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from fedbench import harness

    entry, _, _ = harness.cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"fedbench: cell {args.workload} needs {entry['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START,
                              log=lambda s: print(s, file=sys.stderr))
    found = harness.forbidden_modules()
    if found:
        print(f"fedbench: the run loaded {found}: JAX or the JAX package",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
