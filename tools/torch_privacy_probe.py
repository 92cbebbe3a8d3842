"""Two CPU probes of the solar privacy path.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/torch_privacy_probe.py \
        [--hidden 64] [--epochs 2] [--out probe.json]
    PYTHONPATH=src python tools/torch_privacy_probe.py --witness

The first runs the path in the JAX package and in the PyTorch port, from
the same JAX-initialised parameters and with the reference's own DP noise
swapped into the port, and prints where each report is NaN and how far the
finite entries are apart.  Its defaults are ``chip_smoke.py``'s privacy
phase (6 sites, 40 days, 2 rounds, 2 independent sites, clip 5.0, noise
multiplier 0.3, secure aggregation) at the committed report's width,
hidden 64.

The second (``--witness``, the port alone) runs ``chip_smoke.py``'s small
agree configuration with DP alone, at clip 5.0 and 0.1 and noise
multiplier 0.3, three times each: twice as it is and once with every noise
value moved by one ulp, and prints the Table II / §IV.E gaps.  A gap of pp
from a one-ulp change says the run is chaotic, so two correct
implementations that round differently cannot be held to each other there.

The script re-executes itself with ``PYTHONHASHSEED=0`` (the fleet's
weather is seeded with ``hash(site_id)``), so every run sees the same data.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def nan_pattern(report) -> dict:
    return {tab: sorted(f"{col}.{k}" for col, row in report[tab].items()
                        for k, v in row.items() if math.isnan(v))
            for tab in ("table2", "independent")}


def finite_gap(ref, got) -> float:
    return max((abs(got[tab][col][k] - v)
                for tab in ("table2", "independent")
                for col, row in ref[tab].items() for k, v in row.items()
                if math.isfinite(v) and math.isfinite(got[tab][col][k])),
               default=0.0)


def power(report) -> dict:
    return {tab: {col: row["mean_error_power"]
                  for col, row in report[tab].items()}
            for tab in ("table2", "independent")}


def witness(threads: int) -> dict:
    import torch

    from repro_torch.privacy.dp import DPPrivatizer
    from repro_torch.training.fed_solar import run_fedccl_solar

    torch.set_num_threads(threads)
    small = dict(hidden=16, n_sites=4, n_days=14, rounds=1, epochs=2,
                 n_independent=1, seed=0)
    draw = DPPrivatizer._noise

    def ulp_up(self, t):
        return torch.nextafter(draw(self, t), torch.tensor(math.inf))

    rows = []
    for clip in (5.0, 0.1):
        cfg = dict(small, dp_clip=clip, dp_noise_multiplier=0.3)
        a = run_fedccl_solar(device="cpu", **cfg)
        b = run_fedccl_solar(device="cpu", **cfg)
        DPPrivatizer._noise = ulp_up
        try:
            c = run_fedccl_solar(device="cpu", **cfg)
        finally:
            DPPrivatizer._noise = draw
        rows.append({"config": cfg,
                     "gap_same_run_twice_pp": finite_gap(a, b),
                     "gap_noise_one_ulp_up_pp": finite_gap(a, c),
                     "nan": nan_pattern(a), "nan_one_ulp_up": nan_pattern(c)})
    return {"witness": rows}


def probe(hidden: int, epochs: int, threads: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro_torch.privacy.dp import DPPrivatizer
    from scripts.torch_parity import solar_parity

    torch.set_num_threads(threads)

    def jax_noise(self, t):
        key = jax.random.fold_in(jax.random.key(self.seed), self._step)
        return torch.from_numpy(np.array(jax.random.normal(
            key, (t,), jnp.float32)))

    DPPrivatizer._noise = jax_noise
    cfg = dict(hidden=hidden, n_sites=6, n_days=40, rounds=2, epochs=epochs,
               n_independent=2, seed=0, dp_clip=5.0, dp_noise_multiplier=0.3,
               secure_agg=True)
    ref, got, _ = solar_parity(**cfg)
    return {
        "config": cfg,
        "clusters_equal": got["clusters"] == ref["clusters"],
        "async_stats_equal": got["async_stats"] == ref["async_stats"],
        "privacy_equal": got["privacy"] == ref["privacy"],
        "nan_jax": nan_pattern(ref),
        "nan_port": nan_pattern(got),
        "nan_pattern_equal": nan_pattern(ref) == nan_pattern(got),
        "max_finite_gap_pp": finite_gap(ref, got),
        "power_jax": power(ref),
        "power_port": power(got),
    }


def main() -> int:
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, __file__, *sys.argv[1:]],
                  dict(os.environ, PYTHONHASHSEED="0"))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(REPO / "src"), str(REPO)]

    t0 = time.perf_counter()
    result = (witness(args.threads) if args.witness
              else probe(args.hidden, args.epochs, args.threads))
    result["seconds"] = time.perf_counter() - t0
    text = json.dumps(result, indent=1)
    print(text)
    if args.out is not None:
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
