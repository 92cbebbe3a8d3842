"""The paper's full case study on the PyTorch port (``repro_torch``): the
same run, flags and report as ``examples/solar_forecasting.py``, with the
hand-written CUDA kernels on the GPU.

Synthesizes a central-European PV fleet, clusters by location + panel
orientation, runs asynchronous FedCCL training, reports the Table-II
metric grid, evaluates Predict & Evolve on held-out installations, and
writes the report to ``<out>/solar_report.json``.

    PYTHONPATH=src python examples/solar_forecasting_torch.py [--full] [--device cpu]

It runs on CUDA (and raises where there is none) unless ``--device cpu``
is given; the CPU runs the kernels' plain PyTorch versions.
"""

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale-ish run (slower)")
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--dp-clip", type=float, default=None,
                    help="enable DP update privatization with this L2 clip")
    ap.add_argument("--dp-noise-multiplier", type=float, default=1.0,
                    help="Gaussian noise std = multiplier * clip")
    ap.add_argument("--secure-agg", action="store_true",
                    help="pairwise-mask secure aggregation (full-round drains)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.training.fed_solar import run_fedccl_solar

    kw = (dict(n_sites=9, n_days=90, rounds=4, epochs=4) if args.full
          else dict(n_sites=6, n_days=40, rounds=2))
    report = run_fedccl_solar(seed=0, dp_clip=args.dp_clip,
                              dp_noise_multiplier=args.dp_noise_multiplier,
                              secure_agg=args.secure_agg, **kw,
                              device=args.device)

    print("=== Table II analog ===")
    for name, row in report["table2"].items():
        print(f"{name:24s} power {row['mean_error_power']:6.2f}%  "
              f"energy {row['mean_error_energy']:6.2f}%  "
              f"day-power {row['mean_error_day_power']:6.2f}%")
    print("=== Population-independent (Predict & Evolve) ===")
    for name, row in report["independent"].items():
        deg = (row["mean_error_power"]
               - report["table2"][name]["mean_error_power"])
        print(f"{name:24s} power {row['mean_error_power']:6.2f}%  "
              f"(degradation {deg:+.2f} pp)")
    print("=== async protocol ===")
    print(json.dumps(report["async_stats"], indent=2))
    priv = report["privacy"]
    if priv["dp"]["enabled"] or priv["secure_agg"]["enabled"]:
        print("=== privacy ===")
        if priv["secure_agg"]["enabled"]:
            print(f"secure rounds {priv['secure_agg']['rounds']}  "
                  f"dropout recoveries {priv['secure_agg']['dropout_recoveries']}")
        for cid, row in sorted(priv.get("per_client", {}).items()):
            print(f"{cid:24s} eps={row['epsilon']:8.3f}  "
                  f"delta={row['delta']:.0e}  steps={row['steps']}")

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "solar_report.json"), "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(f"full report -> {args.out}/solar_report.json")


if __name__ == "__main__":
    main()
