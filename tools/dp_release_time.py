"""Time one DP clip + noise release of the port on the card: the wrapper
``privatize_flat`` back to back (CUDA events, wrapper included) and the
device time of the kernels it launches (``torch.profiler``), at the solar
forecaster's T (141,953) by default.

    python tools/dp_release_time.py [--src DIR] [--t T]

``--src`` is the ``src`` directory of the tree to time (default: this
checkout's), so two trees, such as a parent commit unpacked with
``git archive`` into a git-ignored directory, can be timed in turns on
one card, one process each.  Prints one JSON line, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--t", type=int, default=141_953)
    ap.add_argument("--iters", type=int, default=500)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from torch.autograd import DeviceType
    from repro_torch.kernels.dp_clip_noise.ops import privatize_flat

    if not torch.cuda.is_available():
        print("dp_release_time: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    d = torch.randn(args.t, generator=gen, device=dev) * 0.05
    noise = torch.randn(args.t, generator=gen, device=dev)

    def call():
        return privatize_flat(d, noise, 5.0, 0.3)

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.iters):
        call()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / args.iters
    for _ in range(2):          # count in the second window (the first
        with torch.profiler.profile(         # may miss its first kernel)
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(100):
                call()
            torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "src": args.src, "t": args.t, "ms": ms,
        "device_ms": sum(e.time_range.elapsed_us() for e in events) / 100
        / 1e3,
        "kernels_a_call": len(events) / 100,
        "kernels": sorted({e.name.split("(")[0] for e in events}),
        "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
