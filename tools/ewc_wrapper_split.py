"""Where the host time of one ``ewc_update`` call goes, on the card.

    python3 tools/ewc_wrapper_split.py [--iters N]

Times, on the host clock over N calls each (the card synchronised every
100 calls so the launch queue never fills), each piece of work a wrapper of
the anchor update does around its kernel: the device and dtype checks, the
output and scratch allocations, the current stream's handle, the pointers,
the ctypes call that launches the kernel; then the whole call of
``kernels.ewc_update.ops.ewc_penalty_grad_flat``, back to back by CUDA
events as ``chip_smoke.py`` times it, and its kernel's own device time by
torch.profiler.  T = 141,953 (the forecaster at hidden 128), F = None, as
on the solar paths.  Prints one line per piece and a JSON line, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

T = 141_953


def host_us(fn, iters: int) -> float:
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    done = 0
    while done < iters:
        n = min(100, iters - done)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
        done += n
    return total / iters * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=2000)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ewc_wrapper_split: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.ewc_update import ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    g, p, a = (torch.randn(T, generator=gen, device=dev) for _ in range(3))
    lib = build.library()
    out = torch.empty_like(g)
    loss = torch.empty((), device=dev)
    stream = build.stream_handle(dev)
    if stream != torch.cuda.current_stream(dev).cuda_stream:
        print("ewc_wrapper_split: build.stream_handle names another stream",
              file=sys.stderr)
        return 1
    work = ops.workspace(dev, stream)
    ptrs = (g.data_ptr(), p.data_ptr(), a.data_ptr(), None, T,
            out.data_ptr(), work.data_ptr(), loss.data_ptr(), stream)

    def shape_checks():
        for name, t in (("params", p), ("anchor", a), ("fisher", None)):
            if t is not None and t.shape != g.shape:
                raise ValueError(name)
        if g.dim() != 1:
            raise ValueError("flat")

    pieces = {
        "build.on_cuda (4 tensors)":
            lambda: build.on_cuda("ewc_update", g, p, a, None),
        "build.require_f32_contiguous":
            lambda: build.require_f32_contiguous(
                "ewc_update", grads=g, params=p, anchor=a, fisher=None),
        "shape checks": shape_checks,
        "torch.empty_like(grads)": lambda: torch.empty_like(g),
        "torch.empty(()) (loss)":
            lambda: torch.empty((), dtype=torch.float32, device=dev),
        "torch.empty(1024) (the two-launch design's partials)":
            lambda: torch.empty(1024, dtype=torch.float32, device=dev),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "build.stream_handle (the raw current stream)":
            lambda: build.stream_handle(dev),
        "ops.workspace lookup": lambda: ops.workspace(dev, stream),
        "data_ptr() x 6": lambda: (g.data_ptr(), p.data_ptr(), a.data_ptr(),
                                   out.data_ptr(), work.data_ptr(),
                                   loss.data_ptr()),
        "ctypes call, one launch": lambda: lib.ewc_update_launch(0.05, *ptrs),
        "whole call (ops.ewc_penalty_grad_flat)":
            lambda: ops.ewc_penalty_grad_flat(0.05, g, p, a),
    }
    res = {}
    for name, fn in pieces.items():
        res[name] = host_us(fn, args.iters)
        print(f"[ewc split] {name:55s} {res[name]:8.3f} us a call (host)")

    import chip_smoke  # noqa: E402  (the repo root's timing helpers)

    call = lambda: ops.ewc_penalty_grad_flat(0.05, g, p, a)  # noqa: E731
    res["whole call, CUDA events, ms"] = chip_smoke.cuda_ms(call)
    res["kernel device time, ms"] = chip_smoke.device_ms("ewc_update", call)
    print(f"[ewc split] whole call back to back {res['whole call, CUDA events, ms']:.5f} "
          f"ms; its kernel's device time {res['kernel device time, ms']} ms")
    print(json.dumps({"ewc_wrapper_split_us": res}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main())
