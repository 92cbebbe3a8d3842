"""Where the host time of one stacked fold (``aggregate_flat``) goes, on the
card.

    python3 tools/fold_wrapper_split.py [--iters N]

Times, on the host clock over N calls each (the card synchronised every
100 calls so the launch queue never fills), each piece of work the
stacked fold's wrapper does or did around its kernel: the device check
(``build.on_cuda`` before, ``is_cuda`` now), the dtype / layout / rank
checks (as ``build.require_f32_contiguous`` did
them and as the wrapper does them now), the weights as Python floats,
``fold_chunks``' slice of the first 64 rows, the weights as a ctypes array
(the earlier wrapper) and as packed bytes (now), the output's
``torch.empty`` (before) and ``new_empty`` (now), the current stream's
handle, the pointers, the ctypes
call that launches the kernel, ``build.check`` and ``build.count``.  Then
the whole call back to back by CUDA events as ``chip_smoke.py`` times it:
the earlier wrapper (rebuilt here from its pieces: checks, the slice, a
ctypes array), the wrapper now, and ``w @ stacked`` (the library's
yardstick), in turns; and the kernel's own device time by torch.profiler.
N 2, T 141,953 (two forecasters at hidden 128), as ``chip_smoke.py``'s
stacked check times it; then T 141,952 (T % 4 == 0: the 16-byte route,
held bit for bit against the leaves route).
Prints one line per piece and a JSON line, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

T = 141_953
WS = [0.375, 0.625]


def host_us(fn, iters: int) -> float:
    """Mean host time of one call, the card synchronised every 100 calls."""
    import time

    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    total, done = 0.0, 0
    while done < iters:
        m = min(100, iters - done)
        t0 = time.perf_counter()
        for _ in range(m):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
        done += m
    return total / iters * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=2000)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fold_wrapper_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from chip_smoke import cuda_ms, device_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.fedavg_agg import ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, T, generator=gen, device=dev)
    n = len(WS)
    lib = build.library()
    out = torch.empty(T, dtype=torch.float32, device=dev)
    stream = build.stream_handle(dev)
    if stream != torch.cuda.current_stream(dev).cuda_stream:
        print("fold_wrapper_split: build.stream_handle names another stream",
              file=sys.stderr)
        return 1
    packed = ops._PACKS[n].pack(*WS)

    def checks_now():
        if x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != 2:
            raise ValueError("stacked")

    def checks_before():
        build.require_f32_contiguous("fedavg_agg", stacked=x)
        if x.dim() != 2:
            raise ValueError("stacked")

    def launch_before(stacked, ws):
        m, t = stacked.shape
        o = torch.empty(t, dtype=torch.float32, device=stacked.device)
        build.check(lib.fedavg_agg_launch(
            stacked.data_ptr(), (ctypes.c_float * m)(*ws), m, t,
            o.data_ptr(), build.stream_handle(stacked.device)), "fedavg_agg")
        build.count(ops.__name__, "launches")
        return o

    def before(stacked, weights):
        """The wrapper as it was: every check, then fold_chunks."""
        build.on_cuda("fedavg_agg", stacked)
        build.require_f32_contiguous("fedavg_agg", stacked=stacked)
        if stacked.dim() != 2:
            raise ValueError("stacked")
        ws = [float(w) for w in weights]
        if len(ws) != stacked.shape[0]:
            raise ValueError("weights")
        return ops.fold_chunks(stacked, ws, launch_before)

    pieces = {
        "build.on_cuda (1 tensor; before)":
            lambda: build.on_cuda("fedavg_agg", x),
        "stacked.is_cuda (now)": lambda: x.is_cuda,
        "checks before (require_f32_contiguous, dim)": checks_before,
        "checks now (dtype, is_contiguous, dim)": checks_now,
        "weights as floats": lambda: [float(w) for w in WS],
        "fold_chunks' slice stacked[:64], ws[:64]":
            lambda: (x[:ops.MAX_N], WS[:ops.MAX_N]),
        "weights as a ctypes array (before)":
            lambda: (ctypes.c_float * n)(*WS),
        "weights packed (now)": lambda: ops._PACKS[n].pack(*WS),
        "torch.empty(T) (before)":
            lambda: torch.empty(T, dtype=torch.float32, device=dev),
        "stacked.new_empty(T) (now)": lambda: x.new_empty(T),
        "build.stream_handle": lambda: build.stream_handle(dev),
        "data_ptr() x 2": lambda: (x.data_ptr(), out.data_ptr()),
        "ctypes call, one launch":
            lambda: lib.fedavg_agg_launch(x.data_ptr(), packed, n, T,
                                          out.data_ptr(), stream),
        "build.check(0)": lambda: build.check(0, "fedavg_agg"),
        "build.count": lambda: build.count(ops.__name__, "launches"),
        "whole call before": lambda: before(x, WS),
        "whole call now (ops.aggregate_flat)":
            lambda: ops.aggregate_flat(x, WS),
    }
    res = {}
    for name, fn in pieces.items():
        res[name] = host_us(fn, args.iters)
        print(f"[fold split] {name:50s} {res[name]:8.3f} us a call (host)")

    w_row = torch.tensor([WS], device=dev)
    require = chip_smoke.require
    require(torch.equal(before(x, WS), ops.aggregate_flat(x, WS)),
            "the wrapper now and before give other bits")
    timed = {}
    for turn in ("before", "now", "library", "now", "before", "library"):
        fn = {"before": lambda: before(x, WS),
              "now": lambda: ops.aggregate_flat(x, WS),
              "library": lambda: torch.matmul(w_row, x)}[turn]
        timed.setdefault(turn, []).append(cuda_ms(fn))
    for turn, ms in timed.items():
        res[f"back to back ms, {turn}"] = ms
    res["kernel device time, ms"] = device_ms(
        "fedavg_agg", lambda: ops.aggregate_flat(x, WS),
        symbols=("fedavg_agg_kernel",))
    x4 = torch.randn(2, T - 1, generator=gen, device=dev)
    w4 = torch.tensor([WS], device=dev)
    require(torch.equal(ops.aggregate_leaves([[x4[0]], [x4[1]]], WS),
                        ops.aggregate_flat(x4, WS)),
            "the 16-byte route and the leaves route give other bits")
    res["T % 4 == 0: back to back ms, now"] = cuda_ms(
        lambda: ops.aggregate_flat(x4, WS))
    res["T % 4 == 0: back to back ms, library"] = cuda_ms(
        lambda: torch.matmul(w4, x4))
    res["T % 4 == 0: kernel device time, ms"] = device_ms(
        "fedavg_agg", lambda: ops.aggregate_flat(x4, WS),
        symbols=("fedavg_agg_vec4_kernel",))
    for k in [k for k in res if "ms" in k]:
        print(f"[fold split] {k}: {res[k]}")
    print(json.dumps({"fold_wrapper_split": res}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
