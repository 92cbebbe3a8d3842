"""The ssd_chunk kernel's distance from the f64 answer, beside its plain
version's, over chunk lengths and state sizes, on the card.

    python3 tools/ssd_f64_witness.py

For each shape (b, c, l, h, p, g, n) the kernel inputs are drawn as
mamba2-370m's mixer makes them (x, dt = softplus(.), A = -exp(.), B and C
once per group; xdt = x dt and dA = dt A cut into chunks of l), then
``ssd_intra_chunk`` (the kernel) and ``ssd_intra_chunk_ref`` (the plain
version, f32) are each held against ``ssd_intra_chunk_ref`` in f64:
max|out - f64| / max|f64|, for y_diag and the chunk states apart, with the
ratio kernel / plain (``chip_smoke.py`` requires <= 2 at its shapes).  Also
the kernel's time at the path shape, back to back.  Prints one line per
shape and output, a JSON line, and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPES = [  # b, c, l, h, p, g, n
    (4, 8, 256, 32, 64, 1, 128),      # mamba2-370m scoring, 4 x 2048 tokens
    (2, 4, 256, 8, 80, 2, 160),
    (2, 4, 64, 8, 80, 2, 160),
    (2, 4, 32, 8, 80, 2, 160),
    (2, 4, 16, 8, 80, 2, 160),
    (2, 4, 8, 8, 80, 2, 160),
    (2, 4, 8, 32, 64, 1, 128),
]


def inputs(gen, b, c, l, h, p, g, n):
    import torch
    import torch.nn.functional as F

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=gen.device) * scale
    x, dt = r(b, c * l, h, p), F.softplus(r(b, c * l, h))
    A = -torch.exp(r(h, scale=0.5))
    B, C = r(b, c * l, g, n), r(b, c * l, g, n)
    return ((x * dt[..., None]).reshape(b, c, l, h, p),
            (dt * A).reshape(b, c, l, h),
            B.reshape(b, c, l, g, n), C.reshape(b, c, l, g, n))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_f64_witness: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.ssd_chunk.ops import ssd_intra_chunk
    from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape in SHAPES:
        args = inputs(gen, *shape)
        kern = ssd_intra_chunk(*args)
        plain = ssd_intra_chunk_ref(*args)
        exact = ssd_intra_chunk_ref(*(t.double() for t in args))
        for what, k, p, e in zip(("y_diag", "states"), kern, plain, exact,
                                 strict=True):
            dk = chip_smoke.f64_distance(k, e)
            dp = chip_smoke.f64_distance(p, e)
            rows.append({"shape": shape, "out": what, "kernel": dk,
                         "plain": dp, "ratio": dk / dp})
            print(f"[ssd witness] b,c,l,h,p,g,n={shape} {what:6s}: kernel "
                  f"{dk:.3e}, plain f32 {dp:.3e}, ratio {dk / dp:.3f}")
        del kern, plain, exact
    path = inputs(gen, *SHAPES[0])
    ms = chip_smoke.cuda_ms(lambda: ssd_intra_chunk(*path), iters=50)
    dev_ms = chip_smoke.device_ms("ssd_chunk",
                                  lambda: ssd_intra_chunk(*path), iters=20)
    print(f"[ssd witness] kernel at {SHAPES[0]}: {ms:.5f} ms back to back, "
          f"{dev_ms} ms device")
    print(json.dumps({"ssd_f64_witness": rows, "path_ms": ms,
                      "path_device_ms": dev_ms}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
