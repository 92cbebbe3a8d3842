"""Variants of ssd_chunk's backward kernel timed beside it, on the card.

    python3 tools/ssd_bwd_variants.py

Each variant is the committed ``csrc/ssd_chunk_bwd.cu`` with one design
choice undone by a text substitution, built alone into its own library
under ``build/ssd_bwd_variants/`` and launched through the same C entry
point, at mamba2-370m's training shape (b 2, c 8, l 256, h 32, p 64, g 1,
n 128; the wrapper's heads a CTA):
  committed  the source as it is
  cvt_split  the tf32 round by ``cvt.rna.tf32.f32`` (``ssd_split3``, as
             the forward) in place of the integer round (``sb_split3``)
  one_chain  the six products in one chain (``ssd_row6``) in place of two
             (``sb_row6``)
  unroll4    the k-step loop unrolled by 4
Prints a line a variant (time back to back in turns, registers, max abs
err against the plain VJP), then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPE = (2, 8, 256, 32, 64, 1, 128)      # b, c, l, h, p, g, n
VARIANTS = {
    "committed": [],
    "cvt_split": [("      sb_split3(TA ?", "      ssd_split3(TA ?"),
                  ("        sb_split3(TB ?", "        ssd_split3(TB ?")],
    "one_chain": [("    sb_row6<NT>(acc,", "    ssd_row6<NT>(acc,")],
    "unroll4": [("#pragma unroll 1\n  for (int k0 = 0; k0 < K; k0 += 8)",
                 "#pragma unroll 4\n  for (int k0 = 0; k0 < K; k0 += 8)")],
}


def build_variant(name, subs):
    from repro_torch.kernels import build

    src = (build.CSRC / "ssd_chunk_bwd.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} is not in the source")
        src = src.replace(old, new)
    out = ROOT / "build" / "ssd_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    done = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
         "-shared", "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
        capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{done.stdout}{done.stderr}")
    regs = [line.split("Used ")[1].split(",")[0]
            for line in (done.stdout + done.stderr).splitlines()
            if "registers" in line]
    lib = ctypes.CDLL(str(out / f"{name}.so"))
    fn = lib.ssd_chunk_bwd_launch
    fn.argtypes = build.SIGNATURES["ssd_chunk_bwd_launch"]
    fn.restype = ctypes.c_int
    return fn, regs


def main() -> int:
    import torch
    from chip_smoke import card_line, cuda_ms, ssd_kernel_inputs
    from repro_torch.kernels.ssd_chunk import ops
    from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_bwd_ref

    if not torch.cuda.is_available():
        print("ssd_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, c, l, h, p, g, n = SHAPE
    xdt, dA, B, C = ssd_kernel_inputs(gen, *SHAPE)
    dy = torch.randn(xdt.shape, generator=gen, device=dev)
    dst = torch.randn((b, c, h, n, p), generator=gen, device=dev)
    plain = ssd_intra_chunk_bwd_ref(xdt, dA, B, C, dy, dst)
    hb = ops.bwd_heads_per_block(b * c, h, g, ops._sm_count(dev.index), l,
                                 p, n)
    outs = [torch.empty_like(t) for t in (xdt, dA, B, C)]
    scratch = torch.empty(2 * b * c * (h // hb) * l * n, device=dev)
    calls, regs = {}, {}
    for name, subs in VARIANTS.items():
        fn, regs[name] = build_variant(name, subs)

        def call(fn=fn):
            status = fn(*(t.data_ptr() for t in (xdt, dA, B, C, dy, dst)),
                        b, c, l, h, g, p, n, hb,
                        *(t.data_ptr() for t in outs), scratch.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
            if status:
                raise SystemExit(f"{name}: CUDA error {status}")
        calls[name] = call
    times = {name: [] for name in VARIANTS}
    for order in (list(VARIANTS), list(reversed(VARIANTS))):   # in turns
        for name in order:
            times[name].append(cuda_ms(calls[name], iters=20, warmup=3))
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        err = max((a - w).abs().max().item()
                  for a, w in zip(outs, plain, strict=True))
        print(f"[ssd_bwd_variants] {name}: "
              f"{' '.join(f'{t:.5f}' for t in times[name])} ms, "
              f"registers {regs[name]}, max abs err {err:.3e} "
              f"(heads a CTA {hb})")
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
