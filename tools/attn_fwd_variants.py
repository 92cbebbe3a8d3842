"""Variants of local_attn's split-tf32 forward timed beside it, on the card.

    python3 tools/attn_fwd_variants.py [--shape B,H,KV,S,D] [--old FILE]
                                       [name ...]

Each variant is the committed ``csrc/local_attn_tf32.cu`` (with the helpers
it shares with the backward, ``csrc/local_attn_tf32_common.cuh``) with one
design step undone by a text substitution, built into its own library
under ``build/attn_fwd_variants/`` (the builds run together) and launched
through the same C entry point as ``kernels/local_attn/ops.py``'s wrapper,
at gemma-2b's training shape in f32 by default (B 2, H 8, KV 1, S 2048, D
256, causal):
  committed     the source as it is
  split1        one warp a row group of 16 rows (4 warps a CTA, each its
                rows' whole score tile and all D output columns), in place
                of two splitting the columns (8 warps)
  six_products  the exact three-way split and six partial products
                (``LT_PARTS`` 3) in place of two parts and three
  unroll4       the k-step loop of a product unrolled by 4 (committed: 2)
  nc4           the output product four n-tiles at a time (committed: 8)
  bn16          16 streamed keys a tile at D 256, not 32
  scores_only   step 4 (O += P V) left out: the time of the rest (the
                output is wrong; its errors are not held)
``--old FILE`` also builds and times a source with the C entry point of
the CUDA-core kernel this one replaced (``local_attn_launch``: dense
inputs, S and T multiples of 32, as its wrapper padded them), for a
before-and-after in one call.  Prints a line a variant (times back to
back in turns, max abs err against the plain version, the distance to the
f64 answer over the plain version's, registers), SDPA's f32 time on the
same inputs, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

OUT = ROOT / "build" / "attn_fwd_variants"
SOURCES = ("local_attn_tf32.cu", "local_attn_tf32_common.cuh")
LOOP = "#pragma unroll 2\n  for (int ks = 0; ks < KS; ++ks)"
VARIANTS = {
    "committed": [],
    "split1": [("#define LF_SPLIT 2", "#define LF_SPLIT 1")],
    "six_products": [("#define LT_PARTS 2", "#define LT_PARTS 3")],
    "unroll4": [(LOOP, LOOP.replace("unroll 2", "unroll 4"))],
    "nc4": [("static constexpr int NC = 8;", "static constexpr int NC = 4;")],
    "bn16": [("BN = D == 256 ? 32 : 64;", "BN = D == 256 ? 16 : 64;")],
    "scores_only": [("    lt_out<D, ON>(acc, Eg, Vy + part * ON);\n", "")],
}
ABLATIONS = ("scores_only",)
OLD_TILE = 32           # the CUDA-core kernel's LA_BQ and LA_BK


def start_old(path):
    import subprocess

    from repro_torch.kernels import build

    OUT.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
         str(OUT / "cuda_core.so"), str(Path(path).resolve())],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(name, proc, symbol, argtypes):
    from attn_bwd_variants import registers

    text, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{text}")
    fn = getattr(ctypes.CDLL(str(OUT / f"{name}.so")), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn, registers(text)


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F
    from attn_bwd_variants import build_variant
    from chip_smoke import card_line, cuda_ms, f64_distance
    from repro_torch.kernels import build
    from repro_torch.kernels.local_attn import ops
    from repro_torch.kernels.local_attn.ref import local_attention_ref

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="2,8,1,2048,256",
                    help="B,H,KV,S,D (causal, no window)")
    ap.add_argument("--old", default=None,
                    help="a source with the CUDA-core kernel's entry point")
    ap.add_argument("names", nargs="*", help=f"of {list(VARIANTS)}")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    names = args.names or list(VARIANTS)
    procs = {name: build_variant(OUT, name, SOURCES, VARIANTS[name])
             for name in names}
    if args.old:
        procs["cuda_core"] = start_old(args.old)
    P, I, L, Fl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    built = {name: load(name, proc, "local_attn_tf32_launch",
                        build.SIGNATURES["local_attn_tf32_launch"])
             for name, proc in procs.items() if name != "cuda_core"}
    if args.old:
        built["cuda_core"] = load(
            "cuda_core", procs["cuda_core"], "local_attn_launch",
            [P, P, P, P, *[I] * 7, Fl, I, I, I, P, P])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, KV, S, D = (int(x) for x in args.shape.split(","))
    scale = D ** -0.5
    q = torch.randn(B, H, S, D, generator=gen, device=dev)
    k, v = (torch.randn(B, KV, S, D, generator=gen, device=dev)
            for _ in range(2))
    kw = dict(causal=True, window=0, scale=scale)
    plain = local_attention_ref(q, k, v, **kw)
    exact = local_attention_ref(q.double(), k.double(), v.double(), **kw)
    (qs, ks, vs), strides = ops._tma_inputs(q, k, v)
    stream = build.stream_handle(dev)

    def runner(fn):
        def run():
            out = torch.empty_like(q)
            lse = torch.empty(B, H, S, device=dev)
            build.check(fn(qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                           out.data_ptr(), B, H, KV, S, S, D, *strides,
                           *ops.tma_strides(out), scale, 1, 0, 0,
                           lse.data_ptr(), stream), "variant")
            return out
        return run

    def old_runner(fn):
        if S % OLD_TILE:
            raise SystemExit(f"--old takes S a multiple of {OLD_TILE}")

        def run():
            out = torch.empty_like(q)
            lse = torch.empty(B, H, S, device=dev)
            build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), B, H, KV, S, S, S, D, scale, 1, 0,
                           0, lse.data_ptr(), stream), "cuda_core")
            return out
        return run

    runs = {name: (old_runner if name == "cuda_core" else runner)(fn)
            for name, (fn, _) in built.items()}
    rows = {}
    for name, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        rows[name] = {"max_abs_err": (got - plain).abs().max().item(),
                      "f64": round(f64_distance(got, exact)
                                   / f64_distance(plain, exact), 3),
                      "ms": [], "registers": built[name][1]}
    for turn in (*runs, *reversed(runs)):
        rows[turn]["ms"].append(cuda_ms(runs[turn], iters=10, warmup=2))
    for name, row in rows.items():
        held = " (an ablation: errors not held)" if name in ABLATIONS else ""
        print(f"[attn fwd variants] {name}: ms {row['ms']}, max abs err "
              f"{row['max_abs_err']:.3e}, distance to f64 over the plain "
              f"version's {row['f64']}, registers {row['registers']}{held}")
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale, enable_gqa=True), iters=10,
        warmup=2)
    print(f"[attn fwd variants] SDPA f32 at B={B} H={H} KV={KV} S={S} D={D}: "
          f"{sdpa} ms")
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
