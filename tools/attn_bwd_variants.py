"""Variants of local_attn's split-tf32 backward timed beside it, on the card.

    python3 tools/attn_bwd_variants.py [name ...]

Each variant is the committed ``csrc/local_attn_bwd_tf32.cu`` (with the
helpers it shares with the forward, ``csrc/local_attn_tf32_common.cuh``)
with one design choice undone by a text substitution, built with the head
fold
(``csrc/local_attn_bwd.cu``) into its own library under
``build/attn_bwd_variants/`` (the builds run together) and launched
through the same C entry point as ``kernels/local_attn/ops.py``'s
wrapper, at gemma-2b's training shape in f32 (B 2, H 8, KV 1, S 2048, D
256, causal):
  committed     the source as it is
  six_products  the exact three-way split and six partial products
                (``LT_PARTS`` 3) in place of two parts and three
  unroll4       the k-step loop of a product unrolled by 4 (committed: 2)
  nc4           the output products four n-tiles at a time (committed: 8)
  trunc_split   hi = x with its low 13 bits cleared, in place of rounded
                to nearest (lo = x - hi as committed)
  round_lo      lo = tf32(x - hi) rounded to nearest, in place of x - hi
                passed as it is (the tensor core cuts it toward zero)
  trunc_hi      hi cut as trunc_split, lo rounded as round_lo
  no_fresh      the partial products into the running sum, in place of a
                fresh accumulator a k-step
  bn16          16 streamed rows at D 256 (two cp.async stages), not 32
Prints a line a variant (time back to back in turns, max abs err against
the plain VJP, each output's distance to the f64 VJP beside the plain
VJP's, registers), then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPE = (2, 8, 1, 2048, 256)            # B, H, KV, S, D
LOOP = "#pragma unroll 2\n  for (int ks = 0; ks < KS; ++ks)"
ROW2 = ("    lt_step<1, 0, true>(t, a, b);\n    lt_step<0, 1, false>(t, a, b);\n"
        "    lt_step<0, 0, false>(t, a, b);\n  }")
VARIANTS = {
    "committed": [],
    "six_products": [("#define LT_PARTS 2", "#define LT_PARTS 3")],
    "unroll4": [(LOOP, LOOP.replace("unroll 2", "unroll 4"))],
    "nc4": [("static constexpr int NC = 8;", "static constexpr int NC = 4;")],
    "trunc_split": [
        ("  p[0] = lt_tf32(x);", "  p[0] = __float_as_uint(x) & 0xFFFFE000u;")],
    "round_lo": [("  } else {\n    p[1] = __float_as_uint(r);\n  }",
                  "  } else {\n    p[1] = lt_tf32(r);\n  }")],
    "trunc_hi": [("  p[0] = lt_tf32(x);",
                  "  p[0] = __float_as_uint(x) & 0xFFFFE000u;"),
                 ("  } else {\n    p[1] = __float_as_uint(r);\n  }",
                  "  } else {\n    p[1] = lt_tf32(r);\n  }")],
    "no_fresh": [(ROW2, ROW2.replace("(t, a, b)", "(acc, a, b)")
                  .replace("<1, 0, true>", "<1, 0, false>")
                  .replace("  }", "    return;\n  }"))],
    "bn16": [("BN = D == 256 ? 32 : 64;", "BN = D == 256 ? 16 : 64;")],
}


def build_variant(out, name, sources, subs, extra=()):
    """Start ``nvcc`` on a variant: ``sources`` (``csrc`` file names, the
    .cu first, then the headers it includes by quotes) copied to
    ``out/name/`` with each substitution made where its text is, into
    ``out/name.so`` with the ``csrc`` files ``extra``; returns the
    process."""
    from repro_torch.kernels import build

    texts = {src: (build.CSRC / src).read_text() for src in sources}
    for old, new in subs:
        hit = [src for src, text in texts.items() if old in text]
        if not hit:
            raise SystemExit(f"{name}: {old!r} is in none of {sources}")
        for src in hit:
            texts[src] = texts[src].replace(old, new)
    here = out / name
    here.mkdir(parents=True, exist_ok=True)
    for src, text in texts.items():
        (here / src).write_text(text)
    return subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
         "-shared", "-o", str(out / f"{name}.so"), str(here / sources[0]),
         *(str(build.CSRC / src) for src in extra)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def start_build(name, subs):
    return build_variant(ROOT / "build" / "attn_bwd_variants", name,
                         ("local_attn_bwd_tf32.cu",
                          "local_attn_tf32_common.cuh"), subs,
                         extra=("local_attn_bwd.cu",))


def registers(text):
    """The registers of each kernel as ``nvcc -Xptxas -v`` reports them."""
    return sorted({line.split("Used ")[1].split(",")[0]
                   for line in text.splitlines() if "registers" in line})


def load(name, proc):
    from repro_torch.kernels import build

    text, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{text}")
    regs = registers(text)
    lib = ctypes.CDLL(str(ROOT / "build" / "attn_bwd_variants" /
                          f"{name}.so"))
    fn = lib.local_attn_bwd_tf32_launch
    fn.argtypes = build.SIGNATURES["local_attn_bwd_tf32_launch"]
    fn.restype = ctypes.c_int
    return fn, regs


def main(names) -> int:
    import torch
    from chip_smoke import card_line, cuda_ms, f64_distance
    from repro_torch.kernels import build
    from repro_torch.kernels.local_attn import ops
    from repro_torch.kernels.local_attn.ref import local_attention_bwd_ref

    if not torch.cuda.is_available():
        print("attn_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    names = names or list(VARIANTS)
    procs = {name: start_build(name, VARIANTS[name]) for name in names}
    built = {name: load(name, proc) for name, proc in procs.items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, KV, S, D = SHAPE
    scale = D ** -0.5
    q, dout = (torch.randn(B, H, S, D, generator=gen, device=dev)
               for _ in range(2))
    k, v = (torch.randn(B, KV, S, D, generator=gen, device=dev)
            for _ in range(2))
    _, lse = ops._forward_cuda(q, k, v, True, 0, scale, True)
    kw = dict(causal=True, window=0, scale=scale)
    plain = local_attention_bwd_ref(q, k, v, dout, **kw)
    exact = local_attention_bwd_ref(q.double(), k.double(), v.double(),
                                    dout.double(), **kw)

    def runner(fn):
        def run():
            delta, rinv = (torch.empty(B, H, S, device=dev) for _ in range(2))
            heads = torch.empty(2 * B * H * S * D, device=dev)
            dq = torch.empty_like(q)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                           rinv.data_ptr(), heads.data_ptr(), B, H, KV, S, S,
                           D, scale, 1, 0, 0,
                           build.stream_handle(dev)), "variant")
            return dq, dk, dv
        return run

    runs = {name: runner(fn) for name, (fn, _) in built.items()}
    rows = {}
    for name, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        rows[name] = {
            "max_abs_err": max((a - w).abs().max().item()
                               for a, w in zip(got, plain, strict=True)),
            "f64": [(round(f64_distance(a, e) / f64_distance(w, e), 3))
                    for a, w, e in zip(got, plain, exact, strict=True)],
            "ms": [], "registers": built[name][1]}
    for turn in (*runs, *reversed(runs)):
        rows[turn]["ms"].append(cuda_ms(runs[turn], iters=10, warmup=2))
    for name, row in rows.items():
        print(f"[attn variants] {name}: ms {row['ms']}, max abs err "
              f"{row['max_abs_err']:.3e}, distance to f64 over the plain "
              f"VJP's (dq, dk, dv) {row['f64']}, registers "
              f"{row['registers']}")
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
