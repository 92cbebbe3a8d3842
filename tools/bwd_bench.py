"""The two backward kernels at the training path's shapes, on the card.

    python3 tools/bwd_bench.py [attn] [ssd]

attn: local_attn's gradient at gemma-2b's training shape (B 2, H 8, KV 1,
S 2048, D 256, causal): the bf16 tensor-core route
(``csrc/local_attn_bwd_tc.cu``) and the f32 split-tf32 route
(``csrc/local_attn_bwd_tf32.cu``), each with its max abs error against
the plain VJP, its time back to back, its own device time in all and by
kernel (dq; the dv and dk passes, or the dk/dv kernel; the fold), beside the plain VJP, the
forward + backward through ``LocalAttnFn`` and SDPA's forward + backward
in the same dtype; the f32 route's outputs also with their and the plain
VJP's distance to the VJP evaluated in f64 (``tools/attn_bwd_variants.py``
times the f32 route's design choices).  ssd: ``ssd_chunk``'s gradient at
mamba2-370m's (b 2, 8 chunks of 256, h 32, p 64, g 1, n 128), its heads
per CTA, error, time and device time beside the plain VJP.  Prints a line
per measurement, a JSON line and the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def attn(dev, gen):
    import torch
    import torch.nn.functional as F
    from chip_smoke import cuda_ms, device_ms, f64_distance
    from repro_torch.kernels.local_attn import ops
    from repro_torch.kernels.local_attn.ref import local_attention_bwd_ref

    out = {}
    b, h, s, d = 2, 8, 2048, 256
    scale = d ** -0.5
    for dtype in (torch.bfloat16, torch.float32):
        q, dout = (torch.randn(b, h, s, d, generator=gen, device=dev)
                   .to(dtype) for _ in range(2))
        k, v = (torch.randn(b, 1, s, d, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        _, lse = ops._forward_cuda(q, k, v, True, 0, scale, True)

        def kernel():
            return ops.local_attention_bwd(q, k, v, lse, dout, causal=True,
                                           window=0, scale=scale)

        def fwd_bwd():
            live = [t.clone().requires_grad_() for t in (q, k, v)]
            o = ops.local_flash_attention(*live, causal=True, scale=scale)
            return torch.autograd.grad(o, live, dout)

        def library():
            live = [t.clone().requires_grad_() for t in (q, k, v)]
            o = F.scaled_dot_product_attention(*live, is_causal=True,
                                               scale=scale, enable_gqa=True)
            return torch.autograd.grad(o, live, dout)

        kw = dict(causal=True, window=0, scale=scale)
        plain = local_attention_bwd_ref(q, k, v, dout, **kw)
        tag = f"attn {str(dtype)[6:]} ({ops.route(dtype, d)} route)"
        got = kernel()
        res = {"max_abs_err": max((a.float() - w.float()).abs().max().item()
                                  for a, w in zip(got, plain, strict=True))}
        if dtype == torch.float32:
            exact = local_attention_bwd_ref(q.double(), k.double(),
                                            v.double(), dout.double(), **kw)
            res["f64_distance"] = {
                name: [f64_distance(a, e), f64_distance(w, e)]
                for name, a, w, e in zip(("dq", "dk", "dv"), got, plain,
                                         exact, strict=True)}
            del exact
        del got, plain
        torch.cuda.empty_cache()
        res.update({
            "ms": cuda_ms(kernel, iters=20, warmup=3),
            "device_ms": device_ms("local_attn_bwd", kernel, iters=10),
            "device_ms_by_kernel": kernel_split(kernel),
            "fwd_bwd_ms": cuda_ms(fwd_bwd, iters=10, warmup=2),
            "plain_ms": cuda_ms(lambda: local_attention_bwd_ref(
                q, k, v, dout, **kw), iters=5, warmup=1),
            "library_ms": cuda_ms(library, iters=10, warmup=2)})
        print(f"[bwd_bench] {tag}: {json.dumps(res)}")
        out[tag] = res
        del q, k, v, dout, lse
        torch.cuda.empty_cache()
    return out


def kernel_split(fn, iters: int = 10) -> dict:
    """Device ms a call of each kernel of a local_attn backward: dq, the
    tensor-core route's dv and dk passes (its dk/dv kernel at DK false,
    true) or the split-tf32 route's dk/dv kernel, the fold."""
    from chip_smoke import device_events, KERNEL_SYMBOLS

    own, _ = device_events(fn, KERNEL_SYMBOLS["local_attn_bwd"], iters, 2)
    out = {}
    for e in own:
        name = ("dq" if "_dq_kernel" in e.name else
                "fold" if "fold" in e.name else
                "dkdv" if "tf32" in e.name else
                "dk" if "true" in e.name or "Lb1E" in e.name else "dv")
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / iters \
            / 1e3
    return out


def ssd(dev, gen):
    import torch
    from chip_smoke import cuda_ms, device_ms, ssd_kernel_inputs
    from repro_torch.kernels.ssd_chunk import ops
    from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_bwd_ref

    shape = (2, 8, 256, 32, 64, 1, 128)
    b, c, l, h, p, g, n = shape
    xdt, dA, B, C = ssd_kernel_inputs(gen, *shape)
    dy = torch.randn(xdt.shape, generator=gen, device=dev)
    dst = torch.randn((b, c, h, n, p), generator=gen, device=dev)
    args = (xdt, dA, B, C, dy, dst)
    plain = ssd_intra_chunk_bwd_ref(*args)
    err = max((a - w).abs().max().item()
              for a, w in zip(ops.ssd_intra_chunk_bwd(*args), plain,
                              strict=True))
    res = {"shape": shape, "max_abs_err": err,
           "heads_per_block": ops.bwd_heads_per_block(
               b * c, h, g, ops._sm_count(dev.index), l, p, n),
           "ms": cuda_ms(lambda: ops.ssd_intra_chunk_bwd(*args), iters=20,
                         warmup=3),
           "device_ms": device_ms("ssd_chunk_bwd",
                                  lambda: ops.ssd_intra_chunk_bwd(*args),
                                  iters=10),
           "plain_ms": cuda_ms(lambda: ssd_intra_chunk_bwd_ref(*args),
                               iters=5, warmup=1)}
    print(f"[bwd_bench] ssd: {json.dumps(res)}")
    return {"ssd": res}


def main(which) -> int:
    import torch
    from chip_smoke import card_line

    if not torch.cuda.is_available():
        print("bwd_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, fn in (("attn", attn), ("ssd", ssd)):
        if not which or name in which:
            out.update(fn(dev, gen))
    print(json.dumps(out))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
