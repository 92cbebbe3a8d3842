"""Public wrapper of the windowed flash attention: CUDA tensors launch one
of two kernels, CPU tensors run ``ref.local_attention_ref``.

``route`` picks the kernels from the dtype and head_dim alone:

- ``"tc"``: bf16 at D 64, 128 or 256 runs ``csrc/local_attn_tc.cu`` on the
  tensor cores.  It reads q, k, v and writes the output by their strides
  (last dimension contiguous), and TMA fills rows past S or T with zeros,
  so nothing is padded or copied; the output takes q's layout.
- ``"tf32"`` (every f32 call, and bf16 at D 16 or 32): the forward runs
  ``csrc/local_attn_tf32.cu`` on the tensor cores in split tf32 (mma.sync,
  ``TF32_PRODUCTS`` partial products a product, as the backward), reading
  q, k, v and writing the output by their strides as the tensor-core
  route does; cp.async fills rows past S or T with zeros, so nothing is
  padded, and nothing is copied unless a stride is not a multiple of 16
  bytes.

A head dim between the instantiations (hubert-xlarge's 80, MLA's 192) is
zero-padded on the last dim of q, k and v to the next one
(``padded_head_dim``, ``pad_head_dim``): the padded columns add nothing to
q·k, the caller's ``scale`` is passed on unchanged, and the output is
sliced back to D.  The route follows the padded D.  D > 256 raises.

The call is a ``torch.autograd.Function`` (``LocalAttnFn``) on every
route.  When a gradient is needed, the forward kernel also writes each
row's log-sum-exp (its ``lse`` output; null otherwise, so scoring runs
the kernel as before), and the gradient runs ``local_attention_bwd`` on
the forward's route (``route`` decides both directions):
- ``"tc"``: ``csrc/local_attn_bwd_tc.cu`` on the tensor cores (one C call:
  the dq kernel, which first sums each row's delta = sum_t P dP from S and
  dP, the dv and the dk pass, a query head a CTA, and the fold of a kv
  head's query heads in order); q, k, v and dout by their strides, as the
  forward reads them.
- ``"tf32"``: ``csrc/local_attn_bwd_tf32.cu`` on the
  tensor cores in split tf32 (one C call: the dq kernel, whose first pass
  sums each row's P and P dP, the dk/dv kernel, a query head a CTA, and
  the same fold); dense inputs.  ``TF32_PRODUCTS`` partial products a
  product, two-part splits (``tests/test_torch_attn_bwd_tf32.py``
  emulates the scheme).
CPU tensors run ``ref.local_attention_bwd_ref``.  The D padding stays
outside the Function, so its gradient is PyTorch's.

DTensor inputs (a model run on a ``DeviceMesh``) run the same route on
each rank's shards through ``local_map``: batch and, where the query and
the kv heads both divide by the mesh extent, heads stay sharded; sequence
and head_dim are gathered first.  The backward runs on the shards too.

``launches`` counts every launch, forward and backward; ``launches_tc``
and ``launches_tf32`` the forward's two routes; ``launches_bwd`` the
backward's, and ``launches_bwd_tc`` and ``launches_bwd_tf32`` its two
routes'.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.local_attn.ref import (
    local_attention_bwd_ref,
    local_attention_ref,
)

HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernels' instantiations
TC_HEAD_DIMS = (64, 128, 256)        # local_attn_tc.cu's
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0
launches_tc = 0
launches_tf32 = 0
launches_bwd = 0
launches_bwd_tc = 0
launches_bwd_tf32 = 0
# the split-tf32 route's partial products a product, both directions
# (csrc/local_attn_tf32_common.cuh, LT_PARTS 2: three)
TF32_PRODUCTS = 3


def padded_head_dim(head_dim: int) -> int:
    """The instantiated head dim a call of ``head_dim`` runs at: the least
    of ``HEAD_DIMS`` that holds it."""
    for d in HEAD_DIMS:
        if head_dim <= d:
            return d
    raise ValueError(f"local_attn: head_dim {head_dim} is above the "
                     f"kernels' largest, {HEAD_DIMS[-1]}")


def pad_head_dim(q, k, v):
    """q, k, v zero-padded on the last dim to ``padded_head_dim``; the
    tensors themselves where D is instantiated."""
    extra = padded_head_dim(q.shape[-1]) - q.shape[-1]
    if not extra:
        return q, k, v
    return tuple(F.pad(t, (0, extra)) for t in (q, k, v))


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernels a CUDA call takes, both ways: ``"tc"`` (bf16 on wgmma)
    or ``"tf32"`` (f32, and bf16 at D 16 or 32: split tf32 on mma.sync)."""
    if dtype == torch.bfloat16 and padded_head_dim(head_dim) in TC_HEAD_DIMS:
        return "tc"
    return "tf32"


def tma_strides(t: torch.Tensor) -> tuple[int, int, int] | None:
    """(batch, head, row) strides of a (B, H, S, D) tensor as the
    tensor-core kernel takes them, or None when TMA cannot read it in place
    (last dimension not contiguous, a stride or the address not a multiple
    of 16 bytes).  A dimension of size 1 is never stepped over, so its
    stride is given as D."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return None
    out = tuple(st if n > 1 else t.shape[-1]
                for n, st in zip(t.shape[:3], t.stride()[:3], strict=True))
    return out if all(st > 0 and st % 8 == 0 for st in out) else None


def _tma_inputs(*tensors):
    """The tensors as TMA reads them (a view it cannot step through is
    copied dense) and their (batch, head, row) strides, concatenated."""
    ins, strides = [], []
    for t in tensors:
        st = tma_strides(t)
        if st is None:
            t = t.clone(memory_format=torch.contiguous_format)
            st = tma_strides(t)
        ins.append(t)
        strides.extend(st)
    return ins, strides


def _launch(q, k, v, causal, window, scale, lse):
    """One forward launch on ``route``'s kernel: q, k, v and the output by
    their strides (the output in q's layout when q is dense)."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    tc = route(q.dtype, D) == "tc"
    (q, k, v), strides = _tma_inputs(q, k, v)
    out = torch.empty_like(q)
    strides.extend(tma_strides(out))
    lse_ptr = None if lse is None else lse.data_ptr()
    stream = build.stream_handle(q.device)
    if tc:
        status = build.library().local_attn_tc_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            KV, S, T, D, *strides, float(scale), int(bool(causal)),
            int(window), lse_ptr, stream)
    else:
        status = build.launch_sized(
            "local_attn_tf32_launch", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, H, KV, S, T, D, *strides,
            float(scale), int(bool(causal)), int(window), _DTYPES[q.dtype],
            lse_ptr, stream)
    build.check(status, "local_attn")
    build.count(__name__, "launches", "launches_tc" if tc else "launches_tf32")
    return out


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("local_attn: q, k, v must be (B, H|KV, S|T, D)")
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KV, T, D) or tuple(v.shape) != (B, KV, T, D):
        raise ValueError(f"local_attn: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be {(B, KV, T, D)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"local_attn: q, k, v must share one dtype of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    padded_head_dim(D)                  # raises above the largest
    if KV < 1 or H % KV:
        raise ValueError(f"local_attn: {H} query heads over {KV} kv heads")
    if window < 0:
        raise ValueError(f"local_attn: window {window} < 0")


def _forward_cuda(q, k, v, causal, window, scale, need_lse):
    """(out, lse or None) from the forward kernels; D instantiated."""
    B, H, S, _ = q.shape
    lse = None
    if need_lse:
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal, window, scale, lse), lse


def local_attention_bwd(q, k, v, lse, dout, *, causal: bool, window: int,
                        scale: float):
    """The gradient (dq, dk, dv) of ``local_flash_attention`` at D
    instantiated, from the forward's row log-sum-exp ``lse`` (B, H, S)
    (unused on the CPU, which recomputes the softmax)."""
    if not build.on_cuda("local_attn", q, k, v, dout):
        return local_attention_bwd_ref(q, k, v, dout, causal=causal,
                                       window=window, scale=scale)
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"local_attn backward: head_dim {D} is not one of "
                         f"{HEAD_DIMS}")
    lse = lse.contiguous()
    if tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"local_attn backward: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, expected {(B, H, S)} float32")
    dout = dout.to(q.dtype)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    # each query head's dk and dv before the ordered fold over a group
    heads = torch.empty(2 * B * H * T * D, dtype=torch.float32,
                        device=q.device)
    dense = dict(dtype=q.dtype, device=q.device)
    dq = torch.empty((B, H, S, D), **dense)
    dk, dv = (torch.empty((B, KV, T, D), **dense) for _ in range(2))
    if route(q.dtype, D) == "tc":
        (q, k, v, dout), strides = _tma_inputs(q, k, v, dout)
        status = build.launch_sized(
            "local_attn_bwd_tc_launch", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), heads.data_ptr(),
            B, H, KV, S, T, D, *strides, float(scale), int(bool(causal)),
            int(window), build.stream_handle(q.device))
        build.check(status, "local_attn backward")
        build.count(__name__, "launches", "launches_bwd", "launches_bwd_tc")
        return dq, dk, dv
    # the split-tf32 kernels read rows by 16-byte copies: dense and aligned
    q, k, v, dout = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                     else t.clone(memory_format=torch.contiguous_format)
                     for t in (q, k, v, dout))
    rinv = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    status = build.launch_sized(
        "local_attn_bwd_tf32_launch", q.data_ptr(), k.data_ptr(),
        v.data_ptr(), dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), rinv.data_ptr(),
        heads.data_ptr(), B, H, KV, S, T, D, float(scale), int(bool(causal)),
        int(window), _DTYPES[q.dtype], build.stream_handle(q.device))
    build.check(status, "local_attn backward")
    build.count(__name__, "launches", "launches_bwd", "launches_bwd_tf32")
    return dq, dk, dv


class LocalAttnFn(torch.autograd.Function):
    """The forward kernels with ``local_attention_bwd`` as their gradient
    (the plain versions on the CPU); D instantiated on CUDA."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, need_grad):
        if build.on_cuda("local_attn", q, k, v):
            out, lse = _forward_cuda(q, k, v, causal, window, scale,
                                     need_grad)
        else:
            out, lse = local_attention_ref(q, k, v, causal=causal,
                                           window=window, scale=scale), None
        if need_grad:
            ctx.save_for_backward(q, k, v, lse)
            ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = local_attention_bwd(q, k, v, lse, dout, causal=causal,
                                         window=window, scale=scale)
        return dq, dk, dv, None, None, None, None


def _on_mesh(q, k, v, **kw):
    """``local_flash_attention`` of DTensors, shard by shard."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.logical import kernel_split, split_placements

    split = kernel_split(q, batch=0, heads=1, counts=(q.shape[1], k.shape[1]))
    pl = split_placements(split, batch=0, heads=1)
    q, k, v = (t.redistribute(q.device_mesh, pl) for t in (q, k, v))
    run = local_map(lambda a, b, c: _on_shards(a, b, c, **kw),
                    out_placements=(pl,), in_placements=(pl, pl, pl),
                    device_mesh=q.device_mesh)
    return run(q, k, v)


def _on_shards(q, k, v, **kw):
    """One rank's shards: the wrapper's route, or -- ``meta`` shards, a
    dry-run that only follows shapes -- the plain version."""
    if q.device.type == "meta":
        return local_attention_ref(q, k, v, **kw)
    return local_flash_attention(q, k, v, **kw)


def local_flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float = 1.0):
    """q: (B, H, S, D); k/v: (B, KV, T, D), f32 or bf16 -> (B, H, S, D) in
    q's dtype.  Arbitrary S/T, any D up to 256; differentiable."""
    if hasattr(q, "device_mesh"):
        return _on_mesh(q, k, v, causal=causal, window=window, scale=scale)
    need_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if not build.on_cuda("local_attn", q, k, v):
        return LocalAttnFn.apply(q, k, v, causal, window, scale, need_grad)
    _check(q, k, v, window)
    B, H, S, D = q.shape
    if B == 0 or H == 0 or S == 0:
        return q.new_empty((B, H, S, D))
    if k.shape[2] == 0:
        raise ValueError("local_attn: no keys (T = 0)")
    if padded_head_dim(D) != D:
        q, k, v = pad_head_dim(q, k, v)
        return local_flash_attention(q, k, v, causal=causal, window=window,
                                     scale=scale)[..., :D]
    return LocalAttnFn.apply(q, k, v, causal, window, scale, need_grad)
