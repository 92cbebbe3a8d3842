"""Public wrappers of the fused intra-chunk SSD.

``ssd_intra_chunk``: CUDA tensors launch ``csrc/ssd_chunk.cu``, CPU tensors
run ``ref.ssd_intra_chunk_ref``.  B and C come once per group, (b, c, l, g,
n): head ``hi`` reads group ``hi // (h // g)``, and ``g == h`` is the
reference kernel's head-broadcast call.  The kernel forms C Bᵀ once per
group and block of heads (``heads_per_block``), runs all three products on
the tensor cores from exact three-way tf32 splits of their operands
(``csrc/ssd_chunk.cu``), and takes any l, n and p.

``ssd_intra_chunk_bwd`` is its gradient: CUDA tensors launch
``csrc/ssd_chunk_bwd.cu`` (one C call: a kernel per (batch, chunk, block
of heads, ``bwd_heads_per_block``) on the tensor cores by the same exact
split, and an ordered fold of the head blocks' dB and dC partials over
each group), CPU tensors run ``ref.ssd_intra_chunk_bwd_ref``.
``SsdIntraChunkFn`` is the ``torch.autograd.Function`` that pairs the
two.

``ssd_chunked_fused`` is the whole chunked scan around it, with the
signature and semantics of ``repro_torch.models.ssm.ssd_chunked``:
  x: (b, l, h, p), dt: (b, l, h), A: (h,), B/C: (b, l, g, n)
  -> (y (b, l, h, p), final_state (b, h, p, n))
Pipeline, as the reference's ``ssd_chunked_pallas`` but without its
per-head copies of B and C: pad to the chunk, the kernel for (y_diag,
chunk states), then the inter-chunk recurrence and the off-diagonal term
(from the grouped C) in PyTorch, differentiated by autograd; the kernel
pair through ``SsdIntraChunkFn``.

DTensor inputs (a model run on a ``DeviceMesh``) run ``ssd_chunked_fused``
on each rank's shards through ``local_map``: batch and, where the heads and
the groups both divide by the mesh extent, heads (and their groups) stay
sharded; the sequence is gathered first.  ``meta`` shards (the dry-run)
take the plain ``ssd_intra_chunk_ref``, which follows shapes.

``launches`` counts every launch, forward and backward; ``launches_bwd``
the backward's alone.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ssd_chunk.ref import (
    ssd_intra_chunk_bwd_ref,
    ssd_intra_chunk_ref,
)

HEADS_PER_BLOCK = (4, 2, 1)     # the kernel's instantiations, largest first
MAX_SMEM = 232_448              # SSD_MAX_SMEM in csrc/ssd_chunk.cu
BWD_TILE = 32                   # SB_T in csrc/ssd_chunk_bwd.cu
launches = 0
launches_bwd = 0


def smem_bytes(hb: int, l: int) -> int:
    """Dynamic shared memory of a CTA of ``hb`` heads at chunk length l, as
    ``csrc/ssd_chunk.cu``'s launcher sizes it: a 3-stage ring of the
    largest step's tiles, G, and dA_cum for each head."""
    stage = max(2 * 64 * 68, (1 + hb) * 32 * 72)
    return 4 * (3 * stage + 64 * 68 + hb * 64 * -(-l // 64))


def heads_per_block(blocks: int, h: int, g: int, sms: int, l: int) -> int:
    """Heads a CTA takes: the most of ``HEADS_PER_BLOCK`` that divides the
    heads of a group, fits shared memory at chunk length l and still gives
    every one of ``sms`` SMs a CTA (``blocks`` = b * c CTAs per head
    block), else the fewest that fits.  The kernel forms C Bᵀ once per
    CTA, so more heads a CTA is less work.  Raises where none fits."""
    fits = [hb for hb in HEADS_PER_BLOCK
            if (h // g) % hb == 0 and smem_bytes(hb, l) <= MAX_SMEM]
    if not fits:
        raise ValueError(f"ssd_chunk: a chunk of {l} does not fit a block's "
                         "shared memory")
    for hb in fits:
        if blocks * (h // hb) >= sms:
            return hb
    return fits[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ssd_intra_chunk(xdt, dA, B, C):
    """xdt: (b,c,l,h,p); dA: (b,c,l,h); B, C: (b,c,l,g,n) with g dividing
    h, all f32.  Returns (y_diag (b,c,l,h,p), states (b,c,h,n,p))."""
    if not build.on_cuda("ssd_chunk", xdt, dA, B, C):
        return ssd_intra_chunk_ref(xdt, dA, B, C)
    build.require_f32_contiguous("ssd_chunk", xdt=xdt, dA=dA, B=B, C=C)
    if xdt.dim() != 5 or B.dim() != 5:
        raise ValueError("ssd_chunk: xdt must be (b, c, l, h, p) and B, C "
                         "(b, c, l, g, n)")
    b, c, l, h, p = xdt.shape
    g, n = B.shape[3], B.shape[4]
    if g < 1 or h % g:
        raise ValueError(f"ssd_chunk: {h} heads over {g} groups")
    for name, t, want in (("dA", dA, (b, c, l, h)), ("B", B, (b, c, l, g, n)),
                          ("C", C, (b, c, l, g, n))):
        if tuple(t.shape) != want:
            raise ValueError(f"ssd_chunk: {name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
    y = torch.empty_like(xdt)
    states = torch.empty((b, c, h, n, p), dtype=torch.float32,
                         device=xdt.device)
    if y.numel() == 0 or states.numel() == 0:      # empty sums
        return y.zero_(), states.zero_()
    hb = heads_per_block(b * c, h, g, _sm_count(xdt.device.index), l)
    status = build.launch_sized(
        "ssd_chunk_launch",
        xdt.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(), b, c, l, h,
        g, p, n, hb, y.data_ptr(), states.data_ptr(),
        build.stream_handle(xdt.device))
    build.check(status, "ssd_chunk")
    build.count(__name__, "launches")
    return y, states


def bwd_smem_bytes(hb: int, l: int, p: int, n: int) -> int:
    """Dynamic shared memory of the backward kernel's CTA of ``hb`` heads,
    as ``csrc/ssd_chunk_bwd.cu``'s ``sb_layout`` sizes it: n and p padded
    to the 32-wide tiles (row strides + 4 for the operands, + 8 for the
    running sums); C_i and the heads' dy (or the decay products E), then
    G, D / PG, PD and M (or the dstates slices), B_j and the heads' xdt,
    the dB / dC and dxdt sums and cum, all f32; then two f64 vectors of l
    a head (d cum and the decay terms)."""
    t = BWD_TILE
    nw, pw = -(-n // t) * t, -(-p // t) * t
    ldn, ldp, ld1, ld2 = nw + 4, pw + 4, nw + 8, pw + 8
    lp = -(-l // t) * t
    ra = max(t * ldn + hb * t * ldp, hb * t * ld2)
    rb = max((2 + hb) * t * 40 + hb * t * 33, hb * t * ldp)
    floats = (ra + rb + t * ldn + hb * t * ldp + t * ld1 + hb * t * ld2
              + hb * lp)
    return 4 * (floats + floats % 2) + 8 * 2 * hb * l


def bwd_heads_per_block(blocks: int, h: int, g: int, sms: int, l: int,
                        p: int, n: int) -> int:
    """Heads a backward CTA takes: the most of ``HEADS_PER_BLOCK`` that
    divides the heads of a group, fits shared memory and still gives at
    least 90 % of the ``sms`` SMs a CTA (``blocks`` = b * c CTAs per head
    block: at mamba2-370m's training shape 4 heads make 128 CTAs for 132
    SMs, one wave, where 2 would make two and form G twice as often), else
    the fewest that fits.  Raises where none fits."""
    fits = [hb for hb in HEADS_PER_BLOCK
            if (h // g) % hb == 0 and bwd_smem_bytes(hb, l, p, n) <= MAX_SMEM]
    if not fits:
        raise ValueError(f"ssd_chunk backward: l {l}, p {p}, n {n} do not "
                         "fit a block's shared memory")
    for hb in fits:
        if 10 * blocks * (h // hb) >= 9 * sms:
            return hb
    return fits[-1]


def ssd_intra_chunk_bwd(xdt, dA, B, C, dy, dstates):
    """The gradient of ``ssd_intra_chunk``: dy (b,c,l,h,p) and dstates
    (b,c,h,n,p) -> (dxdt, d(dA), dB, dC), shaped as xdt, dA, B, C.  f32,
    contiguous."""
    if not build.on_cuda("ssd_chunk", xdt, dA, B, C, dy, dstates):
        return ssd_intra_chunk_bwd_ref(xdt, dA, B, C, dy, dstates)
    build.require_f32_contiguous("ssd_chunk", xdt=xdt, dA=dA, B=B, C=C,
                                 dy=dy, dstates=dstates)
    b, c, l, h, p = xdt.shape
    g, n = B.shape[3], B.shape[4]
    for name, t, want in (("dA", dA, (b, c, l, h)), ("B", B, (b, c, l, g, n)),
                          ("C", C, (b, c, l, g, n)), ("dy", dy, xdt.shape),
                          ("dstates", dstates, (b, c, h, n, p))):
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"ssd_chunk backward: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(want)}")
    if g < 1 or h % g:
        raise ValueError(f"ssd_chunk backward: {h} heads over {g} groups")
    dxdt, ddA = torch.empty_like(xdt), torch.empty_like(dA)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    if xdt.numel() == 0 or B.numel() == 0:
        return dxdt.zero_(), ddA.zero_(), dB.zero_(), dC.zero_()
    hb = bwd_heads_per_block(b * c, h, g, _sm_count(xdt.device.index), l,
                             p, n)
    # the head blocks' dB and dC before the fold over each group's blocks
    scratch = torch.empty(2 * b * c * (h // hb) * l * n, dtype=torch.float32,
                          device=xdt.device)
    status = build.launch_sized(
        "ssd_chunk_bwd_launch",
        xdt.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
        dy.data_ptr(), dstates.data_ptr(), b, c, l, h, g, p, n, hb,
        dxdt.data_ptr(), ddA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        scratch.data_ptr(), build.stream_handle(xdt.device))
    build.check(status, "ssd_chunk backward")
    build.count(__name__, "launches", "launches_bwd")
    return dxdt, ddA, dB, dC


class SsdIntraChunkFn(torch.autograd.Function):
    """``ssd_intra_chunk`` with ``ssd_intra_chunk_bwd`` as its gradient."""

    @staticmethod
    def forward(ctx, xdt, dA, B, C):
        ctx.save_for_backward(xdt, dA, B, C)
        return ssd_intra_chunk(xdt, dA, B, C)

    @staticmethod
    def backward(ctx, dy, dstates):
        xdt, dA, B, C = ctx.saved_tensors
        b, c, l, h, p = xdt.shape
        dy = torch.zeros_like(xdt) if dy is None else dy.contiguous()
        dstates = (xdt.new_zeros((b, c, h, B.shape[4], p)) if dstates is None
                   else dstates.contiguous())
        return ssd_intra_chunk_bwd(xdt, dA, B, C, dy, dstates)


def _on_mesh(x, dt, A, B, C, chunk, init_state):
    """``ssd_chunked_fused`` of DTensors, shard by shard."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.logical import kernel_split, split_placements

    mesh = x.device_mesh
    split = kernel_split(x, batch=0, heads=2, counts=(x.shape[2], B.shape[2]))
    pl_x = split_placements(split, batch=0, heads=2)       # x, dt, B, C
    pl_a = split_placements(split, batch=None, heads=0)    # A
    pl_s = split_placements(split, batch=0, heads=1)       # states

    def on(t, pl):
        if not isinstance(t, DTensor):       # made by the caller: replicated
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, pl)

    args = [on(x, pl_x), on(dt, pl_x), on(A, pl_a), on(B, pl_x), on(C, pl_x)]
    in_pl = [pl_x, pl_x, pl_a, pl_x, pl_x]
    if init_state is not None:
        args.append(on(init_state, pl_s))
        in_pl.append(pl_s)

    def on_shards(*a):
        # meta shards (the dry-run, shapes only) take the plain version
        intra = (ssd_intra_chunk_ref if a[0].device.type == "meta"
                 else SsdIntraChunkFn.apply)
        return _chunked(*a[:5], chunk, a[5] if len(a) > 5 else None, intra)

    run = local_map(on_shards, out_placements=(pl_x, pl_s),
                    in_placements=tuple(in_pl), device_mesh=mesh)
    return run(*args)


def ssd_chunked_fused(x, dt, A, B, C, chunk: int, init_state=None):
    if hasattr(x, "device_mesh"):
        return _on_mesh(x, dt, A, B, C, chunk, init_state)
    return _chunked(x, dt, A, B, C, chunk, init_state, SsdIntraChunkFn.apply)


def _chunked(x, dt, A, B, C, chunk: int, init_state, intra):
    """The chunked scan around ``intra`` (the kernel pair's Function, or
    the plain ``ssd_intra_chunk_ref``)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    L = l + pad
    c = L // chunk
    r = h // g
    f32 = torch.float32

    xc = x.reshape(b, c, chunk, h, p).to(f32)
    dtc = dt.reshape(b, c, chunk, h).to(f32)
    Bg = B.reshape(b, c, chunk, g, n).to(f32)
    Cg = C.reshape(b, c, chunk, g, n).to(f32)
    xdt = xc * dtc[..., None]
    dA = dtc * A[None, None, None, :]

    y_diag, states = intra(xdt.contiguous(), dA.contiguous(),
                           Bg.contiguous(), Cg.contiguous())
    states = states.transpose(3, 4)                        # (b,c,h,p,n)

    # inter-chunk recurrence (sequential over c)
    dA_cum = torch.cumsum(dA.permute(0, 3, 1, 2), dim=-1)  # (b,h,c,l)
    chunk_decay = torch.exp(dA_cum[..., -1])               # (b,h,c)
    carry = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for ci in range(c):
        prev.append(carry)                                 # state *before* chunk
        carry = carry * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                 # (b,c,h,p,n)

    # off-diagonal output: prior state flowing into each chunk position,
    # the heads seen as (g, h // g) so each group's C serves its heads
    state_decay_out = torch.exp(dA_cum)                    # (b,h,c,l)
    y_off = torch.einsum("bclgn,bcgrpn,bgrcl->bclgrp", Cg,
                         prev_states.reshape(b, c, g, r, p, n),
                         state_decay_out.reshape(b, g, r, c, chunk))

    y = (y_diag + y_off.reshape(b, c, chunk, h, p)).reshape(b, L, h, p)
    return y[:, :l].to(x.dtype), carry.to(x.dtype)
