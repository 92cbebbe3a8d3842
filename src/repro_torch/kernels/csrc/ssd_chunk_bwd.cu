// Gradient of the intra-chunk SSD of Mamba-2 (ssd_chunk.cu's function).
// For each (batch, chunk, head), with B and C shared by a group's heads:
//   cum = cumsum(dA); L_ij = exp(cum_i - cum_j) for i >= j, else 0;
//   G_ij = C_i . B_j; D_ij = dy_i . xdt_j; w_j = exp(cum[l-1] - cum_j);
//   dxdt_j = sum_i L_ij G_ij dy_i + w_j (B_j . dstates)
//   dC_i   = sum_j L_ij D_ij B_j
//   dB_j   = sum_i L_ij D_ij C_i + w_j (dstates xdt_j)
//   M_ij = L_ij G_ij D_ij adds to d cum_i and takes from d cum_j; the decay
//   term w_j u_j, u_j = xdt_j . (B_j . dstates), takes from d cum_j and
//   adds to d cum[l-1]; d(dA) is the reverse cumsum of d cum.
// dB and dC are summed over the heads of each group.  xdt, dy (b,c,l,h,p),
// dA (b,c,l,h), B, C (b,c,l,g,n), dstates (b,c,h,n,p), all f32 ->
// dxdt, d(dA), dB, dC in the inputs' shapes.
//
// Replaces the gradient of the Pallas kernel
// src/repro/kernels/ssd_chunk/ssd_chunk.py (ssd_intra_chunk -> _ssd_kernel),
// which has none: the reference trains through its jnp scan.  The plain
// version is kernels/ssd_chunk/ref.py's ssd_intra_chunk_bwd_ref.
//
// Bound on the H100: f32 operations.  At mamba2-370m's training shape (b 2,
// 8 chunks of 256, h 32, p 64, n 128, one group) the useful work (i >= j
// only; G once a group) is about 17.4 GFLOP against 0.13 GB moved:
// 0.26 ms at 67 TFLOP/s.
//
// Design: the forward's scheme (ssd_chunk.cu).  One CTA of 8 warps per
// (batch, chunk, block of HB heads of one group; ops.bwd_heads_per_block
// picks HB); nothing crosses CTAs but the block's dB and dC, which go to a
// scratch of h / HB partials.  The CTA walks the 32 x 32 tile pairs
// (i >= j) of the (l, l) matrices column by column: for each column tile
// j, for each row tile i >= j,
//   G = C_i B_j^T is formed once for the block's heads and D_h = dy_h,i
//   xdt_h,j^T once per head (shared memory); elementwise L_h, PG_h = L_h o
//   G (over D_h), M_h = PG_h o D_h and PD = sum_h L_h o D_h in head order;
//   M's row and column sums go into f64 sums of d cum; then dB_j +=
//   PD^T C_i and dC_i += PD B_j (one product each for the block's heads:
//   B and C are the group's) and dxdt_h,j += PG_h^T dy_h,i.
// At the column's end come the decay terms, over n in slices of 32 of
// dstates: E_h = B_j dstates_h, dB_j += sum_h w_h o (xdt_h,j dstates_h^T)
// in head order; then dxdt_h,j += w_h o E_h and u_h = xdt_h,j . E_h (f64).
// So G and D are formed once a tile pair.  dB_j and dxdt_h,j are done
// when their column is; their running sums (32 x n, HB x 32 x p, and E)
// live in shared memory, where a warp loads its piece into registers, adds
// the pair's k-steps and stores it back (the same arithmetic as a register
// running sum).  dC_i takes a term from every column j <= i, in j's order:
// its running sum is the block's dC partial itself, in global memory (L2),
// read and written by the same lanes at each pair (a rows phase that
// formed D again for it held 30 % of the pairs' products).  A
// block's dB and dC are its heads' sums in head order (PD); a fold adds
// the h / HB block partials of a group in order in f64
// (ssd_chunk_bwd_fold_kernel).  d(dA): the f64 sums, the decay terms and
// the reverse cumsum in f64, one thread a head.  cum is one thread's
// sequential scan a head, the forward's order (ssd_common.cuh); L is exp of
// the difference only where i >= j (never overflows).
//
// Products: mma.sync m16n8k8 tf32 on the exact three-way split, six
// partial products a k-step of 8 into fresh accumulators (two chains of
// three, sb_row6), then one round-to-nearest add into the running sum:
// the forward found that 3xTF32 sat 2.8x the plain version's distance from
// f64 and that sums left in the tensor core's accumulator lost the
// witness.  Operands are read from shared memory in whatever layout the
// product needs (transposed for PD^T, PG^T); a warp owns a 16 x 8NT piece
// of an output, the pieces of one step dealt out over the 8 warps.  The
// splits, not the tensor cores, bound the products: their round to tf32
// is done in integer arithmetic (sb_split3).  Tiles come by cp.async with
// rows and columns past l, n or p zero-filled; a pair's dy lands while G
// is formed, and otherwise a step's loads are waited for before it
// multiplies (no ring: the operands and sums take the shared memory).

#include "ssd_common.cuh"

#define SB_T 32           // l rows and columns of a tile pair
#define SB_GW 40          // row stride of the 32 x 32 tiles: G, D / PG, PD
#define SB_MW 33          // row stride of M

struct SbDims {
  int c, l, h, g, p, n;
  int lt, lp;      // 32-row tiles of l, and l padded to them
  int nw, pw;      // n and p padded to 32
  int ldn, ldp;    // row strides of the n- and p-wide operand tiles
  int ld1, ld2;    // row strides of the dB / dC and the dxdt / E sums
};

// float offsets into the dynamic shared memory; then 2 HB l doubles
struct SbLayout {
  int cs, ys, eacc;          // C_i and dy (or, at a column's end, E)
  int gs, ds, ps, ms, dsb;   // G, D / PG, PD, M (or the dstates slices)
  int bs, xs, acc1, acc2, cum, floats;
};

__host__ __device__ inline int sb_max(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline SbLayout sb_layout(int hb, const SbDims& d) {
  SbLayout o;
  const int ra = sb_max(SB_T * d.ldn + hb * SB_T * d.ldp, hb * SB_T * d.ld2);
  const int rb = sb_max((2 + hb) * SB_T * SB_GW + hb * SB_T * SB_MW,
                        hb * SB_T * d.ldp);
  o.cs = o.eacc = 0;
  o.ys = SB_T * d.ldn;
  o.gs = o.dsb = ra;
  o.ds = o.gs + SB_T * SB_GW;
  o.ps = o.ds + hb * SB_T * SB_GW;
  o.ms = o.ps + SB_T * SB_GW;
  o.bs = ra + rb;
  o.xs = o.bs + SB_T * d.ldn;
  o.acc1 = o.xs + hb * SB_T * d.ldp;
  o.acc2 = o.acc1 + SB_T * d.ld1;
  o.cum = o.acc2 + hb * SB_T * d.ld2;
  o.floats = (o.cum + hb * d.lp + 1) & ~1;   // the doubles on 8 bytes
  return o;
}

static size_t sb_smem_bytes(int hb, const SbDims& d) {
  return (size_t)sb_layout(hb, d).floats * 4 + (size_t)2 * hb * d.l * 8;
}

// rows 0 .. 31 of a slice whose rows are src_w floats apart into a tile of
// row stride dst_w: cols_pad columns (a multiple of VEC), those past
// cols_ok and rows past rows_ok zero-filled (``base`` is a valid address
// the skipped copies name)
template <int VEC>
__device__ __forceinline__ void sb_tile(float* dst, int dst_w,
                                        const float* src, int64_t src_w,
                                        int rows_ok, int cols_ok,
                                        int cols_pad, const float* base) {
  const int per_row = cols_pad / VEC, total = SB_T * per_row;
  for (int idx = threadIdx.x; idx < total; idx += SSD_THREADS) {
    const int r = idx / per_row, q = (idx - r * per_row) * VEC;
    const bool ok = r < rows_ok && q < cols_ok;
    ssd_cp<VEC>(dst + r * dst_w + q, ok ? src + r * src_w + q : base, ok);
  }
}

__device__ __forceinline__ void sb_landed() {
  ssd_commit();
  ssd_wait<0>();
  __syncthreads();
}

// ssd_split3 with the round to tf32 done in integer arithmetic: (bits +
// 0x1000) & ~0x1fff is cvt.rna.tf32.f32 for every finite x and for inf
// (a NaN stays a NaN through x - hi), and two integer operations cost
// less than the conversion, which bounds these products
// (tools/ssd_bwd_variants.py times the kernel with either)
__device__ __forceinline__ uint32_t sb_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void sb_split3(float x, uint32_t& hi,
                                          uint32_t& mid, uint32_t& lo) {
  hi = sb_tf32(x);
  const float r = __fsub_rn(x, __uint_as_float(hi));
  mid = sb_tf32(r);
  lo = __float_as_uint(__fsub_rn(r, __uint_as_float(mid)));
}

// acc[nt] += a @ b[nt] from the exact splits of a and b: the six products
// as ssd_row6 takes them, but in two chains of three into two fresh
// accumulators, the three smallest (lo hi, hi lo, mid mid) and the three
// largest (mid hi, hi mid, hi hi), then acc += (large + small) rounded to
// nearest: two chains give the tensor core two products to overlap where
// ssd_row6's one chain waits on each (tools/ssd_bwd_variants.py times
// both)
template <int NT>
__device__ __forceinline__ void sb_row6(float (&acc)[NT][4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&am)[4],
                                        const uint32_t (&al)[4],
                                        const uint32_t (&bh)[NT][2],
                                        const uint32_t (&bm)[NT][2],
                                        const uint32_t (&bl)[NT][2]) {
  float t[NT][4], u[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    ssd_mma0(t[nt], al, bh[nt]);
    ssd_mma0(u[nt], am, bh[nt]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    ssd_mma(t[nt], ah, bl[nt]);
    ssd_mma(u[nt], ah, bm[nt]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    ssd_mma(t[nt], am, bm[nt]);
    ssd_mma(u[nt], ah, bh[nt]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[nt][e] = __fadd_rn(acc[nt][e], __fadd_rn(u[nt][e], t[nt][e]));
}

// acc (the warp's 16 x 8NT piece) += A (16 x K) B (K x 8NT), K a multiple
// of 8, over k-steps of 8 (sb_split3, then sb_row6: six products into two
// fresh accumulators, then one round-to-nearest add).  A(r, k) = TA ?
// A[k lda + r] : A[r lda + k]; B(k, c) = TB ? Bm[c ldb + k] : Bm[k ldb + c]; A and Bm
// point at the piece's first row and column.
template <int NT, bool TA, bool TB>
__device__ __forceinline__ void sb_mm(float (&acc)[NT][4],
                                      const float* __restrict__ A, int lda,
                                      const float* __restrict__ Bm, int ldb,
                                      int K) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 8) {
    const int ka = k0 + tq;
    uint32_t ah[4], am[4], al[4], bh[NT][2], bm[NT][2], bl[NT][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gq + 8 * (e & 1), k = ka + 4 * (e >> 1);
      sb_split3(TA ? A[k * lda + r] : A[r * lda + k], ah[e], am[e], al[e]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = 8 * nt + gq;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = ka + 4 * e;
        sb_split3(TB ? Bm[c * ldb + k] : Bm[k * ldb + c], bh[nt][e],
                   bm[nt][e], bl[nt][e]);
      }
    }
    sb_row6<NT>(acc, ah, am, al, bh, bm, bl);
  }
}

// a warp's 16 x 8NT piece of a shared-memory tile (at its first row and
// column) in the accumulator layout: rows gq and gq + 8, columns 2 tq, +1
template <int NT>
__device__ __forceinline__ void sb_load(float (&a)[NT][4], const float* p,
                                        int ld) {
  const int lane = threadIdx.x & 31;
  const float* q = p + (lane >> 2) * ld + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    a[nt][0] = q[8 * nt];
    a[nt][1] = q[8 * nt + 1];
    a[nt][2] = q[8 * ld + 8 * nt];
    a[nt][3] = q[8 * ld + 8 * nt + 1];
  }
}

template <int NT>
__device__ __forceinline__ void sb_store(const float (&a)[NT][4], float* p,
                                         int ld) {
  const int lane = threadIdx.x & 31;
  float* q = p + (lane >> 2) * ld + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    q[8 * nt] = a[nt][0];
    q[8 * nt + 1] = a[nt][1];
    q[8 * ld + 8 * nt] = a[nt][2];
    q[8 * ld + 8 * nt + 1] = a[nt][3];
  }
}

// the same for a piece of a tensor in global memory, rows past rows_ok
// and columns past cols_ok read as zeros and left unwritten
template <int NT>
__device__ __forceinline__ void sb_gload(float (&a)[NT][4], const float* p,
                                         int ld, int rows_ok, int cols_ok) {
  const int lane = threadIdx.x & 31, r = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = r + 8 * (e >> 1), cc = 8 * nt + c + (e & 1);
      a[nt][e] = rr < rows_ok && cc < cols_ok ? p[(int64_t)rr * ld + cc]
                                              : 0.0f;
    }
}

template <int NT>
__device__ __forceinline__ void sb_gstore(const float (&a)[NT][4], float* p,
                                          int ld, int rows_ok, int cols_ok) {
  const int lane = threadIdx.x & 31, r = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = r + 8 * (e >> 1), cc = 8 * nt + c + (e & 1);
      if (rr < rows_ok && cc < cols_ok) p[(int64_t)rr * ld + cc] = a[nt][e];
    }
}

template <int NT>
__device__ __forceinline__ void sb_zero(float (&a)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[nt][e] = 0.0f;
}

__device__ __forceinline__ void sb_clear(float* p, int n) {
  for (int idx = threadIdx.x; idx < n; idx += SSD_THREADS) p[idx] = 0.0f;
}

template <int HB, int VEC>
__global__ void __launch_bounds__(SSD_THREADS, 1)
ssd_chunk_bwd_kernel(const float* __restrict__ xdt,
                     const float* __restrict__ dA,
                     const float* __restrict__ B, const float* __restrict__ C,
                     const float* __restrict__ dy,
                     const float* __restrict__ dst, const SbDims d,
                     float* __restrict__ dxdt, float* __restrict__ ddA,
                     float* __restrict__ parts) {
  extern __shared__ __align__(16) float sb_smem[];
  const SbLayout o = sb_layout(HB, d);
  float* Cs = sb_smem + o.cs;
  float* Ys = sb_smem + o.ys;
  float* Es = sb_smem + o.eacc;
  float* Gs = sb_smem + o.gs;
  float* Ds = sb_smem + o.ds;
  float* Ps = sb_smem + o.ps;
  float* Ms = sb_smem + o.ms;
  float* Ss = sb_smem + o.dsb;
  float* Bs = sb_smem + o.bs;
  float* Xs = sb_smem + o.xs;
  float* acc1 = sb_smem + o.acc1;
  float* acc2 = sb_smem + o.acc2;
  float* cum = sb_smem + o.cum;
  double* dcum = reinterpret_cast<double*>(sb_smem + o.floats);  // HB x l
  double* wus = dcum + HB * d.l;                                 // HB x l

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2;
  const int l = d.l, n = d.n, p = d.p;
  const int ldn = d.ldn, ldp = d.ldp, ld1 = d.ld1, ld2 = d.ld2;
  const int head0 = blockIdx.x * HB, gi = head0 / (d.h / d.g);
  const int64_t bc = (int64_t)blockIdx.z * d.c + blockIdx.y;
  const int64_t row0 = bc * l;                  // first (b, c, i) row
  const int64_t gn = (int64_t)d.g * n, hp = (int64_t)d.h * p;
  const float* cbase = C + row0 * gn + (int64_t)gi * n;
  const float* bbase = B + row0 * gn + (int64_t)gi * n;
  const float* xbase = xdt + row0 * hp + (int64_t)head0 * p;  // head: + hs p
  const float* ybase = dy + row0 * hp + (int64_t)head0 * p;
  const float* sbase = dst + (bc * d.h + head0) * (int64_t)n * p;
  float* xout = dxdt + row0 * hp + (int64_t)head0 * p;
  const int64_t part = (int64_t)l * n;
  const int64_t nparts = (int64_t)gridDim.z * d.c * gridDim.x;
  float* dBp = parts + (bc * gridDim.x + blockIdx.x) * part;
  float* dCp = dBp + nparts * part;

  // operand tiles: rows t0 .. t0 + 31 of C, B (n wide) or the block's
  // heads' dy, xdt (p wide)
  auto load_n = [&](float* dstt, const float* src, int t0, const float* b0) {
    sb_tile<VEC>(dstt, ldn, src + t0 * gn, gn, l - t0, n, d.nw, b0);
  };
  auto load_p = [&](float* dstt, const float* src, int t0, const float* b0) {
#pragma unroll
    for (int hs = 0; hs < HB; ++hs)
      sb_tile<VEC>(dstt + hs * SB_T * ldp, ldp, src + hs * p + t0 * hp, hp,
                   l - t0, p, d.pw, b0);
  };

  for (int idx = tid; idx < 2 * HB * l; idx += SSD_THREADS) dcum[idx] = 0.0;
  ssd_block_cumsum<HB>(dA, row0, head0, l, d.h, d.lp, cum);

  // ---- for each column tile j: dB_j, dxdt_j, dC, M's sums, the decay
  const int np_units = 2 * (d.pw / SB_T);       // 16 x 32 pieces of a head
  for (int jt = 0; jt < d.lt; ++jt) {
    const int j0 = jt * SB_T;
    load_n(Bs, bbase, j0, B);
    load_p(Xs, xbase, j0, xdt);
    sb_clear(acc1, SB_T * ld1);
    sb_clear(acc2, HB * SB_T * ld2);
    for (int it = jt; it < d.lt; ++it) {
      const int i0 = it * SB_T;
      // C_i (with B_j, X_j at a column's start) in one group, dy_h,i in
      // the next: G runs while dy lands
      load_n(Cs, cbase, i0, C);
      ssd_commit();
      load_p(Ys, ybase, i0, dy);
      ssd_commit();
      ssd_wait<1>();
      __syncthreads();
      {  // G, 16 x 8 pieces of depth n, one a warp
        const int m0 = 16 * (warp & 1), n0 = 8 * (warp >> 1);
        float a[1][4];
        sb_zero(a);
        sb_mm<1, false, true>(a, Cs + m0 * ldn, ldn, Bs + n0 * ldn, ldn,
                              d.nw);
        sb_store(a, Gs + m0 * SB_GW + n0, SB_GW);
      }
      ssd_wait<0>();
      __syncthreads();
      // each head's D, 16 x 16 pieces of depth p
      for (int u = warp; u < 4 * HB; u += SSD_WARPS) {
        const int hs = u >> 2, m0 = 16 * (u & 1), n0 = 16 * ((u >> 1) & 1);
        float a[2][4];
        sb_zero(a);
        sb_mm<2, false, true>(a, Ys + (hs * SB_T + m0) * ldp, ldp,
                              Xs + (hs * SB_T + n0) * ldp, ldp, d.pw);
        sb_store(a, Ds + (hs * SB_T + m0) * SB_GW + n0, SB_GW);
      }
      __syncthreads();
      // L, PG over D, M, and PD = sum_h L_h o D_h in head order
      for (int idx = tid; idx < SB_T * SB_T; idx += SSD_THREADS) {
        const int i = idx >> 5, j = idx & 31, ig = i0 + i, jg = j0 + j;
        const bool ok = ig < l && jg <= ig;
        const float gv = Gs[i * SB_GW + j];
        float pd = 0.0f;
#pragma unroll
        for (int hs = 0; hs < HB; ++hs) {
          const float* ch = cum + hs * d.lp;
          const float L = ok ? expf(ch[ig] - ch[jg]) : 0.0f;
          float* dh = Ds + (hs * SB_T + i) * SB_GW + j;
          const float dv = *dh;
          const float pg = __fmul_rn(L, gv);
          Ms[(hs * SB_T + i) * SB_MW + j] = __fmul_rn(pg, dv);
          *dh = pg;
          pd = hs == 0 ? __fmul_rn(L, dv) : __fadd_rn(pd, __fmul_rn(L, dv));
        }
        Ps[i * SB_GW + j] = pd;
      }
      __syncthreads();
      // M's row sums add to d cum_i; then its column sums take from d cum_j
      // (apart: on the diagonal both touch one entry)
      if (tid < HB * SB_T) {
        const int hs = tid >> 5, r = tid & 31;
        const float* mr = Ms + (hs * SB_T + r) * SB_MW;
        double s = 0.0;
        for (int j = 0; j < SB_T; ++j) s += (double)mr[j];
        if (i0 + r < l) dcum[hs * l + i0 + r] += s;
      }
      __syncthreads();
      if (tid < HB * SB_T) {
        const int hs = tid >> 5, c = tid & 31;
        const float* mc = Ms + hs * SB_T * SB_MW + c;
        double s = 0.0;
        for (int i = 0; i < SB_T; ++i) s += (double)mc[i * SB_MW];
        if (j0 + c < l) dcum[hs * l + j0 + c] -= s;
      }
      // dB_j += PD^T C_i and dC_i += PD B_j (16 x 32 pieces), dxdt_h,j +=
      // PG_h^T dy_h,i; dC_i's running sum is the block's partial in
      // global memory, read and written by the same lanes at every j
      const int n1 = 2 * (d.nw / SB_T);
      for (int u = warp; u < 2 * n1 + HB * np_units; u += SSD_WARPS) {
        float a[4][4];
        if (u < n1) {
          const int m0 = 16 * (u & 1), n0 = SB_T * (u >> 1);
          float* acc = acc1 + m0 * ld1 + n0;
          sb_load(a, acc, ld1);
          sb_mm<4, true, false>(a, Ps + m0, SB_GW, Cs + n0, ldn, SB_T);
          sb_store(a, acc, ld1);
        } else if (u < 2 * n1) {
          const int v = u - n1, m0 = 16 * (v & 1), n0 = SB_T * (v >> 1);
          float* acc = dCp + (int64_t)(i0 + m0) * n + n0;
          const int rows = l - i0 - m0, cols = n - n0;
          if (jt == 0)
            sb_zero(a);
          else
            sb_gload(a, acc, n, rows, cols);
          sb_mm<4, false, false>(a, Ps + m0 * SB_GW, SB_GW, Bs + n0, ldn,
                                 SB_T);
          sb_gstore(a, acc, n, rows, cols);
        } else {
          const int v = u - 2 * n1, hs = v / np_units, w = v % np_units;
          const int m0 = 16 * (w & 1), n0 = SB_T * (w >> 1);
          float* acc = acc2 + (hs * SB_T + m0) * ld2 + n0;
          sb_load(a, acc, ld2);
          sb_mm<4, true, false>(a, Ds + hs * SB_T * SB_GW + m0, SB_GW,
                                Ys + hs * SB_T * ldp + n0, ldp, SB_T);
          sb_store(a, acc, ld2);
        }
      }
      __syncthreads();
    }

    // the decay terms over n in slices of 32: E_h += B_j[:, slice]
    // dstates_h[slice] into Es; dB_j[:, slice] += w_h o (xdt_h,j
    // dstates_h[slice]^T), head after head
    sb_clear(Es, HB * SB_T * ld2);
    for (int ns = 0; ns < d.nw / SB_T; ++ns) {
      const int k0 = ns * SB_T;
#pragma unroll
      for (int hs = 0; hs < HB; ++hs)
        sb_tile<VEC>(Ss + hs * SB_T * ldp, ldp,
                     sbase + (int64_t)hs * n * p + (int64_t)k0 * p, p,
                     n - k0, p, d.pw, dst);
      sb_landed();
      for (int u = warp; u < 8 + HB * np_units; u += SSD_WARPS) {
        if (u < 8) {
          const int m0 = 16 * (u & 1), n0 = 8 * (u >> 1);
          float* acc = acc1 + m0 * ld1 + k0 + n0;
          float a[1][4];
          sb_load(a, acc, ld1);
#pragma unroll 1
          for (int hs = 0; hs < HB; ++hs) {
            float f[1][4];
            sb_zero(f);
            sb_mm<1, false, true>(f, Xs + (hs * SB_T + m0) * ldp, ldp,
                                  Ss + (hs * SB_T + n0) * ldp, ldp, d.pw);
            const float* ch = cum + hs * d.lp;
            const int ja = j0 + m0 + gq, jb = ja + 8;
            const float wa = ja < l ? expf(ch[l - 1] - ch[ja]) : 0.0f;
            const float wb = jb < l ? expf(ch[l - 1] - ch[jb]) : 0.0f;
            a[0][0] = __fadd_rn(a[0][0], __fmul_rn(wa, f[0][0]));
            a[0][1] = __fadd_rn(a[0][1], __fmul_rn(wa, f[0][1]));
            a[0][2] = __fadd_rn(a[0][2], __fmul_rn(wb, f[0][2]));
            a[0][3] = __fadd_rn(a[0][3], __fmul_rn(wb, f[0][3]));
          }
          sb_store(a, acc, ld1);
        } else {
          const int v = u - 8, hs = v / np_units, w = v % np_units;
          const int m0 = 16 * (w & 1), n0 = SB_T * (w >> 1);
          float* acc = Es + (hs * SB_T + m0) * ld2 + n0;
          float a[4][4];
          sb_load(a, acc, ld2);
          sb_mm<4, false, false>(a, Bs + m0 * ldn + k0, ldn,
                                 Ss + hs * SB_T * ldp + n0, ldp, SB_T);
          sb_store(a, acc, ld2);
        }
      }
      __syncthreads();
    }
    // dxdt_h,j += w_h o E_h, and w_j u_j, u_j = xdt_h,j . E_h in f64 (a
    // lane's terms, then the warp's in a fixed tree); a row a warp
    for (int row = warp; row < HB * SB_T; row += SSD_WARPS) {
      const int hs = row >> 5, j = j0 + (row & 31);
      const float* ch = cum + hs * d.lp;
      const float w = j < l ? expf(ch[l - 1] - ch[j]) : 0.0f;
      float* ar = acc2 + row * ld2;
      const float* er = Es + row * ld2;
      const float* xr = Xs + row * ldp;
      double u = 0.0;
      for (int q = lane; q < p; q += 32) {
        ar[q] = __fadd_rn(ar[q], __fmul_rn(w, er[q]));
        u += (double)__fmul_rn(xr[q], er[q]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        u += __shfl_xor_sync(0xffffffffu, u, off);
      if (lane == 0 && j < l) wus[hs * l + j] = (double)w * u;
    }
    __syncthreads();
    for (int row = warp; row < HB * SB_T; row += SSD_WARPS) {
      const int hs = row >> 5, j = j0 + (row & 31);
      if (j < l)
        for (int q = lane; q < p; q += 32)
          xout[(int64_t)j * hp + hs * p + q] = acc2[row * ld2 + q];
    }
    for (int r = warp; r < SB_T; r += SSD_WARPS)
      if (j0 + r < l)
        for (int k = lane; k < n; k += 32)
          dBp[(int64_t)(j0 + r) * n + k] = acc1[r * ld1 + k];
    __syncthreads();
  }

  // ---- d cum and its reverse cumsum, in f64, one thread a head
  if (tid < HB) {
    const double* dc = dcum + tid * l;
    const double* wu = wus + tid * l;
    double total = 0.0;
    for (int j = 0; j < l; ++j) total += wu[j];
    double run = 0.0;
    for (int k = l - 1; k >= 0; --k) {
      run += dc[k] - wu[k] + (k == l - 1 ? total : 0.0);
      ddA[(row0 + k) * d.h + head0 + tid] = (float)run;
    }
  }
}

// dB (or dC) of each group: the sum of its head blocks' partials in block
// order, in f64; `parts` holds nb blocks a (batch, chunk)
__global__ void ssd_chunk_bwd_fold_kernel(const float* __restrict__ parts,
                                          float* __restrict__ dB,
                                          float* __restrict__ dC, int64_t bcs,
                                          int l, int nb, int g, int n) {
  const float* src = parts + (blockIdx.y ? bcs * nb * l * n : 0);
  float* out = blockIdx.y ? dC : dB;
  const int r = nb / g;
  const int64_t total = bcs * l * g * n;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int k = (int)(idx % n);
    int64_t rest = idx / n;
    const int gi = (int)(rest % g);
    rest /= g;
    const int i = (int)(rest % l);
    const int64_t bc = rest / l;
    const float* blk = src + ((bc * nb + (int64_t)gi * r) * l + i) * n + k;
    double s = 0.0;
    for (int hr = 0; hr < r; ++hr) s += (double)blk[(int64_t)hr * l * n];
    out[idx] = (float)s;
  }
}

template <int HB, int VEC>
static int sb_launch(const float* xdt, const float* dA, const float* B,
                     const float* C, const float* dy, const float* dst,
                     int b, const SbDims& d, float* dxdt, float* ddA,
                     float* dB, float* dC, float* scratch,
                     cudaStream_t s) {
  const size_t bytes = sb_smem_bytes(HB, d);
  if (bytes > SSD_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_kernel<HB, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_bwd_kernel<HB, VEC>
      <<<dim3((unsigned)(d.h / HB), (unsigned)d.c, (unsigned)b),
         SSD_THREADS, bytes, s>>>(xdt, dA, B, C, dy, dst, d, dxdt, ddA,
                                  scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t bcs = (int64_t)b * d.c;
  const int64_t blocks = (bcs * d.l * d.g * d.n + 255) / 256;
  ssd_chunk_bwd_fold_kernel<<<dim3((unsigned)(blocks < 4096 ? blocks : 4096),
                                   2), 256, 0, s>>>(scratch, dB, dC, bcs,
                                                    d.l, d.h / HB, d.g, d.n);
  return (int)cudaGetLastError();
}

// dy, dxdt (b,c,l,h,p); dA, ddA (b,c,l,h); B, C, dB, dC (b,c,l,g,n);
// dst (b,c,h,n,p); hb: heads a CTA, 1, 2 or 4, dividing h / g
// (kernels/ssd_chunk/ops.py bwd_heads_per_block chooses it); scratch
// 2 b c (h / hb) l n floats (the head blocks' dB, then dC).
extern "C" int ssd_chunk_bwd_launch(
    const float* xdt, const float* dA, const float* B, const float* C,
    const float* dy, const float* dst, int b, int c, int l, int h, int g,
    int p, int n, int hb, float* dxdt, float* ddA, float* dB, float* dC,
    float* scratch, void* stream) {
  if (b < 1 || c < 1 || l < 1 || h < 1 || g < 1 || h % g != 0 || p < 1 ||
      n < 1 || (hb != 1 && hb != 2 && hb != 4) || (h / g) % hb ||
      c > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  SbDims d;
  d.c = c;
  d.l = l;
  d.h = h;
  d.g = g;
  d.p = p;
  d.n = n;
  d.lt = (l + SB_T - 1) / SB_T;
  d.lp = d.lt * SB_T;
  d.nw = (n + SB_T - 1) / SB_T * SB_T;
  d.pw = (p + SB_T - 1) / SB_T * SB_T;
  d.ldn = d.nw + 4;
  d.ldp = d.pw + 4;
  d.ld1 = d.nw + 8;
  d.ld2 = d.pw + 8;
  // 16-byte copies where every row starts on 16 bytes
  const bool vec = n % 4 == 0 && p % 4 == 0 &&
                   ((uintptr_t)xdt | (uintptr_t)B | (uintptr_t)C |
                    (uintptr_t)dy | (uintptr_t)dst) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
#define SB_CASE(HB_)                                                        \
  if (hb == HB_)                                                            \
    return vec ? sb_launch<HB_, 4>(xdt, dA, B, C, dy, dst, b, d, dxdt, ddA, \
                                   dB, dC, scratch, s)                      \
               : sb_launch<HB_, 1>(xdt, dA, B, C, dy, dst, b, d, dxdt, ddA, \
                                   dB, dC, scratch, s);
  SB_CASE(4)
  SB_CASE(2)
  SB_CASE(1)
#undef SB_CASE
  return (int)cudaErrorInvalidValue;
}
