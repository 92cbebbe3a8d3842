// Intra-chunk SSD of Mamba-2 (state-space duality), for each (batch, chunk,
// head), with B and C shared by the heads of a group:
//   dA_cum = cumsum(dA)                                         (l,)
//   L      = exp(dA_cum[i] - dA_cum[j]) for i >= j, else 0      (l, l)
//   y_diag = ((C B^T) o L) @ xdt                                 (l, p)
//   state  = B^T @ (exp(dA_cum[l-1] - dA_cum) * xdt)             (n, p)
// xdt (b,c,l,h,p), dA (b,c,l,h), B and C (b,c,l,g,n), all f32; head hi
// reads group hi / (h / g) -> y (b,c,l,h,p), states (b,c,h,n,p).  The
// inter-chunk recurrence and the off-diagonal term stay outside, as in the
// reference.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_chunk/ssd_chunk.py
// (ssd_intra_chunk -> _ssd_kernel), which takes B and C repeated per head.
//
// Bound on the H100: f32 operations.  At mamba2-370m (l 256, h 32, p 64,
// n 128, one group), b 4 and 2048 tokens the useful work (i >= j only) is
// C B^T once per group and the other two products once per head: about
// 8.9 GFLOP against 0.18 GB moved, 0.133 ms at 67 TFLOP/s, 0.053 ms at
// 3.35 TB/s.  (The per-head copies of B and C that the reference's wrapper
// makes would be 17.2 GFLOP and 0.44 GB: 0.258 ms.)
//
// Design.  One CTA of 8 warps per (batch, chunk, block of HB heads of one
// group; ops.heads_per_block picks HB); nothing crosses CTAs.  The TPU
// kernel holds the whole (l, l) matrices in VMEM; here the CTA walks 64 x 64
// tiles of them:
//   y phase:  for each 64-column tile of p, each row tile i of C and each
//             column tile j <= i, G = C_i B_j^T is formed once (n in slices
//             of 64) into shared memory and applied to every head of the
//             block: y_h[i] += (G o L_h[i, j]) @ xdt_h[j] (j in slices of 32).
//   state phase: for each 64-row slice of n and 64-column tile of p,
//             state_h += B_j^T @ (decay_h[j] * xdt_h[j]) over j in slices of
//             32.
// The products run on the tensor cores (mma.sync m16n8k8 tf32) on operands
// split exactly: a = hi + mid + lo with hi = tf32(a), mid = tf32(a - hi) and
// lo the remaining 3 bits, and a b = the six partial products down to
// 2^-22 of a b (the three below, ~2^-33, are dropped).  3xTF32 (a = hi + lo,
// three products) keeps 22 of f32's 24 bits: at chunk lengths of 8 its
// state product sat 2.8x the plain f32 version's distance from the f64
// answer, where the repo holds the kernel to 2x (the card test
// test_ssd_kernel_refuses_states_it_cannot_hold); with the exact split it
// sits within 1.2x at tools/ssd_f64_witness.py's shapes.  The six products
// of one k-step of 8 go into a fresh accumulator that is then added to the
// running sum in f32 round-to-nearest: the tensor core's own truncating
// adds then span one k-step, not the whole depth (accumulated in place,
// y lost the witness at short chunks).  The NT output blocks of a warp are
// independent chains issued side by side.  mma.sync and not
// wgmma: wgmma takes tf32 only K-major, and two of the three products
// (P @ xdt and B^T @ xdt) run their depth down l, across the rows of the
// tiles as they lie in memory; mma.sync's fragments are loaded by each
// thread from shared memory in any layout (row strides padded so the loads
// hit 32 distinct banks).  The mask i >= j, the exp of dA_cum[i] - dA_cum[j]
// (only where i >= j, so a positive difference never overflows), the decay
// and the splits run on the CUDA cores; they, not the tensor cores, bound
// the kernel.  dA_cum is one thread's sequential scan per head in
// torch.cumsum's order (see ssd_block_cumsum).  Tiles come by cp.async into
// a 3-stage ring: one step's loads (C and B slices, or the block's xdt
// slices, or a B slice with them) fly while the step before multiplies.
// Any l, n and p: rows and columns past the edge are zero-filled by the
// copies and masked on the way out.

#include "ssd_common.cuh"

#define SSD_T 64          // l rows and columns of a tile; n, p of an output
#define SSD_NS 64         // depth of n a G step
#define SSD_JS 32         // depth of l an xdt or state step
#define SSD_XS (SSD_T / SSD_JS)
#define SSD_STAGES 3
#define SSD_CW (SSD_NS + 4)  // row stride of the C and B slices of a G step
#define SSD_XW 72         // row stride of the xdt, B slices of l-deep steps
#define SSD_GW 68         // row stride of G

template <int HB>
struct SsdShape {
  static constexpr int kG = 2 * SSD_T * SSD_CW;             // C, B slices
  static constexpr int kS = (1 + HB) * SSD_JS * SSD_XW;     // B, HB xdt slices
  static constexpr int stage = kG > kS ? kG : kS;           // floats a stage
  static constexpr int W = SSD_WARPS / HB;  // warps a head: 2 halves x W/2
  static constexpr int NT = 16 / W;         // n8 tiles of a warp's columns
};

struct SsdDims {
  int c, l, h, g, p, n;
  int lt, lp;     // tiles of l, and l padded to them
  int nsl;        // slices of n a G
  int ptn, ntn;   // 64-wide tiles of p and of n
};

enum { SSD_G = 0, SSD_X = 1, SSD_S = 2, SSD_DONE = 3 };

// One step of the CTA's walk; the producer's copy runs STAGES - 1 ahead.
struct SsdStep {
  int kind, pt, it, jt, s, ns;
};

__device__ __forceinline__ void ssd_next(SsdStep& st, const SsdDims& d) {
  if (st.kind == SSD_G) {
    if (++st.s < d.nsl) return;
    st.kind = SSD_X;
    st.s = 0;
  } else if (st.kind == SSD_X) {
    if (++st.s < SSD_XS) return;
    st.s = 0;
    st.kind = SSD_G;
    if (++st.jt <= st.it) return;
    st.jt = 0;
    if (++st.it < d.lt) return;
    st.it = 0;
    if (++st.pt < d.ptn) return;
    st.pt = 0;
    st.kind = SSD_S;
  } else if (st.kind == SSD_S) {
    if (++st.s < SSD_XS) return;
    st.s = 0;
    if (++st.jt < d.lt) return;
    st.jt = 0;
    if (++st.pt < d.ptn) return;
    st.pt = 0;
    if (++st.ns < d.ntn) return;
    st.kind = SSD_DONE;
  }
}

template <int HB, int VEC>
__global__ void __launch_bounds__(SSD_THREADS, 1)
ssd_chunk_tf32_kernel(const float* __restrict__ xdt,
                      const float* __restrict__ dA,
                      const float* __restrict__ B,
                      const float* __restrict__ C, const SsdDims d,
                      float* __restrict__ y, float* __restrict__ states) {
  using S = SsdShape<HB>;
  constexpr int NT = S::NT;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                   // STAGES x stage
  float* Gs = ring + SSD_STAGES * S::stage;             // 64 x SSD_GW
  float* cum = Gs + SSD_T * SSD_GW;                     // HB x lp

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;             // mma fragment coords
  const int head0 = blockIdx.x * HB;
  const int gi = head0 / (d.h / d.g);
  const int ci = blockIdx.y, bi = blockIdx.z;
  const int64_t row0 = ((int64_t)bi * d.c + ci) * d.l;  // first (b, c, i) row
  const int64_t gn = (int64_t)d.g * d.n, hp = (int64_t)d.h * d.p;
  const float* cbase = C + (row0 * d.g + gi) * d.n;
  const float* bbase = B + (row0 * d.g + gi) * d.n;
  const float* xbase = xdt + (row0 * d.h + head0) * d.p;   // head hs: + hs*p

  // the copies of one step into ring buffer ``buf``
  auto issue = [&](const SsdStep& st, float* buf) {
    if (st.kind == SSD_G) {
      ssd_tile<VEC, SSD_T, SSD_NS>(buf, SSD_CW,
                                   cbase + st.it * SSD_T * gn + st.s * SSD_NS,
                                   gn, d.l - st.it * SSD_T,
                                   d.n - st.s * SSD_NS, C);
      ssd_tile<VEC, SSD_T, SSD_NS>(buf + SSD_T * SSD_CW, SSD_CW,
                                   bbase + st.jt * SSD_T * gn + st.s * SSD_NS,
                                   gn, d.l - st.jt * SSD_T,
                                   d.n - st.s * SSD_NS, B);
      return;
    }
    const int j0 = st.jt * SSD_T + st.s * SSD_JS;
    float* xs = buf;
    if (st.kind == SSD_S) {
      ssd_tile<VEC, SSD_JS, SSD_T>(buf, SSD_XW,
                                   bbase + j0 * gn + st.ns * SSD_T, gn,
                                   d.l - j0, d.n - st.ns * SSD_T, B);
      xs += SSD_JS * SSD_XW;
    }
#pragma unroll
    for (int hs = 0; hs < HB; ++hs)
      ssd_tile<VEC, SSD_JS, SSD_T>(xs + hs * SSD_JS * SSD_XW, SSD_XW,
                                   xbase + hs * d.p + j0 * hp + st.pt * SSD_T,
                                   hp, d.l - j0, d.p - st.pt * SSD_T, xdt);
  };

  SsdStep prod = {SSD_G, 0, 0, 0, 0, 0};
#pragma unroll
  for (int s = 0; s < SSD_STAGES - 1; ++s) {
    if (prod.kind != SSD_DONE) {
      issue(prod, ring + s * S::stage);
      ssd_next(prod, d);
    }
    ssd_commit();
  }
  ssd_block_cumsum<HB>(dA, row0, head0, d.l, d.h, d.lp, cum);

  // warp roles: G steps split the 64 x 64 G into 16 x 32 pieces; the l-deep
  // steps give each head W warps, a 32-row half and a column piece each
  const int gm0 = (warp & 3) * 16, gn0 = (warp >> 2) * 32;
  const int hs = warp / S::W, wr = warp % S::W;
  const int rh = (wr & 1) * 32, cp0 = (wr >> 1) * NT * 8;
  const float* ch = cum + hs * d.lp;

  float gacc[4][4];
  float acc[2][NT][4];      // y tile in the y phase, state tile after
  SsdStep st = {SSD_G, 0, 0, 0, 0, 0};
  int stage = 0;
  while (st.kind != SSD_DONE) {
    ssd_wait<SSD_STAGES - 2>();
    __syncthreads();        // this step's tiles landed; the last one's are free
    if (prod.kind != SSD_DONE) {
      const int nb = stage == 0 ? SSD_STAGES - 1 : stage - 1;
      issue(prod, ring + nb * S::stage);
      ssd_next(prod, d);
    }
    ssd_commit();
    const float* buf = ring + stage * S::stage;

    if (st.kind == SSD_G) {
      // ---- G(it, jt) += C slice @ B slice^T
      if (st.s == 0) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[nt][e] = 0.0f;
      }
      const float* Cs = buf;
      const float* Bs = buf + SSD_T * SSD_CW;
#pragma unroll
      for (int kk = 0; kk < SSD_NS / 8; ++kk) {
        const int k = kk * 8 + tq;
        uint32_t ah[4], am[4], al[4], bh[4][2], bm[4][2], bl[4][2];
        ssd_split3(Cs[(gm0 + gq) * SSD_CW + k], ah[0], am[0], al[0]);
        ssd_split3(Cs[(gm0 + gq + 8) * SSD_CW + k], ah[1], am[1], al[1]);
        ssd_split3(Cs[(gm0 + gq) * SSD_CW + k + 4], ah[2], am[2], al[2]);
        ssd_split3(Cs[(gm0 + gq + 8) * SSD_CW + k + 4], ah[3], am[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* br = Bs + (gn0 + nt * 8 + gq) * SSD_CW + k;
          ssd_split3(br[0], bh[nt][0], bm[nt][0], bl[nt][0]);
          ssd_split3(br[4], bh[nt][1], bm[nt][1], bl[nt][1]);
        }
        ssd_row6<4>(gacc, ah, am, al, bh, bm, bl);
      }
      if (st.s == d.nsl - 1) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float* gr = Gs + (gm0 + gq) * SSD_GW + gn0 + nt * 8 + 2 * tq;
          gr[0] = gacc[nt][0];
          gr[1] = gacc[nt][1];
          gr[8 * SSD_GW] = gacc[nt][2];
          gr[8 * SSD_GW + 1] = gacc[nt][3];
        }
      }
    } else if (st.kind == SSD_X) {
      // ---- y_h[it] += (G o L_h) [:, j slice] @ xdt_h[j slice]
      if (st.jt == 0 && st.s == 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
      }
      const bool diag = st.jt == st.it;
      const int ib = st.it * SSD_T;
      const float* xs = buf + hs * SSD_JS * SSD_XW;
      float cir[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          cir[mt][hf] = ch[ib + rh + mt * 16 + hf * 8 + gq];
#pragma unroll
      for (int kk = 0; kk < SSD_JS / 8; ++kk) {
        const int jk = st.s * SSD_JS + kk * 8;   // first G column of the k-step
        if (diag && jk > rh + 31) continue;          // all j > i for this warp
        const int jl = jk + tq;
        const int j = st.jt * SSD_T + jl;
        const float cj[2] = {ch[j], ch[j + 4]};
        uint32_t ah[2][4], am[2][4], al[2][4];
        uint32_t bh[NT][2], bm[NT][2], bl[NT][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int r = rh + mt * 16 + hf * 8 + gq;
              const int i = ib + r, jj = j + kh * 4;
              const float v =
                  (i >= jj && jj < d.l)
                      ? __fmul_rn(Gs[r * SSD_GW + jl + kh * 4],
                                  expf(cir[mt][hf] - cj[kh]))
                      : 0.0f;
              const int e = hf + 2 * kh;
              ssd_split3(v, ah[mt][e], am[mt][e], al[mt][e]);
            }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* xr = xs + (kk * 8 + tq) * SSD_XW + cp0 + nt * 8 + gq;
          ssd_split3(xr[0], bh[nt][0], bm[nt][0], bl[nt][0]);
          ssd_split3(xr[4 * SSD_XW], bh[nt][1], bm[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ssd_row6<NT>(acc[mt], ah[mt], am[mt], al[mt], bh, bm, bl);
      }
      if (diag && st.s == SSD_XS - 1) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = ib + rh + mt * 16 + hf * 8 + gq;
            if (i >= d.l) continue;
            float* yr = y + ((row0 + i) * d.h + head0 + hs) * d.p;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int q = st.pt * SSD_T + cp0 + nt * 8 + 2 * tq;
              if (q < d.p) yr[q] = acc[mt][nt][2 * hf];
              if (q + 1 < d.p) yr[q + 1] = acc[mt][nt][2 * hf + 1];
            }
          }
      }
    } else {
      // ---- state_h[ns, pt] += B[j slice, ns]^T @ (decay_h * xdt_h)[j slice]
      if (st.jt == 0 && st.s == 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
      }
      const int j0 = st.jt * SSD_T + st.s * SSD_JS;
      if (j0 < d.l) {
        const float last = ch[d.l - 1];
        const float* bt = buf;
        const float* xs = buf + (1 + hs) * SSD_JS * SSD_XW;
#pragma unroll
        for (int kk = 0; kk < SSD_JS / 8; ++kk) {
          const int jl = kk * 8 + tq, j = j0 + jl;
          const float dec0 = j < d.l ? expf(last - ch[j]) : 0.0f;
          const float dec1 = j + 4 < d.l ? expf(last - ch[j + 4]) : 0.0f;
          uint32_t ah[2][4], am[2][4], al[2][4];
        uint32_t bh[NT][2], bm[NT][2], bl[NT][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float* br = bt + jl * SSD_XW + rh + mt * 16 + gq;
            ssd_split3(br[0], ah[mt][0], am[mt][0], al[mt][0]);
            ssd_split3(br[8], ah[mt][1], am[mt][1], al[mt][1]);
            ssd_split3(br[4 * SSD_XW], ah[mt][2], am[mt][2], al[mt][2]);
            ssd_split3(br[4 * SSD_XW + 8], ah[mt][3], am[mt][3], al[mt][3]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float* xr = xs + jl * SSD_XW + cp0 + nt * 8 + gq;
            ssd_split3(__fmul_rn(xr[0], dec0), bh[nt][0], bm[nt][0],
                       bl[nt][0]);
            ssd_split3(__fmul_rn(xr[4 * SSD_XW], dec1), bh[nt][1], bm[nt][1],
                       bl[nt][1]);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ssd_row6<NT>(acc[mt], ah[mt], am[mt], al[mt], bh, bm, bl);
        }
      }
      if (st.jt == d.lt - 1 && st.s == SSD_XS - 1) {
        float* sb = states + (((int64_t)bi * d.c + ci) * d.h + head0 + hs) *
                                 (int64_t)d.n * d.p;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int k = st.ns * SSD_T + rh + mt * 16 + hf * 8 + gq;
            if (k >= d.n) continue;
            float* sr = sb + (int64_t)k * d.p;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int q = st.pt * SSD_T + cp0 + nt * 8 + 2 * tq;
              if (q < d.p) sr[q] = acc[mt][nt][2 * hf];
              if (q + 1 < d.p) sr[q + 1] = acc[mt][nt][2 * hf + 1];
            }
          }
      }
    }
    ssd_next(st, d);
    stage = stage + 1 == SSD_STAGES ? 0 : stage + 1;
  }
  ssd_wait<0>();
}

template <int HB, int VEC>
static int ssd_launch(const float* xdt, const float* dA, const float* B,
                      const float* C, int b, const SsdDims& d, float* y,
                      float* states, cudaStream_t stream) {
  using S = SsdShape<HB>;
  const size_t bytes =
      ((size_t)SSD_STAGES * S::stage + SSD_T * SSD_GW + (size_t)HB * d.lp) *
      sizeof(float);
  if (bytes > SSD_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_tf32_kernel<HB, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(d.h / HB), (unsigned)d.c, (unsigned)b);
  ssd_chunk_tf32_kernel<HB, VEC><<<grid, SSD_THREADS, bytes, stream>>>(
      xdt, dA, B, C, d, y, states);
  return (int)cudaGetLastError();
}

// hb: heads a CTA, 1, 2 or 4, dividing h / g (kernels/ssd_chunk/ops.py
// heads_per_block chooses it).
extern "C" int ssd_chunk_launch(const float* xdt, const float* dA,
                                const float* B, const float* C, int b, int c,
                                int l, int h, int g, int p, int n, int hb,
                                float* y, float* states, void* stream) {
  if (b < 1 || c < 1 || l < 1 || h < 1 || g < 1 || p < 1 || n < 1 ||
      h % g || (hb != 1 && hb != 2 && hb != 4) || (h / g) % hb ||
      c > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  SsdDims d;
  d.c = c;
  d.l = l;
  d.h = h;
  d.g = g;
  d.p = p;
  d.n = n;
  d.lt = (l + SSD_T - 1) / SSD_T;
  d.lp = d.lt * SSD_T;
  d.nsl = (n + SSD_NS - 1) / SSD_NS;
  d.ptn = (p + SSD_T - 1) / SSD_T;
  d.ntn = (n + SSD_T - 1) / SSD_T;
  // 16-byte copies where every row starts on 16 bytes
  const bool vec = n % 4 == 0 && p % 4 == 0 &&
                   ((uintptr_t)xdt | (uintptr_t)B | (uintptr_t)C) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
#define SSD_CASE(HB_)                                                      \
  if (hb == HB_)                                                           \
    return vec ? ssd_launch<HB_, 4>(xdt, dA, B, C, b, d, y, states, s)     \
               : ssd_launch<HB_, 1>(xdt, dA, B, C, b, d, y, states, s);
  SSD_CASE(4)
  SSD_CASE(2)
  SSD_CASE(1)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}
