// Shared pieces of local_attn's split-tf32 kernels (local_attn_tf32.cu, the
// forward, and local_attn_bwd_tf32.cu, its gradient): the tiles' shapes and
// row padding, cp.async copies of row tiles with zero fill, the two-part
// tf32 split, mma.sync m16n8k8 rows of partial products into a fresh
// accumulator, the products of a warp's 16 rows from shared memory, the E
// tile of P (or dS) in the accumulator layout, and the mask.
//
// Products.  Every product runs on mma.sync m16n8k8 tf32 with f32
// accumulation over a split of both operands done as a fragment is loaded
// from shared memory: LT_PARTS 2 takes hi = tf32(x) and lo = x - hi (read
// by the tensor core cut to tf32) and three partial products (lo hi, hi
// lo, hi hi); LT_PARTS 3 the exact three-way split (hi, mid = tf32(x - hi),
// lo the rest) and six (lo hi, hi lo, mid mid, mid hi, hi mid, hi hi).
// Each k-step of 8 takes its partial products into a fresh accumulator,
// then one round-to-nearest add into the running sum (ssd_common.cuh's
// scheme).  bf16 inputs are exact in a tf32 hi part.
//
// Rows of D + 4 floats (D + 8 bf16) are 4 banks apart, so the fragment
// loads that walk a row (A, and B of S = X Y^T) hit 32 banks; the B loads
// of the output products (walking down the rows) are 2-way.

#pragma once

#include <cuda_bf16.h>

#include "ssd_common.cuh"

#define LT_BM 64       // kept rows of a CTA: 4 row groups of 16
#define LT_PARTS 2     // the split: 2 parts, three products (3: six)

template <typename T>
struct LtPad {
  static constexpr int v = 4;     // f32: rows D + 4 floats apart
};
template <>
struct LtPad<__nv_bfloat16> {
  static constexpr int v = 8;     // bf16: D + 8 (16-byte rows)
};

template <int D>
struct LtShape {
  static constexpr int BN = D == 256 ? 32 : 64;     // streamed tile rows
  static constexpr int EW = BN + 4;                  // row stride of P / dS
  static constexpr int NC = 8;     // n-tiles of an output product at once
};

__device__ __forceinline__ float lt_f(float x) { return x; }
__device__ __forceinline__ float lt_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void lt_put(float* p, float x) { *p = x; }
__device__ __forceinline__ void lt_put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void lt_cp16(void* dst, const void* src,
                                        bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   ssd_smem(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// rows r0 .. r0 + ROWS - 1 of a (rows_total, D) slice whose rows are
// `stride` elements apart (16-byte aligned) into a tile of row stride D +
// pad, by the CTA's THREADS threads; rows past rows_total zero-filled
template <int ROWS, int D, int THREADS, typename T>
__device__ __forceinline__ void lt_tile(T* dst, const T* __restrict__ src,
                                        int r0, int rows_total,
                                        int64_t stride = D) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int PER_ROW = D / V;
  constexpr int N = ROWS * PER_ROW;
  constexpr int LD = D + LtPad<T>::v;
  for (int idx = threadIdx.x; idx < N; idx += THREADS) {
    const int r = idx / PER_ROW, c = (idx - r * PER_ROW) * V;
    const bool ok = r0 + r < rows_total;
    lt_cp16(dst + r * LD + c, ok ? src + (int64_t)(r0 + r) * stride + c : src,
            ok);
  }
}

// round to tf32 in integer arithmetic: (bits + 0x1000) & ~0x1fff is
// cvt.rna.tf32.f32 for every finite x (ssd_chunk_bwd.cu's sb_tf32)
__device__ __forceinline__ uint32_t lt_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// the parts of x a product multiplies: hi = tf32(x), then mid = tf32(x -
// hi) and lo the rest (PARTS 3, exact), or lo = x - hi as it is (PARTS 2):
// the tensor core reads a tf32 operand's top 19 bits, so lo enters cut
// to tf32 toward zero, and its sign follows the rounding of hi, not x's
// (rounding lo as well took 6 % longer at gemma-2b's shape; cutting hi too
// moved dq from 0.55 to 1.70 times the plain VJP's distance to f64, the
// cuts all toward zero: tools/attn_bwd_variants.py)
template <int PARTS>
__device__ __forceinline__ void lt_split(float x, uint32_t (&p)[PARTS]) {
  p[0] = lt_tf32(x);
  const float r = __fsub_rn(x, __uint_as_float(p[0]));
  if constexpr (PARTS == 3) {
    p[1] = lt_tf32(r);
    p[2] = __float_as_uint(__fsub_rn(r, __uint_as_float(p[1])));
  } else {
    p[1] = __float_as_uint(r);
  }
}

// t[nt] (=, or +=) a[IA] @ b[nt][IB] for a row of NT m16n8k8 blocks
template <int IA, int IB, bool FIRST, int NT, int PARTS>
__device__ __forceinline__ void lt_step(float (&t)[NT][4],
                                        const uint32_t (&a)[PARTS][4],
                                        const uint32_t (&b)[NT][PARTS][2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (FIRST)
      ssd_mma0(t[nt], a[IA], b[nt][IB]);
    else
      ssd_mma(t[nt], a[IA], b[nt][IB]);
  }
}

// acc[nt] += a @ b[nt] for a row of NT m16n8k8 blocks: the partial
// products from the smallest up into a fresh accumulator, then one
// round-to-nearest add
template <int NT, int PARTS>
__device__ __forceinline__ void lt_row(float (&acc)[NT][4],
                                       const uint32_t (&a)[PARTS][4],
                                       const uint32_t (&b)[NT][PARTS][2]) {
  float t[NT][4];
  if constexpr (PARTS == 3) {   // lo hi, hi lo, mid mid, mid hi, hi mid, hi hi
    lt_step<2, 0, true>(t, a, b);
    lt_step<0, 2, false>(t, a, b);
    lt_step<1, 1, false>(t, a, b);
    lt_step<1, 0, false>(t, a, b);
    lt_step<0, 1, false>(t, a, b);
    lt_step<0, 0, false>(t, a, b);
  } else {                      // lo hi, hi lo, hi hi
    lt_step<1, 0, true>(t, a, b);
    lt_step<0, 1, false>(t, a, b);
    lt_step<0, 0, false>(t, a, b);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = __fadd_rn(acc[nt][e], t[nt][e]);
}

// acc (a warp's 16 x 8NT) += A (16 x 8KS) B (8KS x 8NT) from shared memory:
// A(r, k) = A[r LDA + k]; B(k, n) = TB ? Bm[n LDB + k] : Bm[k LDB + n]
template <int NT, int KS, bool TB, int PARTS, int LDA, int LDB, typename TA,
          typename TBe>
__device__ __forceinline__ void lt_mm(float (&acc)[NT][4],
                                      const TA* __restrict__ A,
                                      const TBe* __restrict__ Bm) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll 2
  for (int ks = 0; ks < KS; ++ks) {
    const int ka = 8 * ks + tq;
    uint32_t a[PARTS][4], b[NT][PARTS][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t p[PARTS];
      lt_split<PARTS>(lt_f(A[(gq + 8 * (e & 1)) * LDA + ka + 4 * (e >> 1)]),
                      p);
#pragma unroll
      for (int i = 0; i < PARTS; ++i) a[i][e] = p[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = 8 * nt + gq;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = ka + 4 * e;
        uint32_t p[PARTS];
        lt_split<PARTS>(lt_f(TB ? Bm[n * LDB + k] : Bm[k * LDB + n]), p);
#pragma unroll
        for (int i = 0; i < PARTS; ++i) b[nt][i][e] = p[i];
      }
    }
    lt_row<NT, PARTS>(acc, a, b);
  }
}

// acc (16 x COLS) += E (the row group's 16 x BN rows of P or dS) Y (BN x
// COLS, from the column a streamed tile's pointer is at), NC n-tiles at a
// time
template <int D, int COLS, typename T>
__device__ __forceinline__ void lt_out(float (&acc)[COLS / 8][4],
                                       const float* E, const T* Y) {
  using Sh = LtShape<D>;
  constexpr int NO = COLS / 8;
  constexpr int NC = Sh::NC < NO ? Sh::NC : NO;
  constexpr int LD = D + LtPad<T>::v;
#pragma unroll
  for (int c = 0; c < NO / NC; ++c) {
    float part[NC][4];
#pragma unroll
    for (int nt = 0; nt < NC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nt][e] = acc[c * NC + nt][e];
    lt_mm<NC, Sh::BN / 8, false, LT_PARTS, Sh::EW, LD>(part, E,
                                                       Y + 8 * NC * c);
#pragma unroll
    for (int nt = 0; nt < NC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c * NC + nt][e] = part[nt][e];
  }
}

// the warp's 16 x 8NT accumulator tile into E (at its first row)
template <int NT>
__device__ __forceinline__ void lt_store_e(float* E, int ew,
                                           const float (&x)[NT][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float* p = E + gq * ew + 8 * nt + 2 * tq;
    *reinterpret_cast<float2*>(p) = make_float2(x[nt][0], x[nt][1]);
    *reinterpret_cast<float2*>(p + 8 * ew) = make_float2(x[nt][2], x[nt][3]);
  }
}

// the same positions of E read back in the accumulator layout
template <int NT>
__device__ __forceinline__ void lt_load_e(float (&x)[NT][4], const float* E,
                                          int ew) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float* p = E + gq * ew + 8 * nt + 2 * tq;
    const float2 lo = *reinterpret_cast<const float2*>(p);
    const float2 hi = *reinterpret_cast<const float2*>(p + 8 * ew);
    x[nt][0] = lo.x;
    x[nt][1] = lo.y;
    x[nt][2] = hi.x;
    x[nt][3] = hi.y;
  }
}

__device__ __forceinline__ bool lt_allowed(int s, int t, int S, int T,
                                           int causal, int window) {
  bool ok = s < S && t < T;
  if (causal) ok = ok && t <= s;
  if (window) ok = ok && t > s - window;
  return ok;
}
