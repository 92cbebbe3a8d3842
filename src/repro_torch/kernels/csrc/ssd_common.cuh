// Shared pieces of the split-tf32 SSD kernels (ssd_chunk.cu, the forward,
// and ssd_chunk_bwd.cu, its gradient): cp.async tile copies with zero
// fill, the exact three-way tf32 split, mma.sync m16n8k8 and the row of
// six partial products into a fresh accumulator, and the heads' dA_cum
// in torch.cumsum's order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SSD_WARPS 8
#define SSD_THREADS (32 * SSD_WARPS)
#define SSD_MAX_SMEM 232448

__device__ __forceinline__ uint32_t ssd_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int VEC>
__device__ __forceinline__ void ssd_cp(float* dst, const float* src, bool ok);

template <>
__device__ __forceinline__ void ssd_cp<4>(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   ssd_smem(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

template <>
__device__ __forceinline__ void ssd_cp<1>(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   ssd_smem(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void ssd_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void ssd_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A ROWS x COLS tile from rows src_w floats apart into rows dst_w apart;
// rows past rows_ok and columns past cols_ok are zero-filled (``base`` is a
// valid address the skipped copies name).  VEC 4 needs cols_ok % 4 == 0
// and 16-byte aligned rows.
template <int VEC, int ROWS, int COLS>
__device__ __forceinline__ void ssd_tile(float* dst, int dst_w,
                                         const float* src, int64_t src_w,
                                         int rows_ok, int cols_ok,
                                         const float* base) {
  constexpr int per_row = COLS / VEC;
  constexpr int total = ROWS * per_row;
#pragma unroll
  for (int idx0 = 0; idx0 < total; idx0 += SSD_THREADS) {
    const int idx = idx0 + (int)threadIdx.x;
    if (total % SSD_THREADS == 0 || idx < total) {
      const int r = idx / per_row, q = (idx - r * per_row) * VEC;
      const bool ok = r < rows_ok && q < cols_ok;
      ssd_cp<VEC>(dst + r * dst_w + q, ok ? src + r * src_w + q : base, ok);
    }
  }
}

// x = hi + mid + lo exactly: hi = tf32(x), mid = tf32(x - hi), lo = the rest
// (at most 3 significant bits, so a tf32 holds it as it is); inf and NaN
// pass through hi
__device__ __forceinline__ void ssd_split3(float x, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(mid) : "f"(r));
  lo = __float_as_uint(__fsub_rn(r, __uint_as_float(mid)));
}

// d = a @ b (zero accumulator) and d += a @ b, one m16n8k8 tf32 block
__device__ __forceinline__ void ssd_mma0(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

__device__ __forceinline__ void ssd_mma(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[nt] += a @ b[nt] for a row of NT m16n8k8 blocks from the exact splits
// of a and b: the six products from the smallest up into a fresh
// accumulator, then one round-to-nearest add (see the header)
template <int NT>
__device__ __forceinline__ void ssd_row6(float (&acc)[NT][4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&am)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[NT][2],
                                         const uint32_t (&bm)[NT][2],
                                         const uint32_t (&bl)[NT][2]) {
  float t[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) ssd_mma0(t[nt], al, bh[nt]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) ssd_mma(t[nt], ah, bl[nt]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) ssd_mma(t[nt], am, bm[nt]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) ssd_mma(t[nt], am, bh[nt]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) ssd_mma(t[nt], ah, bm[nt]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) ssd_mma(t[nt], ah, bh[nt]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = __fadd_rn(acc[nt][e], t[nt][e]);
}

// dA_cum of the block's heads: the block stages dA, then one thread a head
// adds it up from i = 0, in torch.cumsum's own order (a column of a
// non-innermost dim is scanned sequentially).  Every cum[j] is then the
// rounded prefix that cum[i > j] extends, so the difference cum[i] - cum[j]
// that L and the decay take carries only the rounding of dA[j+1..i].  A
// tree scan would round cum[i] and cum[j] apart: at |dA_cum| ~ 200 (an f32
// ulp of 1.5e-5) that moves exp(cum[i] - cum[j]) by a few 1e-5, two to five
// times the plain version's distance from the f64 answer.  Rows past l
// repeat the last sum (finite; their outputs are never stored).
template <int HB>
__device__ __forceinline__ void ssd_block_cumsum(const float* __restrict__ dA,
                                                 int64_t row0, int head0,
                                                 int l, int h, int lp,
                                                 float* cum) {
  for (int idx = threadIdx.x; idx < HB * l; idx += SSD_THREADS) {
    const int hs = idx / l, i = idx - hs * l;
    cum[hs * lp + i] = dA[(row0 + i) * h + head0 + hs];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0 && warp < HB) {
    float* cs = cum + warp * lp;
    float run = 0.0f;
    int i = 0;
    for (; i + 8 <= l; i += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = cs[i + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        run += v[u];
        cs[i + u] = run;
      }
    }
    for (; i < l; ++i) {
      run += cs[i];
      cs[i] = run;
    }
    for (i = l; i < lp; ++i) cs[i] = run;
  }
  __syncthreads();
}
