// Intra-chunk SSD of Mamba-2 (state-space duality), for each (batch, chunk,
// head) of head-broadcast inputs:
//   dA_cum = cumsum(dA)                                         (l,)
//   L      = exp(dA_cum[i] - dA_cum[j]) for i >= j, else 0      (l, l)
//   y_diag = ((C B^T) o L) @ xdt                                 (l, p)
//   state  = B^T @ (exp(dA_cum[l-1] - dA_cum) * xdt)             (n, p)
// xdt (b,c,l,h,p), dA (b,c,l,h), B and C (b,c,l,h,n), all f32 ->
// y (b,c,l,h,p), states (b,c,h,n,p).  The inter-chunk recurrence and the
// off-diagonal term stay outside, as in the reference.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_chunk/ssd_chunk.py
// (ssd_intra_chunk -> _ssd_kernel).
//
// Bound on the H100: f32 operations.  At mamba2-370m (l 256, h 32, p 64,
// n 128), b 4 and 2048 tokens the useful work (i >= j only) is about 17.2
// GFLOP against 0.44 GB moved: 0.26 ms at 67 TFLOP/s, 0.13 ms at 3.35 TB/s.
//
// Design: one block of SSD_THREADS threads per (b, chunk, head); nothing
// crosses blocks.  The TPU kernel holds the whole (l, l) matrices in VMEM;
// here L and C B^T at l = 256 are 256 KB each in f32, more than a block's
// 227 KB of shared memory, so the block walks SSD_TILE x SSD_TILE tiles:
// for each row tile of C it stages the B and xdt tiles at or left of the
// diagonal, forms the tile of (C B^T) o L in shared memory (exp only where
// i >= j, so a positive difference never overflows) and adds its product
// with xdt to a 4 x 4 register tile per thread.  A second walk over the B
// and decay-scaled xdt tiles gives the chunk state in a 8 x 4 register tile
// per thread.  dA_cum is one thread's sequential scan in shared memory, in
// torch.cumsum's order (see ssd_block_cumsum): the same on every run, no
// atomics.  Plain f32 FMAs, no tensor cores and no TF32.

#include <cuda_runtime.h>
#include <stdint.h>

#define SSD_THREADS 256
#define SSD_TILE 64
#define SSD_MAX_N 128
#define SSD_MAX_P 64
#define SSD_MAX_SMEM 232448

// dA_cum in shared memory: the block stages dA, then one thread adds it up
// from i = 0, in torch.cumsum's own order (a column of a non-innermost
// dim is scanned sequentially).  Every cum[j] is then the rounded prefix
// that cum[i > j] extends, so the difference cum[i] - cum[j] that L and the
// decay take carries only the rounding of dA[j+1..i].  A tree scan would
// round cum[i] and cum[j] apart: at |dA_cum| ~ 200 (an f32 ulp of 1.5e-5)
// that moves exp(cum[i] - cum[j]) by a few 1e-5, two to five times the
// plain version's distance from the f64 answer.  256 dependent adds per
// block: microseconds against the block's products.
__device__ __forceinline__ void ssd_block_cumsum(const float* __restrict__ dA,
                                                 int64_t row0, int h, int l,
                                                 float* cum) {
  for (int i = threadIdx.x; i < l; i += SSD_THREADS)
    cum[i] = dA[(row0 + i) * h];
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.0f;
#pragma unroll 8
    for (int i = 0; i < l; ++i) {
      run += cum[i];
      cum[i] = run;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                 const float* __restrict__ B, const float* __restrict__ C,
                 int c, int l, int h, int p, int n, float* __restrict__ y,
                 float* __restrict__ states) {
  extern __shared__ float smem[];
  const int ns = n + 1;                          // padded row stride of B, C
  float* cum = smem;                             // l
  float* Cs = cum + l;                           // SSD_TILE x ns
  float* Bs = Cs + SSD_TILE * ns;                // SSD_TILE x ns
  float* Xs = Bs + SSD_TILE * ns;                // SSD_TILE x SSD_MAX_P
  float* Gs = Xs + SSD_TILE * SSD_MAX_P;         // SSD_TILE x (SSD_TILE + 1)

  const int hi_ = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int64_t row0 = ((int64_t)bi * c + ci) * l;   // first (b, c, i) row

  ssd_block_cumsum(dA + hi_, row0, h, l, cum);

  // ---- y_diag, one row tile of C at a time
  for (int i0 = 0; i0 < l; i0 += SSD_TILE) {
    for (int idx = tid; idx < SSD_TILE * n; idx += SSD_THREADS) {
      const int r = idx / n, k = idx - r * n, i = i0 + r;
      Cs[r * ns + k] = i < l ? C[((row0 + i) * h + hi_) * n + k] : 0.0f;
    }
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;

    for (int j0 = 0; j0 <= i0; j0 += SSD_TILE) {
      __syncthreads();                 // Cs written; Bs, Xs, Gs free again
      for (int idx = tid; idx < SSD_TILE * n; idx += SSD_THREADS) {
        const int r = idx / n, k = idx - r * n, j = j0 + r;
        Bs[r * ns + k] = j < l ? B[((row0 + j) * h + hi_) * n + k] : 0.0f;
      }
      for (int idx = tid; idx < SSD_TILE * SSD_MAX_P; idx += SSD_THREADS) {
        const int r = idx / SSD_MAX_P, q = idx - r * SSD_MAX_P, j = j0 + r;
        Xs[idx] = (j < l && q < p) ? xdt[((row0 + j) * h + hi_) * p + q]
                                   : 0.0f;
      }
      __syncthreads();
      float g[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) g[r][q] = 0.0f;
      for (int k = 0; k < n; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(tr + 16 * r) * ns + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = Bs[(tc + 16 * q) * ns + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) g[r][q] = fmaf(cv[r], bv[q], g[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + tr + 16 * r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + tc + 16 * q;
          const bool lower = i >= j && i < l && j < l;
          Gs[(tr + 16 * r) * (SSD_TILE + 1) + tc + 16 * q] =
              lower ? g[r][q] * expf(cum[i] - cum[j]) : 0.0f;
        }
      }
      __syncthreads();
      for (int jj = 0; jj < SSD_TILE; ++jj) {
        float gv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          gv[r] = Gs[(tr + 16 * r) * (SSD_TILE + 1) + jj];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = Xs[jj * SSD_MAX_P + tc + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(gv[r], xv[q], acc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + tr + 16 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pp = tc + 16 * q;
        if (i < l && pp < p) y[((row0 + i) * h + hi_) * p + pp] = acc[r][q];
      }
    }
    __syncthreads();                   // Cs is rewritten by the next tile
  }

  // ---- chunk state: B^T @ (exp(dA_cum[l-1] - dA_cum) * xdt)
  const float last = cum[l - 1];
  float sacc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) sacc[r][q] = 0.0f;
  for (int j0 = 0; j0 < l; j0 += SSD_TILE) {
    __syncthreads();
    for (int idx = tid; idx < SSD_TILE * n; idx += SSD_THREADS) {
      const int r = idx / n, k = idx - r * n, j = j0 + r;
      Bs[r * ns + k] = j < l ? B[((row0 + j) * h + hi_) * n + k] : 0.0f;
    }
    for (int idx = tid; idx < SSD_TILE * SSD_MAX_P; idx += SSD_THREADS) {
      const int r = idx / SSD_MAX_P, q = idx - r * SSD_MAX_P, j = j0 + r;
      Xs[idx] = (j < l && q < p)
                    ? xdt[((row0 + j) * h + hi_) * p + q] * expf(last - cum[j])
                    : 0.0f;
    }
    __syncthreads();
    for (int jj = 0; jj < SSD_TILE; ++jj) {
      float bv[8], xv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int k = tr + 16 * r;
        bv[r] = k < n ? Bs[jj * ns + k] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = Xs[jj * SSD_MAX_P + tc + 16 * q];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) sacc[r][q] = fmaf(bv[r], xv[q], sacc[r][q]);
    }
  }
  float* st = states + (((int64_t)bi * c + ci) * h + hi_) * n * p;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int k = tr + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = tc + 16 * q;
      if (k < n && pp < p) st[k * p + pp] = sacc[r][q];
    }
  }
}

extern "C" int ssd_chunk_launch(const float* xdt, const float* dA,
                                const float* B, const float* C, int b, int c,
                                int l, int h, int p, int n, float* y,
                                float* states, void* stream) {
  if (b < 1 || c < 1 || l < 1 || h < 1 || p < 1 || n < 1 ||
      p > SSD_MAX_P || n > SSD_MAX_N || c > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)l + 2 * SSD_TILE * (n + 1) +
                        SSD_TILE * SSD_MAX_P + SSD_TILE * (SSD_TILE + 1);
  const size_t bytes = floats * sizeof(float);
  if (bytes > SSD_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)h, (unsigned)c, (unsigned)b);
  ssd_chunk_kernel<<<grid, SSD_THREADS, bytes, (cudaStream_t)stream>>>(
      xdt, dA, B, C, c, l, h, p, n, y, states);
  return (int)cudaGetLastError();
}
