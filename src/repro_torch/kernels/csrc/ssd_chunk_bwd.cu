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
// 0.26 ms at 67 TFLOP/s.  This kernel recomputes G and D in both phases
// and G for every head (about 31 GFLOP).
//
// Design (a first kernel, right before fast: CUDA cores, f32 products).
// Kernel 1, ssd_chunk_bwd_kernel: one CTA of 256 threads per (batch, chunk,
// head); nothing crosses CTAs but each head's dB and dC, which go to a
// scratch of per-head partials.  The CTA walks 32 x 32 tiles of the (l, l)
// matrices twice:
//   rows phase: for each row tile i and column tile j <= i, G and D are
//     formed in shared memory (the n and p products), L, L G and L D and
//     M = L G D elementwise; dC_i accumulates (L D) B_j, and M's row and
//     column sums go into f64 sums per position;
//   columns phase: for each column tile j and row tile i >= j, G and D
//     again; dB_j accumulates (L D)^T C_i and dxdt_j (L G)^T dy_i; then the
//     decay terms w (B_j . dstates) and w (dstates xdt_j), and w_j u_j.
// Then one thread forms d cum in f64 and its reverse cumsum.  A product of
// depth K accumulates in f32 registers in order, then adds into its
// accumulator in shared memory, tile after tile (a blocked sum, as a GEMM
// takes it).  Thread (ty, tx) of 8 x 32 owns rows ty + 8r of a tile and
// columns tx + 32c, so a warp reads one row of the left operand (a
// broadcast) and 32 neighbouring columns of the right one; row strides of
// tiles read across rows are odd, so those reads hit 32 banks.  cum is one
// thread's sequential scan, the forward kernel's order; L is exp of the
// difference only where i >= j (never overflows).
// Kernel 2, ssd_chunk_bwd_fold_kernel: dB and dC of each group, the sum of
// its heads' partials in head order, in f64 (ordered partials, no atomics).

#include <cuda_runtime.h>
#include <stdint.h>

#define SSDB_T 32
#define SSDB_TW 33        // row stride of the 32 x 32 tiles
#define SSDB_THREADS 256
#define SSDB_MAX_SMEM 232448

struct SsdbDims {
  int c, l, h, g, p, n, lt;
  int ldn, ldp;   // odd row strides of the n- and p-wide tiles
};

__host__ __device__ __forceinline__ int ssdb_odd(int x) { return x | 1; }

// out[r][c] = (add ? out[r][c] : 0) + sum_k A(r, k) B(k, c), r < 32,
// c < N; A(r, k) = TA ? A[k * lda + r] : A[r * lda + k];
// B(k, c) = TB ? Bm[c * ldb + k] : Bm[k * ldb + c].  Thread (ty, tx) owns
// rows ty + 8i (i < 4) and columns c0 + tx + 32j (j < NR) of each chunk of
// 32 NR columns; each dot product runs down k in order.
template <int NR, bool TA, bool TB>
__device__ __forceinline__ void ssdb_mm(float* out, int ldo, bool add,
                                        const float* A, int lda,
                                        const float* Bm, int ldb, int N,
                                        int K) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int c0 = 0; c0 < N; c0 += 32 * NR) {
    float acc[4][NR];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NR; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      float a[4], b[NR];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 8 * i;
        a[i] = TA ? A[k * lda + r] : A[r * lda + k];
      }
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int c = c0 + tx + 32 * j;
        b[j] = c < N ? (TB ? Bm[c * ldb + k] : Bm[k * ldb + c]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c < N) {
          float* o = out + (ty + 8 * i) * ldo + c;
          *o = add ? *o + acc[i][j] : acc[i][j];
        }
      }
  }
}

// rows t0 .. t0 + 31 of a (.., l, .., width) tensor slice whose rows are
// `stride` floats apart, into a 32 x ld tile; rows past l read as zeros.
// Eight loads a thread are issued before any is stored, so they are in
// flight together (any width and alignment; one at a time, the kernel
// took 3.73 ms at mamba2's training shape on an H100, 3.57 ms so).
__device__ __forceinline__ void ssdb_load(float* tile, int ld,
                                          const float* __restrict__ src,
                                          int64_t stride, int t0, int l,
                                          int width) {
  const int total = SSDB_T * width;
  for (int base = threadIdx.x; base < total; base += 8 * SSDB_THREADS) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + u * SSDB_THREADS;
      const int r = idx / width, k = idx - r * width;
      v[u] = (idx < total && t0 + r < l)
                 ? src[(int64_t)(t0 + r) * stride + k]
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + u * SSDB_THREADS;
      const int r = idx / width, k = idx - r * width;
      if (idx < total) tile[r * ld + k] = v[u];
    }
  }
}

__device__ __forceinline__ void ssdb_zero(float* p, int n) {
  for (int idx = threadIdx.x; idx < n; idx += SSDB_THREADS) p[idx] = 0.0f;
}

__global__ void __launch_bounds__(SSDB_THREADS, 1)
ssd_chunk_bwd_kernel(const float* __restrict__ xdt,
                     const float* __restrict__ dA,
                     const float* __restrict__ B, const float* __restrict__ C,
                     const float* __restrict__ dy,
                     const float* __restrict__ dst, const SsdbDims d,
                     float* __restrict__ dxdt, float* __restrict__ ddA,
                     float* __restrict__ dBh, float* __restrict__ dCh) {
  const int hh = blockIdx.x, bc = blockIdx.y;     // bc = batch * c + chunk
  const int gi = hh / (d.h / d.g);
  const int l = d.l, n = d.n, p = d.p, ldn = d.ldn, ldp = d.ldp;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;

  extern __shared__ double ssdb_smem[];
  double* rowsum = ssdb_smem;                 // l each
  double* colsum = rowsum + l;
  double* wu = colsum + l;
  float* cum = reinterpret_cast<float*>(wu + l);
  float* w = cum + l;
  float* Ci = w + l;                          // 32 x ldn
  float* Bj = Ci + SSDB_T * ldn;
  float* dyi = Bj + SSDB_T * ldn;             // 32 x ldp
  float* xj = dyi + SSDB_T * ldp;
  float* G = xj + SSDB_T * ldp;               // 32 x 33 each
  float* D = G + SSDB_T * SSDB_TW;
  float* M = D + SSDB_T * SSDB_TW;
  float* accn = M + SSDB_T * SSDB_TW;         // 32 x n: dC, then dB
  float* accp = accn + SSDB_T * n;            // 32 x p: dxdt
  float* dS = accp + SSDB_T * p;              // n x ldp

  // row r of the head's (or group's) slice of each input
  const int64_t rowx = (int64_t)d.h * p, rowg = (int64_t)d.g * n;
  const float* xb = xdt + (int64_t)bc * l * rowx + (int64_t)hh * p;
  const float* yb = dy + (int64_t)bc * l * rowx + (int64_t)hh * p;
  const float* Bb = B + (int64_t)bc * l * rowg + (int64_t)gi * n;
  const float* Cb = C + (int64_t)bc * l * rowg + (int64_t)gi * n;
  const float* Sb = dst + ((int64_t)bc * d.h + hh) * n * p;
  float* dCb = dCh + ((int64_t)bc * d.h + hh) * l * n;
  float* dBb = dBh + ((int64_t)bc * d.h + hh) * l * n;

  for (int i = tid; i < l; i += SSDB_THREADS) {
    rowsum[i] = colsum[i] = wu[i] = 0.0;
    cum[i] = dA[((int64_t)bc * l + i) * d.h + hh];
  }
  for (int idx = tid; idx < n * p; idx += SSDB_THREADS) {
    const int r = idx / p, k = idx - r * p;
    dS[r * ldp + k] = Sb[idx];
  }
  __syncthreads();
  if (tid == 0) {             // the forward kernel's scan, in order
    float run = 0.0f;
    for (int i = 0; i < l; ++i) {
      run += cum[i];
      cum[i] = run;
    }
  }
  __syncthreads();
  for (int j = tid; j < l; j += SSDB_THREADS) w[j] = expf(cum[l - 1] - cum[j]);

  // ---- rows phase: dC, and M's row and column sums
  for (int it = 0; it < d.lt; ++it) {
    __syncthreads();
    ssdb_load(Ci, ldn, Cb, rowg, it * SSDB_T, l, n);
    ssdb_load(dyi, ldp, yb, rowx, it * SSDB_T, l, p);
    ssdb_zero(accn, SSDB_T * n);
    for (int jt = 0; jt <= it; ++jt) {
      __syncthreads();
      ssdb_load(Bj, ldn, Bb, rowg, jt * SSDB_T, l, n);
      ssdb_load(xj, ldp, xb, rowx, jt * SSDB_T, l, p);
      __syncthreads();
      ssdb_mm<1, false, true>(G, SSDB_TW, false, Ci, ldn, Bj, ldn, SSDB_T, n);
      ssdb_mm<1, false, true>(D, SSDB_TW, false, dyi, ldp, xj, ldp, SSDB_T,
                              p);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ty + 8 * e, ig = it * SSDB_T + i, jg = jt * SSDB_T + tx;
        const float L = (ig < l && jg <= ig) ? expf(cum[ig] - cum[jg]) : 0.0f;
        const float dd = D[i * SSDB_TW + tx];
        M[i * SSDB_TW + tx] = (L * G[i * SSDB_TW + tx]) * dd;
        D[i * SSDB_TW + tx] = L * dd;
      }
      __syncthreads();
      if (tid < SSDB_T) {
        const int ig = it * SSDB_T + tid;
        double s = 0.0;
        for (int j = 0; j < SSDB_T; ++j) s += (double)M[tid * SSDB_TW + j];
        if (ig < l) rowsum[ig] += s;
      } else if (tid < 2 * SSDB_T) {
        const int j = tid - SSDB_T, jg = jt * SSDB_T + j;
        double s = 0.0;
        for (int i = 0; i < SSDB_T; ++i) s += (double)M[i * SSDB_TW + j];
        if (jg < l) colsum[jg] += s;
      }
      ssdb_mm<4, false, false>(accn, n, true, D, SSDB_TW, Bj, ldn, n, SSDB_T);
    }
    __syncthreads();
    for (int idx = tid; idx < SSDB_T * n; idx += SSDB_THREADS) {
      const int r = idx / n, k = idx - r * n, ig = it * SSDB_T + r;
      if (ig < l) dCb[(int64_t)ig * n + k] = accn[idx];
    }
  }

  // ---- columns phase: dB, dxdt and the decay terms
  for (int jt = 0; jt < d.lt; ++jt) {
    __syncthreads();
    ssdb_load(Bj, ldn, Bb, rowg, jt * SSDB_T, l, n);
    ssdb_load(xj, ldp, xb, rowx, jt * SSDB_T, l, p);
    ssdb_zero(accn, SSDB_T * n);
    ssdb_zero(accp, SSDB_T * p);
    for (int it = jt; it < d.lt; ++it) {
      __syncthreads();
      ssdb_load(Ci, ldn, Cb, rowg, it * SSDB_T, l, n);
      ssdb_load(dyi, ldp, yb, rowx, it * SSDB_T, l, p);
      __syncthreads();
      ssdb_mm<1, false, true>(G, SSDB_TW, false, Ci, ldn, Bj, ldn, SSDB_T, n);
      ssdb_mm<1, false, true>(D, SSDB_TW, false, dyi, ldp, xj, ldp, SSDB_T,
                              p);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ty + 8 * e, ig = it * SSDB_T + i, jg = jt * SSDB_T + tx;
        const float L = (ig < l && jg <= ig) ? expf(cum[ig] - cum[jg]) : 0.0f;
        G[i * SSDB_TW + tx] = L * G[i * SSDB_TW + tx];
        D[i * SSDB_TW + tx] = L * D[i * SSDB_TW + tx];
      }
      __syncthreads();
      ssdb_mm<4, true, false>(accn, n, true, D, SSDB_TW, Ci, ldn, n, SSDB_T);
      ssdb_mm<4, true, false>(accp, p, true, G, SSDB_TW, dyi, ldp, p, SSDB_T);
    }
    __syncthreads();
    // E = B_j dstates (32 x p) into dyi, F = xdt_j dstates^T (32 x n) into Ci
    ssdb_mm<4, false, false>(dyi, ldp, false, Bj, ldn, dS, ldp, p, n);
    ssdb_mm<4, false, true>(Ci, ldn, false, xj, ldp, dS, ldp, n, p);
    __syncthreads();
    for (int idx = tid; idx < SSDB_T * p; idx += SSDB_THREADS) {
      const int r = idx / p, k = idx - r * p, jg = jt * SSDB_T + r;
      const float wj = jg < l ? w[jg] : 0.0f;
      accp[idx] += wj * dyi[r * ldp + k];
    }
    for (int idx = tid; idx < SSDB_T * n; idx += SSDB_THREADS) {
      const int r = idx / n, k = idx - r * n, jg = jt * SSDB_T + r;
      const float wj = jg < l ? w[jg] : 0.0f;
      accn[idx] += wj * Ci[r * ldn + k];
    }
    if (tid < SSDB_T && jt * SSDB_T + tid < l) {
      double u = 0.0;
      for (int k = 0; k < p; ++k)
        u += (double)(xj[tid * ldp + k] * dyi[tid * ldp + k]);
      wu[jt * SSDB_T + tid] = (double)w[jt * SSDB_T + tid] * u;
    }
    __syncthreads();
    for (int idx = tid; idx < SSDB_T * p; idx += SSDB_THREADS) {
      const int r = idx / p, k = idx - r * p, jg = jt * SSDB_T + r;
      if (jg < l) dxdt[((int64_t)bc * l + jg) * rowx + (int64_t)hh * p + k] =
          accp[idx];
    }
    for (int idx = tid; idx < SSDB_T * n; idx += SSDB_THREADS) {
      const int r = idx / n, k = idx - r * n, jg = jt * SSDB_T + r;
      if (jg < l) dBb[(int64_t)jg * n + k] = accn[idx];
    }
  }
  __syncthreads();

  // ---- d cum and its reverse cumsum, in f64
  if (tid == 0) {
    double total = 0.0;
    for (int j = 0; j < l; ++j) total += wu[j];
    double run = 0.0;
    for (int k = l - 1; k >= 0; --k) {
      run += rowsum[k] - colsum[k] - wu[k] + (k == l - 1 ? total : 0.0);
      ddA[((int64_t)bc * l + k) * d.h + hh] = (float)run;
    }
  }
}

// dB (or dC) of each group: the sum of its heads' partials in head order
__global__ void ssd_chunk_bwd_fold_kernel(const float* __restrict__ parts,
                                          float* __restrict__ dB,
                                          float* __restrict__ dC, int64_t bcs,
                                          int l, int h, int g, int n) {
  const float* src = parts + (blockIdx.y ? bcs * h * l * n : 0);
  float* out = blockIdx.y ? dC : dB;
  const int r = h / g;
  const int64_t total = bcs * l * g * n;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int k = (int)(idx % n);
    int64_t rest = idx / n;
    const int gi = (int)(rest % g);
    rest /= g;
    const int i = (int)(rest % l);
    const int64_t bc = rest / l;
    const float* head = src + ((bc * h + (int64_t)gi * r) * l + i) * n + k;
    double s = 0.0;
    for (int hr = 0; hr < r; ++hr) s += (double)head[(int64_t)hr * l * n];
    out[idx] = (float)s;
  }
}

static size_t ssdb_smem_bytes(int l, int p, int n) {
  const int ldn = ssdb_odd(n), ldp = ssdb_odd(p);
  const size_t floats = (size_t)2 * l + 2 * SSDB_T * ldn + 2 * SSDB_T * ldp +
                        3 * SSDB_T * SSDB_TW + SSDB_T * n + SSDB_T * p +
                        (size_t)n * ldp;
  return 8 * (size_t)3 * l + 4 * floats;
}

// dy, dxdt (b,c,l,h,p); dA, ddA (b,c,l,h); B, C, dB, dC (b,c,l,g,n);
// dst (b,c,h,n,p); scratch 2 b c h l n floats (the heads' dB, then dC).
extern "C" int ssd_chunk_bwd_launch(
    const float* xdt, const float* dA, const float* B, const float* C,
    const float* dy, const float* dst, int b, int c, int l, int h, int g,
    int p, int n, float* dxdt, float* ddA, float* dB, float* dC,
    float* scratch, void* stream) {
  if (b < 1 || c < 1 || l < 1 || h < 1 || g < 1 || h % g != 0 || p < 1 ||
      n < 1 || h > 65535 || (long long)b * c > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ssdb_smem_bytes(l, p, n);
  if (smem > SSDB_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  SsdbDims d;
  d.c = c;
  d.l = l;
  d.h = h;
  d.g = g;
  d.p = p;
  d.n = n;
  d.lt = (l + SSDB_T - 1) / SSDB_T;
  d.ldn = ssdb_odd(n);
  d.ldp = ssdb_odd(p);
  const int64_t bcs = (int64_t)b * c;
  float* dBh = scratch;
  float* dCh = scratch + bcs * h * l * n;
  ssd_chunk_bwd_kernel<<<dim3((unsigned)h, (unsigned)bcs), SSDB_THREADS,
                         smem, s>>>(xdt, dA, B, C, dy, dst, d, dxdt, ddA,
                                    dBh, dCh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = bcs * l * g * n;
  const int64_t blocks = (total + 255) / 256;
  ssd_chunk_bwd_fold_kernel<<<dim3((unsigned)(blocks < 4096 ? blocks : 4096),
                                   2), 256, 0, s>>>(scratch, dB, dC, bcs, l,
                                                    h, g, n);
  return (int)cudaGetLastError();
}
