// Gradient of the windowed causal / bidirectional flash attention with GQA
// (local_attn.cu's and local_attn_tc.cu's function):
//   q, dq, dout (B, H, S, D); k, v, dk, dv (B, KV, T, D), f32 or bf16 in and
//   out, f32 inside; query head hh reads kv head hh / (H / KV);
//   P_st = exp(scale q_s . k_t - lse_s) where allowed (t < T, causal:
//   t <= s, window: t > s - window), else 0; lse (B, H, S) f32 is the
//   forward's row log-sum-exp;
//   dP = dout V^T; delta_s = sum_t P_st dP_st; dS = P (dP - delta);
//   dq = scale dS K; dk = scale sum_g dS^T Q; dv = sum_g P^T dout, the sums
//   over the H / KV query heads of a kv head.
//
// Replaces the gradient of the Pallas kernel
// src/repro/kernels/local_attn/local_attn.py (flash_tiled -> _flash_kernel),
// which has none: the reference trains through its jnp attention.  The
// plain version is kernels/local_attn/ref.py's local_attention_bwd_ref.
//
// Bound on the H100: operations.  At gemma-2b (H 8, KV 1, D 256), B 2 and S
// 2048 the causal half needs five products of 2 D operations a pair (S,
// dP, dq, dk, dv): about 86 GFLOP of useful work against 59 MB moved,
// 0.087 ms on the bf16 tensor cores, 1.28 ms in f32 on the CUDA cores.
// This first kernel runs f32 on the CUDA cores and recomputes S and dP
// in each kernel and in delta's pass (18 D a pair, about 155 GFLOP);
// tensor-core designs are later work.
//
// Design: FlashAttention-2's split, no atomics.
//   local_attn_bwd_dq_kernel: one CTA per (32 query rows, head, batch).
//     Pass 1 walks the key tiles the rows see and sums delta_s = sum_t P dP
//     (exact from P and dP, not from the rounded output: a bf16 output
//     would move delta by its rounding); delta goes to global memory for
//     the second kernel.  Pass 2 walks them again: dS into shared memory,
//     dq += dS K.
//   local_attn_bwd_dkdv_kernel: one CTA per (16 keys, query head, batch);
//     it loops over the query tiles that see its keys, with P^T and dS^T
//     in shared memory: dv += P^T dout, dk += dS^T Q, written per query
//     head to a scratch.
//   local_attn_bwd_fold_kernel: a kv head's dk and dv, the sum of its
//     query heads' partials in head order in f64 (ordered partials, no
//     atomics).
// All three are issued by one call, dq first (it writes delta), on one
// stream.  Each tile's products go into a fresh register sum that is then
// added to the running one (a blocked sum): one chain over a group's 8
// heads and all their queries sat 2.4x the plain version's distance from
// the f64 answer in dk at gemma-2b's shape, the blocked sums within it.
// A CTA per query head (not per kv head, looping over its 8) spreads the
// causal mask's uneven work over 8x the CTAs.
// Thread (tr, tc) of 16 x 16 owns rows tr + 16r of its tile, score
// columns tc + 16c and output columns tc + 16e: 256 threads a CTA.  The
// dot products over D read four floats a load: tiles of D-wide rows have
// the stride D + 4, a multiple of 4 that is 4 (D 16: 20) banks apart, so
// the eight lanes of each phase of a 16-byte load hit 32 distinct banks.
// (On an H100 at gemma-2b's shape in bf16, a call took 22.4 ms with 128
// threads, the stride D + 1 and scalar loads, 12 loads a step of 16 FMAs;
// 19.6 ms with 16-byte shared-memory loads; 18.9 ms with 256 threads;
// 16.0 ms with the tiles' global loads in flight together; 11.4 ms with a
// dk/dv CTA per query head.)
// Tiles of keys wholly above the diagonal, left of the window or past T
// are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LB_THREADS 256
#define LB_TR (LB_THREADS / 16)   // rows of the 16-lane thread grid
#define LB_BQ 32          // query rows of a dq CTA and of a dk/dv step
#define LB_BK 32          // keys of a dq step
#define LB_BKV 16         // keys of a dk/dv CTA
#define LB_PS 33
#define LB_PAD 4          // row stride of the D-wide tiles: D + LB_PAD
#define LB_RQ (LB_BQ / LB_TR)     // query rows a dq thread owns
#define LB_RK (LB_BKV / LB_TR)    // key rows a dk/dv thread owns

__device__ __forceinline__ void lb_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void lb_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// four neighbouring floats of a tile row (16-byte aligned: D + LB_PAD is
// a multiple of 4), and a dot product's next four terms, in order
__device__ __forceinline__ float4 lb_f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float lb_dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ bool lb_allowed(int s, int t, int S, int T,
                                           int causal, int window) {
  bool ok = s < S && t < T;
  if (causal) ok = ok && t <= s;
  if (window) ok = ok && t > s - window;
  return ok;
}

// 16 bytes of a row (8 bf16 or 4 f32 values) as f32 into a tile row
__device__ __forceinline__ void lb_unpack(uint4 raw, float* dst,
                                          const float*) {
  *reinterpret_cast<uint4*>(dst) = raw;
}
__device__ __forceinline__ void lb_unpack(uint4 raw, float* dst,
                                          const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float4 lo, hi;
  float2 f = __bfloat1622float2(h[0]);
  lo.x = f.x;
  lo.y = f.y;
  f = __bfloat1622float2(h[1]);
  lo.z = f.x;
  lo.w = f.y;
  f = __bfloat1622float2(h[2]);
  hi.x = f.x;
  hi.y = f.y;
  f = __bfloat1622float2(h[3]);
  hi.z = f.x;
  hi.w = f.y;
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

// rows r0 .. r0 + ROWS - 1 of a (rows_total, D) slice into a tile of
// stride D + LB_PAD in f32; rows past rows_total read as zeros.  16-byte
// loads, every one of a thread issued before the first is stored, so
// they are in flight together (one load at a time, each waiting for the
// last, made the loads the kernels' largest cost).  The slice's rows
// start 16-byte aligned (the wrapper checks the pointers; D >= 16).
template <int D, int ROWS, typename T>
__device__ __forceinline__ void lb_tile(float* tile, const T* __restrict__ src,
                                        int r0, int rows_total) {
  constexpr int V = 16 / sizeof(T);             // values a load
  constexpr int PER_ROW = D / V;
  constexpr int N = ROWS * PER_ROW;
  constexpr int ITER = (N + LB_THREADS - 1) / LB_THREADS;
  uint4 buf[ITER];
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int idx = threadIdx.x + i * LB_THREADS;
    const int r = idx / PER_ROW, c = (idx - r * PER_ROW) * V;
    buf[i] = make_uint4(0u, 0u, 0u, 0u);
    if (idx < N && r0 + r < rows_total)
      buf[i] = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * D +
                                               c);
  }
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int idx = threadIdx.x + i * LB_THREADS;
    const int r = idx / PER_ROW, c = (idx - r * PER_ROW) * V;
    if (idx < N) lb_unpack(buf[i], tile + r * (D + LB_PAD) + c, src);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(LB_THREADS)
local_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, T* __restrict__ dq,
                         float* __restrict__ delta, int H, int KV, int S,
                         int Tk, float scale, int causal, int window) {
  constexpr int DS = D + LB_PAD;
  constexpr int DE = D / 16;
  extern __shared__ float lb_smem[];
  float* Qs = lb_smem;                 // LB_BQ x DS
  float* dOs = Qs + LB_BQ * DS;
  float* Ks = dOs + LB_BQ * DS;        // LB_BK x DS
  float* Vs = Ks + LB_BK * DS;
  float* dSs = Vs + LB_BK * DS;        // LB_BQ x LB_PS

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int q0 = blockIdx.x * LB_BQ, hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (H / KV);
  const int64_t bh = (int64_t)bb * H + hh;
  const T* kp = k + ((int64_t)bb * KV + kvh) * Tk * D;
  const T* vp = v + ((int64_t)bb * KV + kvh) * Tk * D;

  lb_tile<D, LB_BQ>(Qs, q + bh * S * D, q0, S);
  lb_tile<D, LB_BQ>(dOs, dout + bh * S * D, q0, S);
  float lrow[LB_RQ];
#pragma unroll
  for (int r = 0; r < LB_RQ; ++r) {
    const int s = q0 + tr + LB_TR * r;
    lrow[r] = s < S ? lse[bh * S + s] : 0.0f;
  }

  int kt_hi = (Tk + LB_BK - 1) / LB_BK;
  if (causal) kt_hi = min(kt_hi, (min(q0 + LB_BQ, S) - 1) / LB_BK + 1);
  int kt_lo = 0;
  if (window && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / LB_BK;

  float dsum[LB_RQ], drow[LB_RQ], acc[LB_RQ][DE];
#pragma unroll
  for (int r = 0; r < LB_RQ; ++r) {
    dsum[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < DE; ++e) acc[r][e] = 0.0f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = kt_lo; kt < kt_hi; ++kt) {
      const int k0 = kt * LB_BK;
      __syncthreads();                 // the tiles of the last step are free
      lb_tile<D, LB_BK>(Ks, kp, k0, Tk);
      lb_tile<D, LB_BK>(Vs, vp, k0, Tk);
      __syncthreads();
      float sc[LB_RQ][2], dp[LB_RQ][2];
#pragma unroll
      for (int r = 0; r < LB_RQ; ++r)
        sc[r][0] = sc[r][1] = dp[r][0] = dp[r][1] = 0.0f;
      for (int d = 0; d < D; d += 4) {
        const float4 k0v = lb_f4(Ks + tc * DS + d);
        const float4 k1v = lb_f4(Ks + (tc + 16) * DS + d);
        const float4 v0v = lb_f4(Vs + tc * DS + d);
        const float4 v1v = lb_f4(Vs + (tc + 16) * DS + d);
#pragma unroll
        for (int r = 0; r < LB_RQ; ++r) {
          const float4 qv = lb_f4(Qs + (tr + LB_TR * r) * DS + d);
          const float4 ov = lb_f4(dOs + (tr + LB_TR * r) * DS + d);
          sc[r][0] = lb_dot4(qv, k0v, sc[r][0]);
          sc[r][1] = lb_dot4(qv, k1v, sc[r][1]);
          dp[r][0] = lb_dot4(ov, v0v, dp[r][0]);
          dp[r][1] = lb_dot4(ov, v1v, dp[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < LB_RQ; ++r) {
        const int s = q0 + tr + LB_TR * r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int t = k0 + tc + 16 * c;
          const float P = lb_allowed(s, t, S, Tk, causal, window)
                              ? expf(scale * sc[r][c] - lrow[r])
                              : 0.0f;
          if (pass == 0)
            dsum[r] = fmaf(P, dp[r][c], dsum[r]);
          else
            dSs[(tr + LB_TR * r) * LB_PS + tc + 16 * c] =
                P * (dp[r][c] - drow[r]);
        }
      }
      if (pass == 0) continue;
      __syncthreads();
      // this tile's 32 terms in a fresh sum, then added to the rows' sums:
      // a blocked sum, as a GEMM's split of its depth
      float part[LB_RQ][DE];
#pragma unroll
      for (int r = 0; r < LB_RQ; ++r)
#pragma unroll
        for (int e = 0; e < DE; ++e) part[r][e] = 0.0f;
      for (int j = 0; j < LB_BK; ++j) {
        float sv[LB_RQ];
#pragma unroll
        for (int r = 0; r < LB_RQ; ++r)
          sv[r] = dSs[(tr + LB_TR * r) * LB_PS + j];
#pragma unroll
        for (int e = 0; e < DE; ++e) {
          const float kv = Ks[j * DS + tc + 16 * e];
#pragma unroll
          for (int r = 0; r < LB_RQ; ++r)
            part[r][e] = fmaf(sv[r], kv, part[r][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < LB_RQ; ++r)
#pragma unroll
        for (int e = 0; e < DE; ++e) acc[r][e] += part[r][e];
    }
    if (pass == 0) {
      // a row's delta over its 16 lanes (one half-warp), in a fixed tree
#pragma unroll
      for (int r = 0; r < LB_RQ; ++r) {
        float x = dsum[r];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        drow[r] = x;
        const int s = q0 + tr + LB_TR * r;
        if (tc == 0 && s < S) delta[bh * S + s] = x;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < LB_RQ; ++r) {
    const int s = q0 + tr + LB_TR * r;
    if (s >= S) continue;
    T* row = dq + (bh * S + s) * D;
#pragma unroll
    for (int e = 0; e < DE; ++e) lb_store(row + tc + 16 * e, scale * acc[r][e]);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(LB_THREADS)
local_attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk_head,
                           float* __restrict__ dv_head, int H, int KV, int S,
                           int Tk, float scale, int causal, int window) {
  constexpr int DS = D + LB_PAD;
  constexpr int DE = D / 16;
  extern __shared__ float lb_smem[];
  float* Ks = lb_smem;                 // LB_BKV x DS
  float* Vs = Ks + LB_BKV * DS;
  float* Qs = Vs + LB_BKV * DS;        // LB_BQ x DS
  float* dOs = Qs + LB_BQ * DS;
  float* Ps = dOs + LB_BQ * DS;        // LB_BKV x LB_PS: P^T
  float* dSs = Ps + LB_BKV * LB_PS;    // dS^T
  float* ls = dSs + LB_BKV * LB_PS;    // LB_BQ: lse, then delta
  float* dls = ls + LB_BQ;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int k0 = blockIdx.x * LB_BKV, hh = blockIdx.y, bb = blockIdx.z;
  const int64_t bkv = (int64_t)bb * KV + hh / (H / KV);
  const int64_t bh = (int64_t)bb * H + hh;
  lb_tile<D, LB_BKV>(Ks, k + bkv * Tk * D, k0, Tk);
  lb_tile<D, LB_BKV>(Vs, v + bkv * Tk * D, k0, Tk);

  // the query tiles that see these keys: [qt_lo, qt_hi)
  const int k_last = min(k0 + LB_BKV, Tk) - 1;
  const int qt_lo = causal ? k0 / LB_BQ : 0;
  int qt_hi = (S + LB_BQ - 1) / LB_BQ;
  if (window) qt_hi = min(qt_hi, (k_last + window - 1) / LB_BQ + 1);

  float acck[LB_RK][DE], accv[LB_RK][DE];
#pragma unroll
  for (int r = 0; r < LB_RK; ++r)
#pragma unroll
    for (int e = 0; e < DE; ++e) acck[r][e] = accv[r][e] = 0.0f;

  {
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * LB_BQ;
      __syncthreads();
      lb_tile<D, LB_BQ>(Qs, q + bh * S * D, q0, S);
      lb_tile<D, LB_BQ>(dOs, dout + bh * S * D, q0, S);
      for (int i = tid; i < LB_BQ; i += LB_THREADS) {
        ls[i] = q0 + i < S ? lse[bh * S + q0 + i] : 0.0f;
        dls[i] = q0 + i < S ? delta[bh * S + q0 + i] : 0.0f;
      }
      __syncthreads();
      // key rows tr + 16r, query columns tc + 16c (c < 2)
      float sc[LB_RK][2], dp[LB_RK][2];
#pragma unroll
      for (int r = 0; r < LB_RK; ++r)
        sc[r][0] = sc[r][1] = dp[r][0] = dp[r][1] = 0.0f;
      for (int d = 0; d < D; d += 4) {
        const float4 q0v = lb_f4(Qs + tc * DS + d);
        const float4 q1v = lb_f4(Qs + (tc + 16) * DS + d);
        const float4 o0v = lb_f4(dOs + tc * DS + d);
        const float4 o1v = lb_f4(dOs + (tc + 16) * DS + d);
#pragma unroll
        for (int r = 0; r < LB_RK; ++r) {
          const float4 kv = lb_f4(Ks + (tr + LB_TR * r) * DS + d);
          const float4 vv = lb_f4(Vs + (tr + LB_TR * r) * DS + d);
          sc[r][0] = lb_dot4(kv, q0v, sc[r][0]);
          sc[r][1] = lb_dot4(kv, q1v, sc[r][1]);
          dp[r][0] = lb_dot4(vv, o0v, dp[r][0]);
          dp[r][1] = lb_dot4(vv, o1v, dp[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < LB_RK; ++r) {
        const int t = k0 + tr + LB_TR * r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qc = tc + 16 * c, s = q0 + qc;
          const float P = lb_allowed(s, t, S, Tk, causal, window)
                              ? expf(scale * sc[r][c] - ls[qc])
                              : 0.0f;
          Ps[(tr + LB_TR * r) * LB_PS + qc] = P;
          dSs[(tr + LB_TR * r) * LB_PS + qc] = P * (dp[r][c] - dls[qc]);
        }
      }
      __syncthreads();
      // this tile's 32 queries in fresh sums, then added to the keys' sums
      // (a blocked sum over the head's queries)
      float pk[LB_RK][DE], pv2[LB_RK][DE];
#pragma unroll
      for (int r = 0; r < LB_RK; ++r)
#pragma unroll
        for (int e = 0; e < DE; ++e) pk[r][e] = pv2[r][e] = 0.0f;
      for (int j = 0; j < LB_BQ; ++j) {
        float pv[LB_RK], sv[LB_RK];
#pragma unroll
        for (int r = 0; r < LB_RK; ++r) {
          pv[r] = Ps[(tr + LB_TR * r) * LB_PS + j];
          sv[r] = dSs[(tr + LB_TR * r) * LB_PS + j];
        }
#pragma unroll
        for (int e = 0; e < DE; ++e) {
          const float ov = dOs[j * DS + tc + 16 * e];
          const float qv = Qs[j * DS + tc + 16 * e];
#pragma unroll
          for (int r = 0; r < LB_RK; ++r) {
            pv2[r][e] = fmaf(pv[r], ov, pv2[r][e]);
            pk[r][e] = fmaf(sv[r], qv, pk[r][e]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < LB_RK; ++r)
#pragma unroll
        for (int e = 0; e < DE; ++e) {
          accv[r][e] += pv2[r][e];
          acck[r][e] += pk[r][e];
        }
    }
  }

#pragma unroll
  for (int r = 0; r < LB_RK; ++r) {
    const int t = k0 + tr + LB_TR * r;
    if (t >= Tk) continue;
    float* krow = dk_head + (bh * Tk + t) * D;
    float* vrow = dv_head + (bh * Tk + t) * D;
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      krow[tc + 16 * e] = acck[r][e];
      vrow[tc + 16 * e] = accv[r][e];
    }
  }
}

// dk = scale sum_j dk_head and dv = sum_j dv_head over the H / KV query
// heads j of each kv head, added in head order in f64
template <typename T>
__global__ void local_attn_bwd_fold_kernel(const float* __restrict__ dk_head,
                                           const float* __restrict__ dv_head,
                                           T* __restrict__ dk,
                                           T* __restrict__ dv, int64_t total,
                                           int g, int64_t head_stride,
                                           float scale) {
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    // idx = (bkv * T + t) * D + d; the heads of kv head bkv start at
    // query head bkv * g, head_stride (T * D) floats apart
    const int64_t bkv = idx / head_stride, rest = idx - bkv * head_stride;
    const int64_t first = bkv * g * head_stride + rest;
    double sk = 0.0, sv = 0.0;
    for (int j = 0; j < g; ++j) {
      sk += (double)dk_head[first + j * head_stride];
      sv += (double)dv_head[first + j * head_stride];
    }
    lb_store(dk + idx, scale * (float)sk);
    lb_store(dv + idx, (float)sv);
  }
}

// the fold of the tensor-core route's partials (local_attn_bwd_tc.cu),
// bf16 dk and dv
int local_attn_bwd_fold_bf16(const float* dk_head, const float* dv_head,
                             void* dk, void* dv, int64_t total, int g,
                             int64_t head_stride, float scale,
                             cudaStream_t s) {
  const int64_t blocks = (total + 255) / 256;
  local_attn_bwd_fold_kernel<__nv_bfloat16>
      <<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, s>>>(
          dk_head, dv_head, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, total, g,
          head_stride, scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
static int lb_launch(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, void* dq, void* dk,
                     void* dv, float* delta, float* heads, int B, int H,
                     int KV, int S, int Tk, float scale, int causal,
                     int window, cudaStream_t s) {
  constexpr int DS = D + LB_PAD;
  const size_t dq_bytes =
      sizeof(float) * (2 * LB_BQ * DS + 2 * LB_BK * DS + LB_BQ * LB_PS);
  const size_t kv_bytes = sizeof(float) * (2 * LB_BKV * DS + 2 * LB_BQ * DS +
                                           2 * LB_BKV * LB_PS + 2 * LB_BQ);
  cudaError_t err = cudaFuncSetAttribute(
      local_attn_bwd_dq_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(local_attn_bwd_dkdv_kernel<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_bytes);
  if (err != cudaSuccess) return (int)err;
  local_attn_bwd_dq_kernel<D, T>
      <<<dim3((unsigned)((S + LB_BQ - 1) / LB_BQ), (unsigned)H, (unsigned)B),
         LB_THREADS, dq_bytes, s>>>((const T*)q, (const T*)k, (const T*)v,
                                    (const T*)dout, lse, (T*)dq, delta, H, KV,
                                    S, Tk, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t per_head = (int64_t)Tk * D;
  float* dk_head = heads;
  float* dv_head = heads + (int64_t)B * H * per_head;
  local_attn_bwd_dkdv_kernel<D, T>
      <<<dim3((unsigned)((Tk + LB_BKV - 1) / LB_BKV), (unsigned)H,
              (unsigned)B),
         LB_THREADS, kv_bytes, s>>>((const T*)q, (const T*)k, (const T*)v,
                                    (const T*)dout, lse, delta, dk_head,
                                    dv_head, H, KV, S, Tk, scale, causal,
                                    window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)B * KV * per_head;
  const int64_t blocks = (total + 255) / 256;
  local_attn_bwd_fold_kernel<T>
      <<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, s>>>(
          dk_head, dv_head, (T*)dk, (T*)dv, total, H / KV, per_head, scale);
  return (int)cudaGetLastError();
}

// All tensors contiguous; dtype 0 = float32, 1 = bfloat16; D one of 16,
// 32, 64, 128, 256; delta is (B, H, S) f32 scratch and heads 2 B H T D
// floats (each query head's dk, then dv, before the fold).
extern "C" int local_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, void* dq, void* dk,
                                     void* dv, float* delta, float* heads,
                                     int B, int H,
                                     int KV, int S, int Tk, int D,
                                     float scale, int causal, int window,
                                     int dtype, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || Tk < 1 ||
      B > 65535 || H > 65535 || window < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LB_CASE(DV)                                                         \
  case DV:                                                                  \
    return dtype == 0                                                       \
               ? lb_launch<DV, float>(q, k, v, dout, lse, dq, dk, dv, delta, \
                                      heads, B, H, KV, S, Tk, scale, causal, \
                                      window, s)                            \
               : lb_launch<DV, __nv_bfloat16>(                              \
                     q, k, v, dout, lse, dq, dk, dv, delta, heads, B, H, KV, \
                     S, Tk, scale, causal, window, s);
  switch (D) {
    LB_CASE(16)
    LB_CASE(32)
    LB_CASE(64)
    LB_CASE(128)
    LB_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LB_CASE
}
