// Windowed causal / bidirectional flash attention with GQA:
//   q (B, H, S, D), k and v (B, KV, T, D), f32 or bf16 in and out, f32 inside;
//   query head hh reads key/value head hh / (H / KV);
//   score = (q * scale) . k, masked to NEG_INF unless k_pos < t_real and
//   (causal: k_pos <= q_pos) and (window: k_pos > q_pos - window);
//   out = softmax(score) @ v, by an online softmax over key tiles.
// S and T are multiples of the tiles (the wrapper pads them); t_real is the
// unpadded T.  This kernel takes every f32 call and bf16 at D 16 or 32;
// bf16 at D 64, 128 or 256 runs on the tensor cores (local_attn_tc.cu).
//
// Replaces the Pallas kernel src/repro/kernels/local_attn/local_attn.py
// (flash_tiled -> _flash_kernel).
//
// Bound on the H100: f32 operations on the CUDA cores.  At gemma-2b (H 8,
// KV 1, D 256), B 2 and S 2048 the causal half is about 34.4 GFLOP against
// about 38 MB moved: 0.51 ms at 67 TFLOP/s.  In bf16 on the tensor cores
// the floor would be 0.035 ms (local_attn_tc.cu takes those calls); this
// kernel computes in f32, as the reference does, and uses no tensor cores,
// which keeps f32 inputs within 2e-5 of the plain version.
//
// Design: on the TPU the key axis is the innermost, sequential grid axis
// and the softmax carry (m, l, acc) lives in VMEM across it.  Here one
// block owns a tile of LA_BQ query rows of one (b, head) and loops over
// the key tiles itself, so nothing is carried across blocks.  D = 256 does
// not fit the reference's 128 x 128 blocks (three f32 128 x 256 tiles are
// 384 KB against 227 KB of shared memory), so the tiles are 32 x 32: Q
// (pre-scaled), K and V tiles and the probability tile take 103 KB of
// dynamic shared memory at D = 256 (opted in above 48 KB).  Thread
// (tr, tc) of the 8 x 16 grid owns rows tr + 8r (r < 4), score columns
// tc + 16c (c < 2) and output columns tc + 16e (e < D / 16); a row's max
// and sum are reduced over its 16 lanes with shuffles.  Key tiles wholly
// above the diagonal, left of the window or past t_real are skipped, as
// the reference skips its blocks.  NEG_INF is the reference's finite
// -2^30, and the output divides by max(l, 1e-30): a row whose first
// visited tile is fully masked accumulates exp(0) = 1 weights, which the
// next tile's correction exp(-2^30 - m) wipes out (with -inf that tile
// would give NaN).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LA_THREADS 128
#define LA_BQ 32
#define LA_BK 32
#define LA_NEG_INF (-1073741824.0f)

__device__ __forceinline__ float la_load(const float* p) { return *p; }
__device__ __forceinline__ float la_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void la_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void la_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D, typename T>
__global__ void __launch_bounds__(LA_THREADS)
local_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, int H, int KV, int S, int Tk,
                  int t_real, float scale, int causal, int window) {
  constexpr int DS = D + 1;               // padded row stride of Q and K
  constexpr int DE = D / 16;              // output columns per thread
  constexpr int PS = LA_BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                       // LA_BQ x DS
  float* Ks = Qs + LA_BQ * DS;            // LA_BK x DS
  float* Vs = Ks + LA_BK * DS;            // LA_BK x D
  float* Ps = Vs + LA_BK * D;             // LA_BQ x PS

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int q0 = blockIdx.x * LA_BQ, hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (H / KV);
  const int64_t qoff = (((int64_t)bb * H + hh) * S + q0) * D;
  const T* kp = k + ((int64_t)bb * KV + kvh) * Tk * D;
  const T* vp = v + ((int64_t)bb * KV + kvh) * Tk * D;

  for (int idx = tid; idx < LA_BQ * D; idx += LA_THREADS) {
    const int r = idx / D, d = idx - r * D;
    Qs[r * DS + d] = la_load(q + qoff + idx) * scale;
  }

  float acc[4][DE], m[4], lsum[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = LA_NEG_INF;
    lsum[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < DE; ++e) acc[r][e] = 0.0f;
  }

  const int nk = Tk / LA_BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * LA_BK;
    if (causal && k0 > q0 + LA_BQ - 1) break;
    if (window && k0 + LA_BK - 1 <= q0 - window) continue;
    if (k0 >= t_real) break;
    __syncthreads();                      // Qs written; Ks, Vs, Ps free
    for (int idx = tid; idx < LA_BK * D; idx += LA_THREADS) {
      const int r = idx / D, d = idx - r * D;
      Ks[r * DS + d] = la_load(kp + (int64_t)k0 * D + idx);
      Vs[idx] = la_load(vp + (int64_t)k0 * D + idx);
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(tr + 8 * r) * DS + d];
      const float k0v = Ks[tc * DS + d], k1v = Ks[(tc + 16) * DS + d];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[r][0] = fmaf(qv[r], k0v, s[r][0]);
        s[r][1] = fmaf(qv[r], k1v, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + tr + 8 * r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + tc + 16 * c;
        bool ok = kpos < t_real;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        if (!ok) s[r][c] = LA_NEG_INF;
      }
      // the row's max and sum over its 16 lanes (one half-warp)
      float mx = fmaxf(s[r][0], s[r][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      float ps = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float corr = expf(m[r] - m_new);
      lsum[r] = lsum[r] * corr + ps;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < DE; ++e) acc[r][e] *= corr;
      Ps[(tr + 8 * r) * PS + tc] = p0;
      Ps[(tr + 8 * r) * PS + tc + 16] = p1;
    }
    __syncthreads();

    for (int j = 0; j < LA_BK; ++j) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ps[(tr + 8 * r) * PS + j];
#pragma unroll
      for (int e = 0; e < DE; ++e) {
        const float vv = Vs[j * D + tc + 16 * e];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][e] = fmaf(pv[r], vv, acc[r][e]);
      }
    }
  }

  // each row's log-sum-exp of the scaled scores, for the backward
  // (local_attn_bwd.cu); a row's 16 lanes hold the same m and lsum
  if (lse != nullptr && tc == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      lse[((int64_t)bb * H + hh) * S + q0 + tr + 8 * r] =
          m[r] + logf(lsum[r]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float inv = 1.0f / fmaxf(lsum[r], 1e-30f);
    T* orow = o + qoff + (int64_t)(tr + 8 * r) * D;
#pragma unroll
    for (int e = 0; e < DE; ++e) la_store(orow + tc + 16 * e, acc[r][e] * inv);
  }
}

template <int D, typename T>
static int la_launch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int H, int KV, int S, int Tk,
                     int t_real, float scale, int causal, int window,
                     cudaStream_t s) {
  const size_t bytes = sizeof(float) * (LA_BQ * (D + 1) + LA_BK * (D + 1) +
                                        LA_BK * D + LA_BQ * (LA_BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      local_attn_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(S / LA_BQ), (unsigned)H, (unsigned)B);
  local_attn_kernel<D, T><<<grid, LA_THREADS, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, H, KV, S, Tk,
      t_real, scale, causal, window);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  D must be 16, 32, 64, 128 or 256.
// lse: null, or (B, H, S) f32 for each row's log-sum-exp of the scaled
// scores (the backward's softmax statistics).
extern "C" int local_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int KV, int S, int Tk,
                                 int t_real, int D, float scale, int causal,
                                 int window, int dtype, float* lse,
                                 void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S % LA_BQ != 0 ||
      Tk % LA_BK != 0 || S < LA_BQ || Tk < LA_BK || t_real < 1 ||
      t_real > Tk || B > 65535 || H > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LA_CASE(DV)                                                         \
  case DV:                                                                  \
    return dtype == 0                                                       \
               ? la_launch<DV, float>(q, k, v, o, lse, B, H, KV, S, Tk,     \
                                      t_real, scale, causal, window, s)     \
               : la_launch<DV, __nv_bfloat16>(q, k, v, o, lse, B, H, KV, S, \
                                              Tk, t_real, scale, causal,    \
                                              window, s);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    LA_CASE(16)
    LA_CASE(32)
    LA_CASE(64)
    LA_CASE(128)
    LA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LA_CASE
}
