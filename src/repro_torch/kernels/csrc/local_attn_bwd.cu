// The ordered head fold of local_attn's gradient: both backward routes
// (local_attn_bwd_tc.cu on wgmma in bf16, local_attn_bwd_tf32.cu on split
// tf32) write each query head's dk and dv partial in f32 (dk unscaled), and
//   dk = scale sum_j dk_head[j], dv = sum_j dv_head[j]
// over the H / KV query heads j of each kv head, added in head order in
// f64 (ordered partials, no float atomics), rounded to the inputs' dtype.
//
// Part of the gradient of the Pallas kernel
// src/repro/kernels/local_attn/local_attn.py (flash_tiled -> _flash_kernel),
// which has none; the plain version is kernels/local_attn/ref.py's
// local_attention_bwd_ref (its sum over a group's heads).  Bound on the
// H100: bytes (2 B H T D floats read, 2 B KV T D values written), 0.02 ms
// at gemma-2b's training shape; a grid-stride pass, one output element a
// thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void lb_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void lb_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

// dtype 0: f32 dk and dv; 1: bf16
int local_attn_bwd_fold(const float* dk_head, const float* dv_head, void* dk,
                        void* dv, int64_t total, int g, int64_t head_stride,
                        float scale, int dtype, cudaStream_t s) {
  const int64_t blocks = (total + 255) / 256;
  const unsigned grid = (unsigned)(blocks < 8192 ? blocks : 8192);
  if (dtype == 1)
    local_attn_bwd_fold_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        dk_head, dv_head, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, total, g,
        head_stride, scale);
  else
    local_attn_bwd_fold_kernel<float><<<grid, 256, 0, s>>>(
        dk_head, dv_head, (float*)dk, (float*)dv, total, g, head_stride,
        scale);
  return (int)cudaGetLastError();
}
