// DP update privatization: clip by global L2 norm, then Gaussian noise.
//   scale = min(1, clip / max(||d||, 1e-12))      sigma = noise_multiplier * clip
//   out   = d * scale + noise * sigma
//
// Replaces the Pallas kernel src/repro/kernels/dp_clip_noise/dp_clip_noise.py
// (dp_clip_noise_tiled -> _sumsq_kernel, then _clip_noise_kernel).
//
// Bound on the H100: bytes.  The function reads the delta and the caller's
// standard-normal noise once and writes the output once: 12 bytes per
// parameter, 1.7 MB at T = 141,953, about 0.5 us at 3.35 TB/s, shorter than
// a launch, so on the solar run's privacy path a release is launch-bound.
// This design reads the delta a second time (for the norm, then for the
// output); at the solar size that second read can come from the 50 MB L2.
//
// Design: three kernels on the caller's stream, no host sync between them.
//  1. dp_sumsq_kernel: each block adds d^2 over its grid-stride share in a
//     fixed tree order and writes one partial.  The Pallas kernel adds into
//     one scalar across a grid the TPU runs in order; GPU blocks run in
//     parallel and in no order, so there are per-block partials here and no
//     float atomics.  The grid size depends only on T, so the sum is the
//     same on every run.
//  2. dp_finish_kernel: one block adds the partials in a fixed order and
//     writes [scale, sigma] to device memory.  The reference computes these
//     two scalars between its passes; reading them back to the host would
//     stall the stream once per release.
//  3. dp_apply_kernel: a streaming pass that reads the two scalars from
//     device memory.  Products and the sum are rounded separately (no fused
//     multiply-add), as the plain version rounds them.
// A NaN in the delta makes the norm NaN; fmaxf/fminf would drop it, so the
// finish keeps it explicitly and every output is NaN, as in the reference
// (jnp.maximum/minimum and torch.clamp propagate NaN).

#include <cuda_runtime.h>
#include <stdint.h>

#define DP_THREADS 256
#define DP_MAX_BLOCKS 1024
#define DP_APPLY_MAX_BLOCKS 4096

__device__ __forceinline__ float dp_block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = DP_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  return red[0];
}

__global__ void dp_sumsq_kernel(const float* __restrict__ d, int64_t t,
                                float* __restrict__ partials) {
  __shared__ float red[DP_THREADS];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float s = 0.0f;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < t;
       j += stride) {
    const float x = d[j];
    s = fmaf(x, x, s);
  }
  const float total = dp_block_sum(s, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void dp_finish_kernel(const float* __restrict__ partials, int n,
                                 float clip, float noise_multiplier,
                                 float* __restrict__ scalars) {
  __shared__ float red[DP_THREADS];
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += DP_THREADS) s += partials[i];
  const float total = dp_block_sum(s, red);
  if (threadIdx.x == 0) {
    const float norm = sqrtf(total);
    const float q = __fdiv_rn(clip, isnan(norm) ? norm : fmaxf(norm, 1e-12f));
    scalars[0] = isnan(q) ? q : fminf(1.0f, q);
    scalars[1] = __fmul_rn(noise_multiplier, clip);
  }
}

__global__ void dp_apply_kernel(const float* __restrict__ d,
                                const float* __restrict__ noise,
                                const float* __restrict__ scalars, int64_t t,
                                float* __restrict__ out) {
  const float scale = scalars[0];
  const float sigma = scalars[1];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < t;
       j += stride) {
    out[j] = __fadd_rn(__fmul_rn(d[j], scale), __fmul_rn(noise[j], sigma));
  }
}

// `scratch` must hold DP_MAX_BLOCKS + 2 floats: the partials, then
// [scale, sigma].
extern "C" int dp_clip_noise_launch(const float* delta, const float* noise,
                                    float clip, float noise_multiplier,
                                    long long t, float* out, float* scratch,
                                    void* stream) {
  if (t < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* partials = scratch;
  float* scalars = scratch + DP_MAX_BLOCKS;
  long long blocks = (t + DP_THREADS - 1) / DP_THREADS;
  if (blocks > DP_MAX_BLOCKS) blocks = DP_MAX_BLOCKS;
  dp_sumsq_kernel<<<(unsigned)blocks, DP_THREADS, 0, s>>>(delta, (int64_t)t,
                                                          partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dp_finish_kernel<<<1, DP_THREADS, 0, s>>>(partials, (int)blocks, clip,
                                            noise_multiplier, scalars);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long apply_blocks = (t + DP_THREADS - 1) / DP_THREADS;
  if (apply_blocks > DP_APPLY_MAX_BLOCKS) apply_blocks = DP_APPLY_MAX_BLOCKS;
  dp_apply_kernel<<<(unsigned)apply_blocks, DP_THREADS, 0, s>>>(
      delta, noise, scalars, (int64_t)t, out);
  return (int)cudaGetLastError();
}
