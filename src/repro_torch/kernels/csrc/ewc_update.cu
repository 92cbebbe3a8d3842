// Fused continual-learning anchor update (L2-SP / EWC):
//   g_out = g + lam * F * (p - a)
//   loss  = 0.5 * lam * sum F * (p - a)^2          (F = 1 when fisher is null)
//
// Replaces the Pallas kernel src/repro/kernels/ewc_update/ewc_update.py
// (ewc_tiled -> _ewc_kernel).
//
// Bound on the H100: bytes.  Three (F = 1) or four f32 reads and one write
// per parameter: 2.3 MB at T = 141,953, about 0.7 us at 3.35 TB/s, shorter
// than a launch, so on the main path the update is launch-bound.
//
// Design: the Pallas kernel adds the scalar loss up across its grid, which
// the TPU runs in order.  GPU blocks run in parallel and in no order, so
// here each block reduces its share in a fixed tree order and writes one
// partial; a second, one-block kernel adds the partials in index order.
// The grid size depends only on T, so the sum is the same on every run: no
// float atomics.  A null fisher means F = 1 without a ones vector.

#include <cuda_runtime.h>
#include <stdint.h>

#define EWC_THREADS 256
#define EWC_MAX_BLOCKS 1024

__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = EWC_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  return red[0];
}

__global__ void ewc_partial_kernel(float lam, const float* __restrict__ g,
                                   const float* __restrict__ p,
                                   const float* __restrict__ a,
                                   const float* __restrict__ f, int64_t t,
                                   float* __restrict__ g_out,
                                   float* __restrict__ partials) {
  __shared__ float red[EWC_THREADS];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float s = 0.0f;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < t;
       j += stride) {
    const float d = p[j] - a[j];
    const float fd = f != nullptr ? f[j] * d : d;
    g_out[j] = g[j] + lam * fd;
    s = fmaf(fd, d, s);
  }
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void ewc_finish_kernel(const float* __restrict__ partials, int n,
                                  float lam, float* __restrict__ loss) {
  __shared__ float red[EWC_THREADS];
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += EWC_THREADS) s += partials[i];
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) loss[0] = 0.5f * lam * total;
}

// `partials` must hold EWC_MAX_BLOCKS floats.
extern "C" int ewc_update_launch(float lam, const float* g, const float* p,
                                 const float* a, const float* f, long long t,
                                 float* g_out, float* partials, float* loss,
                                 void* stream) {
  if (t < 1) return (int)cudaErrorInvalidValue;
  long long blocks = (t + EWC_THREADS - 1) / EWC_THREADS;
  if (blocks > EWC_MAX_BLOCKS) blocks = EWC_MAX_BLOCKS;
  cudaStream_t s = (cudaStream_t)stream;
  ewc_partial_kernel<<<(unsigned)blocks, EWC_THREADS, 0, s>>>(
      lam, g, p, a, f, (int64_t)t, g_out, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ewc_finish_kernel<<<1, EWC_THREADS, 0, s>>>(partials, (int)blocks, lam,
                                              loss);
  return (int)cudaGetLastError();
}
