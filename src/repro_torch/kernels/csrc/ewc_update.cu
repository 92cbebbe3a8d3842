// Fused continual-learning anchor update (L2-SP / EWC):
//   g_out = g + lam * F * (p - a)
//   loss  = 0.5 * lam * sum F * (p - a)^2          (F = 1 when fisher is null)
//
// Replaces the Pallas kernel src/repro/kernels/ewc_update/ewc_update.py
// (ewc_tiled -> _ewc_kernel).
//
// Bound on the H100: bytes.  Three (F = 1) or four f32 reads and one write
// per parameter: 2.3 MB at T = 141,953, about 0.7 us at 3.35 TB/s, shorter
// than a launch, so on the main path the update is launch-bound: one launch
// a call, and the wrapper around it kept lean (kernels/ewc_update/ops.py).
//
// Design: the Pallas kernel adds the scalar loss up across its grid, which
// the TPU runs in order.  GPU blocks run in parallel and in no order, so
// here each block reduces its share in a fixed tree order and writes one
// partial; the block that finishes last (an integer ticket: __threadfence,
// then atomicAdd on an unsigned counter) adds all the partials in index
// order, writes the loss and resets the ticket for the next launch.  The
// sum's order is the same whichever block comes last, and the grid depends
// only on T, so the same bits come out on every run: no float atomics.
// Where every pointer is 16-byte aligned, each thread moves float4s and
// the grid-stride loop ends in a scalar tail; otherwise it moves floats
// (another, equally fixed order).  A null fisher means F = 1 without a
// ones vector.

#include <cuda_runtime.h>
#include <stdint.h>

#define EWC_THREADS 256
#define EWC_MAX_BLOCKS 1024
#define EWC_PER_THREAD 4     // floats a thread per grid pass (one float4)

__device__ __forceinline__ float ewc_block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = EWC_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  return red[0];
}

__device__ __forceinline__ float ewc_one(float lam, float g, float p, float a,
                                         float fj, float& s) {
  const float d = p - a;
  const float fd = fj * d;              // fj = 1 (exact) without a fisher
  s = fmaf(fd, d, s);
  return g + lam * fd;
}

__global__ void __launch_bounds__(EWC_THREADS)
ewc_update_kernel(float lam, const float* __restrict__ g,
                  const float* __restrict__ p, const float* __restrict__ a,
                  const float* __restrict__ f, int64_t t, int vec,
                  float* __restrict__ g_out, float* __restrict__ partials,
                  unsigned int* __restrict__ ticket,
                  float* __restrict__ loss) {
  __shared__ float red[EWC_THREADS];
  __shared__ bool last;
  const int64_t stride = (int64_t)gridDim.x * EWC_THREADS;
  const int64_t first = (int64_t)blockIdx.x * EWC_THREADS + threadIdx.x;
  float s = 0.0f;
  int64_t tail = 0;
  if (vec) {
    const int64_t t4 = t / 4;
    for (int64_t j = first; j < t4; j += stride) {
      const float4 gv = reinterpret_cast<const float4*>(g)[j];
      const float4 pv = reinterpret_cast<const float4*>(p)[j];
      const float4 av = reinterpret_cast<const float4*>(a)[j];
      const float4 fv = f != nullptr ? reinterpret_cast<const float4*>(f)[j]
                                     : make_float4(1.f, 1.f, 1.f, 1.f);
      float4 o;
      o.x = ewc_one(lam, gv.x, pv.x, av.x, fv.x, s);
      o.y = ewc_one(lam, gv.y, pv.y, av.y, fv.y, s);
      o.z = ewc_one(lam, gv.z, pv.z, av.z, fv.z, s);
      o.w = ewc_one(lam, gv.w, pv.w, av.w, fv.w, s);
      reinterpret_cast<float4*>(g_out)[j] = o;
    }
    tail = t4 * 4;
  }
  for (int64_t j = tail + first; j < t; j += stride)
    g_out[j] = ewc_one(lam, g[j], p[j], a[j], f != nullptr ? f[j] : 1.0f, s);

  const float total = ewc_block_sum(s, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = total;
    __threadfence();                    // the partial is seen before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float r = 0.0f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += EWC_THREADS)
    r += __ldcg(partials + i);          // past L1: other blocks' writes
  const float sum = ewc_block_sum(r, red);
  if (threadIdx.x == 0) {
    loss[0] = 0.5f * lam * sum;
    *ticket = 0u;                       // ready for the next launch
  }
}

// `work` holds EWC_MAX_BLOCKS partials then the ticket, zeroed once by the
// caller and kept per stream (the last block leaves the ticket at 0).
extern "C" int ewc_update_launch(float lam, const float* g, const float* p,
                                 const float* a, const float* f, long long t,
                                 float* g_out, float* work, float* loss,
                                 void* stream) {
  if (t < 1) return (int)cudaErrorInvalidValue;
  long long blocks = (t + EWC_THREADS * EWC_PER_THREAD - 1) /
                     (EWC_THREADS * EWC_PER_THREAD);
  if (blocks > EWC_MAX_BLOCKS) blocks = EWC_MAX_BLOCKS;
  const int vec = (((uintptr_t)g | (uintptr_t)p | (uintptr_t)a |
                    (uintptr_t)f | (uintptr_t)g_out) % 16) == 0;
  ewc_update_kernel<<<(unsigned)blocks, EWC_THREADS, 0,
                      (cudaStream_t)stream>>>(
      lam, g, p, a, f, (int64_t)t, vec, g_out, work,
      reinterpret_cast<unsigned int*>(work + EWC_MAX_BLOCKS), loss);
  return (int)cudaGetLastError();
}
