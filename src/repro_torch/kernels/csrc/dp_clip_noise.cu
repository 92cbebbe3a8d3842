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
// a launch.  So a release is one launch, with no host sync, no float
// atomics and no scratch on the solar sizes.
//
// Design, T <= DP_CLUSTER_CAP (196,608; the solar forecaster's 141,953):
// one thread-block cluster of n CTAs (n a power of two up to 16, a
// non-portable cluster size) of 1024 threads.  Each thread loads its R <= 12
// values of d and of the noise into registers at once (coalesced scalar
// loads, so any alignment of the three tensors works; the noise's loads
// overlap the norm), and the CTA reduces sum d^2 in a fixed tree into one
// partial in shared memory.  After cluster.sync() every CTA reads all n
// partials over distributed shared memory and adds them in the same fixed
// tree, so every CTA computes the same norm bit for bit.  Then each CTA
// applies clip and noise to the values it holds: 12 bytes per parameter,
// each moved once.  A second cluster barrier, split into arrive and wait
// around the apply, keeps a CTA's partial alive until every CTA has read
// it.  n and R are functions of T alone, so the summation order is.
//
// What bounds it at these sizes is latency, not bytes: the norm depends on
// the whole vector, so a call is two memory round trips (read everything,
// then write) with a cross-CTA barrier between them, where a streaming
// kernel makes one.  Variants timed against this one on the H100 (a
// cooperative grid holding the values in registers, one re-reading d,
// this cluster loading the noise only after the barrier) were not faster
// and are not kept.
//
// T > DP_CLUSTER_CAP: one cooperative launch (co-residency guaranteed) of
// DP_WIDE_THREADS-thread blocks, the grid a function of T alone capped at
// DP_WIDE_MAX_BLOCKS.  Each block writes its partial of a fixed-order
// grid-stride sum; a ticket (an unsigned atomic after __threadfence) elects
// the last block, which adds the partials in a fixed tree, publishes the
// scale and bumps an epoch flag with release semantics; the other blocks
// acquire-wait on the flag, then re-read d (from L2 at these sizes) to
// apply.  The flag counts launches, so it never needs a reset; the ticket is
// reset by the last block.  Its scratch is kept per (device, stream) by the
// wrapper.
//
// Products and the sum are rounded separately (__fmul_rn, __fadd_rn; no
// fused multiply-add), as the plain version rounds them.  A NaN in the
// delta makes the norm NaN; fmaxf/fminf would drop it, so the scale keeps
// it explicitly and every output is NaN, as in the reference
// (jnp.maximum/minimum and torch.clamp propagate NaN).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define DP_CTA_THREADS 1024
#define DP_MAX_CLUSTER 16
#define DP_MAX_PER_THREAD 12
#define DP_CLUSTER_CAP (DP_MAX_CLUSTER * DP_CTA_THREADS * DP_MAX_PER_THREAD)
#define DP_WIDE_THREADS 512
#define DP_WIDE_PER_THREAD 4      // values a thread per grid pass, at least
#define DP_WIDE_MAX_BLOCKS 256    // co-resident on 132 SMs at 2 an SM
// wide route's scratch (floats): partials, then scale, ticket, epoch flag
#define DP_WORK_SCALE DP_WIDE_MAX_BLOCKS
#define DP_WORK_TICKET (DP_WIDE_MAX_BLOCKS + 1)
#define DP_WORK_FLAG (DP_WIDE_MAX_BLOCKS + 2)

// sum over a warp's lanes in a fixed tree
__device__ __forceinline__ float dp_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// sum over the block in a fixed tree: each warp's lanes, then the warps'
// sums in lane order in warp 0; the total is returned in thread 0
__device__ __forceinline__ float dp_block_sum(float v, float* warp_part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = dp_warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (warp == 0) {
    total = lane < (int)(blockDim.x >> 5) ? warp_part[lane] : 0.0f;
    total = dp_warp_sum(total);
  }
  return total;
}

__device__ __forceinline__ float dp_scale(float sumsq, float clip) {
  const float norm = __fsqrt_rn(sumsq);
  const float q = __fdiv_rn(clip, isnan(norm) ? norm : fmaxf(norm, 1e-12f));
  return isnan(q) ? q : fminf(1.0f, q);
}

__device__ __forceinline__ float dp_apply(float x, float nz, float scale,
                                          float sigma) {
  return __fadd_rn(__fmul_rn(x, scale), __fmul_rn(nz, sigma));
}

__global__ void __launch_bounds__(DP_CTA_THREADS, 1)
dp_clip_noise_cluster_kernel(const float* __restrict__ d,
                             const float* __restrict__ noise, float clip,
                             float noise_multiplier, int64_t t,
                             int per_thread, float* __restrict__ out) {
  __shared__ float warp_part[32];
  __shared__ float cta_part;
  __shared__ float scale_s;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int64_t base = (int64_t)cluster.block_rank() * per_thread *
                       DP_CTA_THREADS + threadIdx.x;
  float v[DP_MAX_PER_THREAD], w[DP_MAX_PER_THREAD];
#pragma unroll
  for (int k = 0; k < DP_MAX_PER_THREAD; ++k) {
    const int64_t j = base + (int64_t)k * DP_CTA_THREADS;
    const bool in = k < per_thread && j < t;
    v[k] = in ? __ldg(d + j) : 0.0f;
    w[k] = in ? __ldg(noise + j) : 0.0f;
  }
  float s = 0.0f;                       // + 0 * 0 past the end: exact
#pragma unroll
  for (int k = 0; k < DP_MAX_PER_THREAD; ++k)
    s = __fadd_rn(s, __fmul_rn(v[k], v[k]));
  s = dp_block_sum(s, warp_part);
  if (threadIdx.x == 0) cta_part = s;
  cluster.sync();                       // every CTA's partial is written
  if (threadIdx.x < 32) {
    const int r = (int)threadIdx.x;
    float p = r < n ? *cluster.map_shared_rank(&cta_part, r) : 0.0f;
    p = dp_warp_sum(p);                 // the same tree in every CTA
    if (r == 0) scale_s = dp_scale(p, clip);
  }
  // this CTA has read every partial it needs: the others may leave
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  const float scale = scale_s;
  const float sigma = __fmul_rn(noise_multiplier, clip);
#pragma unroll
  for (int k = 0; k < DP_MAX_PER_THREAD; ++k) {
    const int64_t j = base + (int64_t)k * DP_CTA_THREADS;
    if (k < per_thread && j < t)
      out[j] = dp_apply(v[k], w[k], scale, sigma);
  }
  // no CTA leaves while another may still read its partial
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned dp_load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void dp_store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(DP_WIDE_THREADS, 2)   // 2 an SM: co-resident
dp_clip_noise_wide_kernel(const float* __restrict__ d,
                          const float* __restrict__ noise, float clip,
                          float noise_multiplier, int64_t t,
                          float* __restrict__ out, float* __restrict__ work) {
  __shared__ float warp_part[32];
  __shared__ float scale_s;
  __shared__ unsigned epoch;
  __shared__ bool last;
  unsigned* ticket = reinterpret_cast<unsigned*>(work + DP_WORK_TICKET);
  unsigned* flag = reinterpret_cast<unsigned*>(work + DP_WORK_FLAG);
  // the flag cannot move before every block has taken its ticket, and each
  // block reads it before taking one
  if (threadIdx.x == 0) epoch = dp_load_acquire(flag);
  const int64_t stride = (int64_t)gridDim.x * DP_WIDE_THREADS;
  const int64_t first = (int64_t)blockIdx.x * DP_WIDE_THREADS + threadIdx.x;
  float s = 0.0f;
  int64_t j = first;
  for (; j + 3 * stride < t; j += 4 * stride) {   // four loads in flight
    const float a = __ldg(d + j), b = __ldg(d + j + stride),
                c = __ldg(d + j + 2 * stride), e = __ldg(d + j + 3 * stride);
    s = __fadd_rn(s, __fmul_rn(a, a));
    s = __fadd_rn(s, __fmul_rn(b, b));
    s = __fadd_rn(s, __fmul_rn(c, c));
    s = __fadd_rn(s, __fmul_rn(e, e));
  }
  for (; j < t; j += stride) {
    const float a = __ldg(d + j);
    s = __fadd_rn(s, __fmul_rn(a, a));
  }
  s = dp_block_sum(s, warp_part);
  if (threadIdx.x == 0) {
    work[blockIdx.x] = s;
    __threadfence();                    // the partial is seen before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    const float p = threadIdx.x < gridDim.x ? __ldcg(work + threadIdx.x)
                                            : 0.0f;
    const float sum = dp_block_sum(p, warp_part);
    if (threadIdx.x == 0) {
      scale_s = dp_scale(sum, clip);
      work[DP_WORK_SCALE] = scale_s;
      *ticket = 0u;                     // ready for the next launch
      __threadfence();
      dp_store_release(flag, epoch + 1u);
    }
  } else if (threadIdx.x == 0) {
    while (dp_load_acquire(flag) == epoch) __nanosleep(64);
    scale_s = __ldcg(work + DP_WORK_SCALE);
  }
  __syncthreads();
  const float scale = scale_s;
  const float sigma = __fmul_rn(noise_multiplier, clip);
  for (int64_t i = first; i < t; i += stride)
    out[i] = dp_apply(d[i], __ldg(noise + i), scale, sigma);
}

// The cluster route's shape, a function of T alone: n CTAs (a power of two
// up to 16) and R values a thread.
static void dp_cluster_shape(long long t, int* n, int* per_thread) {
  const long long rows = (t + DP_CTA_THREADS - 1) / DP_CTA_THREADS;
  int c = 1;
  while (c < DP_MAX_CLUSTER && c < rows) c *= 2;
  *n = c;
  *per_thread = (int)((rows + c - 1) / c);
}

static int dp_launch_cluster(const float* delta, const float* noise,
                             float clip, float noise_multiplier, long long t,
                             float* out, cudaStream_t stream) {
  // cluster sizes above 8 are non-portable: allowed once, by one thread
  static const cudaError_t allowed = cudaFuncSetAttribute(
      dp_clip_noise_cluster_kernel,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (allowed != cudaSuccess) return (int)allowed;
  int n, per_thread;
  dp_cluster_shape(t, &n, &per_thread);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, 1, 1);
  cfg.blockDim = dim3(DP_CTA_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int64_t tt = (int64_t)t;
  cudaError_t err = cudaLaunchKernelEx(&cfg, dp_clip_noise_cluster_kernel,
                                       delta, noise, clip, noise_multiplier,
                                       tt, per_thread, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

static int dp_launch_wide(const float* delta, const float* noise, float clip,
                          float noise_multiplier, long long t, float* out,
                          float* work, cudaStream_t stream) {
  long long blocks = (t + DP_WIDE_THREADS * DP_WIDE_PER_THREAD - 1) /
                     (DP_WIDE_THREADS * DP_WIDE_PER_THREAD);
  if (blocks > DP_WIDE_MAX_BLOCKS) blocks = DP_WIDE_MAX_BLOCKS;
  int64_t tt = (int64_t)t;
  void* args[] = {(void*)&delta, (void*)&noise, (void*)&clip,
                  (void*)&noise_multiplier, (void*)&tt, (void*)&out,
                  (void*)&work};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)dp_clip_noise_wide_kernel, dim3((unsigned)blocks),
      dim3(DP_WIDE_THREADS), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One launch.  `work` is used above DP_CLUSTER_CAP only (it may be null
// below): DP_WIDE_MAX_BLOCKS + 3 floats, zeroed once by the caller and kept
// per stream.
extern "C" int dp_clip_noise_launch(const float* delta, const float* noise,
                                    float clip, float noise_multiplier,
                                    long long t, float* out, float* work,
                                    void* stream) {
  if (t < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (t <= DP_CLUSTER_CAP)
    return dp_launch_cluster(delta, noise, clip, noise_multiplier, t, out, s);
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  return dp_launch_wide(delta, noise, clip, noise_multiplier, t, out, work,
                        s);
}
