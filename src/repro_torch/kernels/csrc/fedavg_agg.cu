// N-way weighted parameter fold: out[t] = sum_i w_i * x[i, t].
//
// Replaces the Pallas kernel src/repro/kernels/fedavg_agg/fedavg_agg.py
// (agg_tiled -> _agg_kernel), the FedCCL server's Algorithm-2 fold.
//
// Bound on the H100: bytes.  The fold reads the (N, T) f32 stack once and
// writes T floats, at N/((N+1)*4) FLOP per byte.  On the main path (N = 2,
// T = 141,953) that is 1.7 MB, about 0.5 us at 3.35 TB/s, which is shorter
// than one kernel launch: the fold is launch-bound there.
//
// Design: one grid-stride pass.  Each thread owns one column t and adds
// w_i * x[i, t] for i = 0..N-1 in that order, in f32, as the reference does;
// neighbouring threads read neighbouring columns, so every row read is
// coalesced.  The weights travel by value in the launch parameters (no
// host-to-device copy, no extra allocation); N is capped at FEDAVG_MAX_N, and
// the wrapper folds more sets in ordered chunks, each chunk behind the
// running sum at weight 1.0 (fedavg_agg/ops.py fold_chunks).  A zero weight (the _pad_pow2 padding) adds an
// exact 0.0f, so padded folds give the unpadded result.

#include <cuda_runtime.h>
#include <stdint.h>

#define FEDAVG_MAX_N 64
#define FEDAVG_THREADS 256
#define FEDAVG_MAX_BLOCKS 4096

struct FoldWeights {
  float w[FEDAVG_MAX_N];
};

__global__ void fedavg_agg_kernel(const float* __restrict__ x, FoldWeights w,
                                  int n, int64_t t, float* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < t;
       j += stride) {
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      acc = fmaf(w.w[i], x[(int64_t)i * t + j], acc);
    }
    out[j] = acc;
  }
}

extern "C" int fedavg_agg_launch(const float* x, const float* weights, int n,
                                 long long t, float* out, void* stream) {
  if (n < 1 || n > FEDAVG_MAX_N || t < 1) {
    return (int)cudaErrorInvalidValue;
  }
  FoldWeights w;
  for (int i = 0; i < FEDAVG_MAX_N; ++i) {
    w.w[i] = i < n ? weights[i] : 0.0f;
  }
  long long blocks = (t + FEDAVG_THREADS - 1) / FEDAVG_THREADS;
  if (blocks > FEDAVG_MAX_BLOCKS) blocks = FEDAVG_MAX_BLOCKS;
  fedavg_agg_kernel<<<(unsigned)blocks, FEDAVG_THREADS, 0,
                      (cudaStream_t)stream>>>(x, w, n, (int64_t)t, out);
  return (int)cudaGetLastError();
}
