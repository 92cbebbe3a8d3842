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
// running sum at weight 1.0 (fedavg_agg/ops.py fold_chunks).  A zero
// weight (the _pad_pow2 padding) adds an exact 0.0f, so padded folds give
// the unpadded result.  Where T % 4 == 0 and the stack and the output are
// 16-byte aligned, fedavg_agg_vec4_kernel reads 16 bytes a row a thread
// (four columns, each with the same FMA chain in set order); the main
// path's T (141,953) is odd and keeps the scalar loop.  At N 2 the call is
// host-bound (tools/fold_wrapper_split.py splits it).
//
// fedavg_agg_leaves_kernel folds the N parameter trees where their leaves
// lie, with no flatten and no stack: a LeafFold table passed by value
// (__grid_constant__, read in place from the parameter space) holds the N x L
// leaf pointers in JAX leaf order, the L leaf lengths and output pointers
// and the N weights.  The 1-D grid runs over (leaf, column block): block b
// belongs to the leaf l with block_start[l] <= b < block_start[l + 1].  Each
// thread adds w_i * x_i[j] for i = 0..N-1 in that order with the same FMAs
// as fedavg_agg_kernel, so the two routes agree bit for bit.  The table
// holds up to FOLD_MAX_PTRS pointers (64 sets of 16 leaves; the forecaster
// has 8) and FOLD_MAX_LEAVES leaves, 8.8 KB: Hopper takes up to 32,764
// bytes of kernel parameters from CUDA 12.1 on.  The wrapper chunks larger
// folds
// (fedavg_agg/ops.py pack_leaf_folds), sets as fold_chunks does and leaves in
// groups, and a later chunk reads its running sum from the output in place
// (each element is read and written by the same thread).

#include <cuda_runtime.h>
#include <stdint.h>

#define FEDAVG_MAX_N 64
#define FEDAVG_THREADS 256
#define FEDAVG_MAX_BLOCKS 4096
#define FOLD_MAX_PTRS 1024
#define FOLD_MAX_LEAVES 16

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

// four columns a thread by 16-byte loads: x and out 16-byte aligned, t4 =
// T / 4 float4s a row
__global__ void fedavg_agg_vec4_kernel(const float4* __restrict__ x,
                                       FoldWeights w, int n, int64_t t4,
                                       float4* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < t4;
       j += stride) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = 0; i < n; ++i) {
      const float4 v = x[(int64_t)i * t4 + j];
      acc.x = fmaf(w.w[i], v.x, acc.x);
      acc.y = fmaf(w.w[i], v.y, acc.y);
      acc.z = fmaf(w.w[i], v.z, acc.z);
      acc.w = fmaf(w.w[i], v.w, acc.w);
    }
    out[j] = acc;
  }
}

// weights: n packed floats (the wrapper's bytes), copied into the launch's
// parameters
extern "C" int fedavg_agg_launch(const float* x, const float* weights, int n,
                                 long long t, float* out, void* stream) {
  if (n < 1 || n > FEDAVG_MAX_N || t < 1) {
    return (int)cudaErrorInvalidValue;
  }
  FoldWeights w;
  for (int i = 0; i < FEDAVG_MAX_N; ++i) {
    w.w[i] = i < n ? weights[i] : 0.0f;
  }
  const bool vec = t % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  const long long cols = vec ? t / 4 : t;
  long long blocks = (cols + FEDAVG_THREADS - 1) / FEDAVG_THREADS;
  if (blocks > FEDAVG_MAX_BLOCKS) blocks = FEDAVG_MAX_BLOCKS;
  if (vec)
    fedavg_agg_vec4_kernel<<<(unsigned)blocks, FEDAVG_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const float4*)x, w, n, (int64_t)cols, (float4*)out);
  else
    fedavg_agg_kernel<<<(unsigned)blocks, FEDAVG_THREADS, 0,
                        (cudaStream_t)stream>>>(x, w, n, (int64_t)t, out);
  return (int)cudaGetLastError();
}

struct LeafFold {
  const float* x[FOLD_MAX_PTRS];   // x[i * n_leaves + l]: set i's leaf l
  float* out[FOLD_MAX_LEAVES];
  long long len[FOLD_MAX_LEAVES];
  long long block_start[FOLD_MAX_LEAVES + 1];   // filled by the launcher
  float w[FEDAVG_MAX_N];
  int n, n_leaves;
};

__global__ void fedavg_agg_leaves_kernel(const __grid_constant__ LeafFold f) {
  const long long blk = blockIdx.x;
  int l = 0;
  while (l + 1 < f.n_leaves && blk >= f.block_start[l + 1]) ++l;
  const long long j = (blk - f.block_start[l]) * FEDAVG_THREADS + threadIdx.x;
  if (j >= f.len[l]) return;
  float acc = 0.0f;
  for (int i = 0; i < f.n; ++i) {
    acc = fmaf(f.w[i], f.x[i * f.n_leaves + l][j], acc);
  }
  f.out[l][j] = acc;
}

extern "C" int fedavg_leaf_fold_size(void) { return (int)sizeof(LeafFold); }

extern "C" int fedavg_agg_leaves_launch(LeafFold* f, void* stream) {
  if (f->n < 1 || f->n > FEDAVG_MAX_N || f->n_leaves < 1 ||
      f->n_leaves > FOLD_MAX_LEAVES ||
      f->n * f->n_leaves > FOLD_MAX_PTRS) {
    return (int)cudaErrorInvalidValue;
  }
  long long blocks = 0;
  for (int l = 0; l < f->n_leaves; ++l) {
    if (f->len[l] < 0) return (int)cudaErrorInvalidValue;
    f->block_start[l] = blocks;
    blocks += (f->len[l] + FEDAVG_THREADS - 1) / FEDAVG_THREADS;
  }
  f->block_start[f->n_leaves] = blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fedavg_agg_leaves_kernel<<<(unsigned)blocks, FEDAVG_THREADS, 0,
                             (cudaStream_t)stream>>>(*f);
  return (int)cudaGetLastError();
}
