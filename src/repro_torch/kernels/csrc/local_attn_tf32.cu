// Windowed causal / bidirectional flash attention with GQA on Hopper's
// tensor cores in split tf32, for f32 q, k, v at every head dim D of 16,
// 32, 64, 128, 256, and bf16 at D 16 or 32 (the calls local_attn_tc.cu does
// not take; the wrapper kernels/local_attn/ops.py route() chooses):
//   q (B, H, S, D), k and v (B, KV, T, D), f32 or bf16 in and out, f32
//   inside; query head hh reads key/value head hh / (H / KV);
//   score = scale (q . k), masked to NEG_INF unless k_pos < T and
//   (causal: k_pos <= q_pos) and (window: k_pos > q_pos - window);
//   out = softmax(score) @ v, by an online softmax over key tiles; lse
//   (optional, (B, H, S) f32) each row's log-sum-exp of the scores, which
//   the backward (local_attn_bwd_tf32.cu) reads.
// q, k, v and the output go by (batch, head, row) strides, the last dim
// contiguous, every stride and pointer a multiple of 16 bytes (cp.async).
//
// Replaces the Pallas kernel src/repro/kernels/local_attn/local_attn.py
// (flash_tiled -> _flash_kernel).  The plain version is
// kernels/local_attn/ref.py's local_attention_ref.
//
// Bound on the H100: operations.  At gemma-2b (H 8, KV 1, D 256), B 2 and
// S 2048 the causal half needs two products of 2 D operations a pair (S =
// Q K^T, O = P V): 34.4 GFLOP, 0.513 ms in f32 on the CUDA cores; on the
// tf32 tensor cores (495 TFLOP/s dense) 0.208 ms for three partial products
// a product.  The CUDA-core kernel this one replaced ran every product as
// an f32 FMA, four shared-memory loads for eight FMAs (PERF.md).
//
// Products: local_attn_tf32_common.cuh's split tf32 (LT_PARTS 2: hi =
// tf32(x), lo = x - hi, three partial products into a fresh accumulator a
// k-step of 8, then one round-to-nearest add), as the backward takes them.
//
// Layout: FlashAttention-2's forward.  A CTA owns LT_BM = 64 query rows of
// one (b, head): 4 row groups of 16 rows, LF_SPLIT warps each.  Q stays in
// shared memory; K and V tiles of BN keys (LtShape: 32 at D 256, 64 below)
// stream through a cp.async ring of LF_STAGES stages (it fits 227 KB at
// every D: 204.5 KB at D 256 in f32).  For each key tile:
//   1. S = Q K^T, each warp of a row group BN / LF_SPLIT of the columns;
//   2. the online softmax in registers: scale, mask, the row max over the
//      quad's four lanes (and over the row group's warps through shared
//      memory), the correction exp(m_old - m_new) of the running output and
//      of each thread's share of the row sum;
//   3. P = exp(score - m) into the row group's shared E tile;
//   4. O += P V, each warp D / LF_SPLIT of the output columns, from E.
// The row sums' shares are added at the end in a fixed order (the quad's
// lanes by xor 1 then 2, then the row group's warps in order), and the
// output is divided by max(l, 1e-30).  NEG_INF is the reference's finite
// -2^30: a row whose first visited tile is fully masked accumulates exp(0) =
// 1 weights, which the next tile's correction exp(-2^30 - m) wipes out, as
// in the reference.  Tiles wholly above the diagonal, left of the window
// or past T are never loaded; rows past S or T are zero-filled by cp.async
// and masked.  Blocks are numbered longest first.

#include "local_attn_tf32_common.cuh"

#define LF_SPLIT 2      // warps a row group, splitting its columns
#define LF_WARPS (4 * LF_SPLIT)
#define LF_THREADS (32 * LF_WARPS)
#define LF_STAGES 2     // cp.async stages of the K / V ring
#define LF_NEG_INF (-1073741824.0f)

// (batch, head, row) strides of q, k, v and the output, in elements
struct LfStrides {
  long long q[3], k[3], v[3], o[3];
};

// the dynamic shared memory (tests/test_torch_attn_fwd_tf32.py mirrors
// it): the Q tile, LF_STAGES x 2 streamed BN-row tiles (rows D + pad
// elements apart), the E tile (64 x (BN + 4) f32) and each warp's share of
// its rows' maxima and sums (64 x LF_SPLIT f32)
template <int D, typename T>
__host__ __device__ constexpr int lf_smem() {
  return (LT_BM + LF_STAGES * 2 * LtShape<D>::BN) * (D + LtPad<T>::v) *
             (int)sizeof(T) +
         4 * (LT_BM * LtShape<D>::EW + LT_BM * LF_SPLIT);
}

// the LF_SPLIT warps of row group wm meet (named barrier 1 + wm; 0 is
// __syncthreads')
__device__ __forceinline__ void lf_group_sync(int wm) {
  if constexpr (LF_SPLIT > 1)
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wm), "n"(32 * LF_SPLIT)
                 : "memory");
  else
    __syncwarp();
}

// Thread (warp, lane): row group wm = warp % 4, part = warp / 4 of its
// columns; rows gq and gq + 8 of the group, columns 2 tq, 2 tq + 1 of every
// 8-column group of its accumulators.
template <int D, typename T>
__global__ void __launch_bounds__(LF_THREADS, 1)
local_attn_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, LfStrides sd, int B, int H,
                       int KV, int S, int Tk, float scale, int causal,
                       int window) {
  using Sh = LtShape<D>;
  constexpr int BN = Sh::BN, EW = Sh::EW, LD = D + LtPad<T>::v;
  constexpr int SN = BN / LF_SPLIT;       // a warp's score columns
  constexpr int ON = D / LF_SPLIT;        // a warp's output columns
  static_assert(LF_STAGES >= 2 && lf_smem<D, T>() <= 232448,
                "the ring does not fit the 227 KB a block can take");
  extern __shared__ __align__(16) unsigned char lt_dyn[];
  T* Qs = reinterpret_cast<T*>(lt_dyn);
  T* ring = Qs + LT_BM * LD;              // stage s: K, then V
  float* Es = reinterpret_cast<float*>(ring + LF_STAGES * 2 * BN * LD);
  float* Xs = Es + LT_BM * EW;            // [part][row]: maxima, then sums

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, part = warp >> 2, gq = lane >> 2, tq = lane & 3;
  const int nq = (S + LT_BM - 1) / LT_BM;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (nq - 1 - (int)(blockIdx.x / (B * H))) * LT_BM;
  const int bb = bh / H, hh = bh % H, kvh = hh / (H / KV);
  const T* qp = q + bb * sd.q[0] + hh * sd.q[1];
  const T* kp = k + bb * sd.k[0] + kvh * sd.k[1];
  const T* vp = v + bb * sd.v[0] + kvh * sd.v[1];

  // the key tiles the rows see: [kt_lo, kt_hi)
  int kt_hi = (Tk + BN - 1) / BN;
  if (causal) kt_hi = min(kt_hi, (min(q0 + LT_BM, S) - 1) / BN + 1);
  const int kt_lo =
      (window && q0 - window + 1 > 0) ? (q0 - window + 1) / BN : 0;
  const int ntiles = max(kt_hi - kt_lo, 0);

  auto load = [&](int i) {
    T* dst = ring + (i % LF_STAGES) * 2 * BN * LD;
    const int r0 = (kt_lo + i) * BN;
    lt_tile<BN, D, LF_THREADS>(dst, kp, r0, Tk, sd.k[2]);
    lt_tile<BN, D, LF_THREADS>(dst + BN * LD, vp, r0, Tk, sd.v[2]);
  };
  lt_tile<LT_BM, D, LF_THREADS>(Qs, qp, q0, S, sd.q[2]);
#pragma unroll
  for (int i = 0; i < LF_STAGES - 1; ++i) {
    if (i < ntiles) load(i);
    ssd_commit();
  }

  const int r0 = q0 + 16 * wm + gq, r1 = r0 + 8;
  const T* X = Qs + 16 * wm * LD;
  float* Eg = Es + 16 * wm * EW;          // the row group's P
  float* Xg = Xs + 16 * wm + gq;          // its rows' slots, part 0
  float acc[ON / 8][4];
#pragma unroll
  for (int nt = 0; nt < ON / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  float m0 = LF_NEG_INF, m1 = LF_NEG_INF, l0 = 0.0f, l1 = 0.0f;

  for (int i = 0; i < ntiles; ++i) {
    const T* Ky = ring + (i % LF_STAGES) * 2 * BN * LD;
    const T* Vy = Ky + BN * LD;
    const int k0 = (kt_lo + i) * BN + part * SN;   // this warp's first key
    ssd_wait<LF_STAGES - 2>();
    __syncthreads();        // tile i is in; tile i - 1's stage is free
    if (i + LF_STAGES - 1 < ntiles) load(i + LF_STAGES - 1);
    ssd_commit();

    // 1. S = Q K^T, this warp's SN columns
    float x[SN / 8][4];
#pragma unroll
    for (int nt = 0; nt < SN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nt][e] = 0.0f;
    lt_mm<SN / 8, D / 8, true, LT_PARTS, LD, LD>(x, X, Ky + part * SN * LD);

    // 2. scale and mask; the rows' maxima over the quad and the group
    float mx0 = LF_NEG_INF, mx1 = LF_NEG_INF;
#pragma unroll
    for (int nt = 0; nt < SN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e & 2) ? r1 : r0;
        const int col = k0 + 8 * nt + 2 * tq + (e & 1);
        const float s = lt_allowed(row, col, S, Tk, causal, window)
                            ? scale * x[nt][e]
                            : LF_NEG_INF;
        x[nt][e] = s;
        if (e & 2)
          mx1 = fmaxf(mx1, s);
        else
          mx0 = fmaxf(mx0, s);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if constexpr (LF_SPLIT > 1) {
      if (tq == 0) {
        Xg[part * LT_BM] = mx0;
        Xg[part * LT_BM + 8] = mx1;
      }
      lf_group_sync(wm);
#pragma unroll
      for (int p = 0; p < LF_SPLIT; ++p) {
        mx0 = fmaxf(mx0, Xg[p * LT_BM]);
        mx1 = fmaxf(mx1, Xg[p * LT_BM + 8]);
      }
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // 3. P = exp(score - m) into E; this thread's share of the row sums
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < SN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(x[nt][e] - ((e & 2) ? mn1 : mn0));
        x[nt][e] = p;
        if (e & 2)
          ps1 += p;
        else
          ps0 += p;
      }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
    lt_store_e<SN / 8>(Eg + part * SN, EW, x);
#pragma unroll
    for (int nt = 0; nt < ON / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= (e & 2) ? c1 : c0;
    lf_group_sync(wm);      // the row group's P is in E

    // 4. O += P V, this warp's ON columns
    lt_out<D, ON>(acc, Eg, Vy + part * ON);
  }

  // the row sums: the quad's lanes (xor 1, then 2), then the group's warps
  // in order
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if constexpr (LF_SPLIT > 1) {
    // every read of the last tile's maxima came before its E barrier
    if (tq == 0) {
      Xg[part * LT_BM] = l0;
      Xg[part * LT_BM + 8] = l1;
    }
    lf_group_sync(wm);
    l0 = Xg[0];
    l1 = Xg[8];
#pragma unroll
    for (int p = 1; p < LF_SPLIT; ++p) {
      l0 += Xg[p * LT_BM];
      l1 += Xg[p * LT_BM + 8];
    }
  }
  if (lse != nullptr && part == 0 && tq == 0) {
    if (r0 < S) lse[(int64_t)bh * S + r0] = m0 + logf(l0);
    if (r1 < S) lse[(int64_t)bh * S + r1] = m1 + logf(l1);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  T* ob = o + bb * sd.o[0] + hh * sd.o[1] + part * ON;
#pragma unroll
  for (int nt = 0; nt < ON / 8; ++nt) {
    const int col = 8 * nt + 2 * tq;
    if (r0 < S) {
      lt_put(ob + r0 * sd.o[2] + col, acc[nt][0] / d0);
      lt_put(ob + r0 * sd.o[2] + col + 1, acc[nt][1] / d0);
    }
    if (r1 < S) {
      lt_put(ob + r1 * sd.o[2] + col, acc[nt][2] / d1);
      lt_put(ob + r1 * sd.o[2] + col + 1, acc[nt][3] / d1);
    }
  }
}

template <int D, typename T>
static int lf_launch(const void* q, const void* k, const void* v, void* o,
                     float* lse, const LfStrides& sd, int B, int H, int KV,
                     int S, int Tk, float scale, int causal, int window,
                     cudaStream_t s) {
  constexpr int smem = lf_smem<D, T>();
  cudaError_t e = cudaFuncSetAttribute(
      local_attn_tf32_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((S + LT_BM - 1) / LT_BM) * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  local_attn_tf32_kernel<D, T><<<(unsigned)blocks, LF_THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, sd, B, H, KV, S, Tk,
      scale, causal, window);
  return (int)cudaGetLastError();
}

// dtype 0 = float32 (D 16, 32, 64, 128 or 256), 1 = bfloat16 (D 16 or 32).
// Strides in elements: (batch, head, row) of q, k, v, then the output's;
// each a multiple of 16 bytes, as every pointer.  lse: null, or (B, H, S)
// f32 dense.
extern "C" int local_attn_tf32_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int S, int Tk, int D, long long sqb, long long sqh, long long sqr,
    long long skb, long long skh, long long skr, long long svb,
    long long svh, long long svr, long long sob, long long soh,
    long long sor, float scale, int causal, int window, int dtype,
    float* lse, void* stream) {
  const long long st[12] = {sqb, sqh, sqr, skb, skh, skr,
                            svb, svh, svr, sob, soh, sor};
  const int el = dtype == 0 ? 4 : 2;
  bool ok = B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && S >= 1 &&
            Tk >= 1 && window >= 0 && (dtype == 0 || dtype == 1);
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) ok = ok && ((uintptr_t)ptrs[i] & 15) == 0;
  for (int i = 0; i < 12; ++i) ok = ok && st[i] > 0 && (st[i] * el) % 16 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const LfStrides sd = {{sqb, sqh, sqr}, {skb, skh, skr}, {svb, svh, svr},
                        {sob, soh, sor}};
  cudaStream_t s = (cudaStream_t)stream;
#define LF_ARGS q, k, v, o, lse, sd, B, H, KV, S, Tk, scale, causal, window, s
  if (dtype == 1) {
    switch (D) {
      case 16:
        return lf_launch<16, __nv_bfloat16>(LF_ARGS);
      case 32:
        return lf_launch<32, __nv_bfloat16>(LF_ARGS);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16:
      return lf_launch<16, float>(LF_ARGS);
    case 32:
      return lf_launch<32, float>(LF_ARGS);
    case 64:
      return lf_launch<64, float>(LF_ARGS);
    case 128:
      return lf_launch<128, float>(LF_ARGS);
    case 256:
      return lf_launch<256, float>(LF_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LF_ARGS
}
