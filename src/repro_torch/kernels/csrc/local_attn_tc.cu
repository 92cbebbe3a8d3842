// Windowed causal / bidirectional flash attention with GQA on Hopper's
// tensor cores, for bf16 q, k, v at head_dim D of 64, 128 or 256:
//   q (B, H, S, D), k and v (B, KV, T, D), each by its strides with the
//   last dimension contiguous; o (B, H, S, D) by its strides, bf16;
//   query head hh reads key/value head hh / (H / KV);
//   score = (q . k) * scale, masked to NEG_INF unless k_pos < T and
//   (causal: k_pos <= q_pos) and (window: k_pos > q_pos - window);
//   out = softmax(score) @ v / max(l, 1e-30), by an online softmax over
//   key tiles.
// f32 calls, and bf16 at D 16 or 32, take the split-tf32 kernel in
// local_attn_tf32.cu; the wrapper (kernels/local_attn/ops.py, route())
// chooses.
//
// Replaces the Pallas kernel flash_tiled -> _flash_kernel,
// src/repro/kernels/local_attn/local_attn.py:34-123.
//
// Bound on the H100: operations.  At gemma-2b (H 8, KV 1, D 256), B 2 and
// S 2048 the causal half is 34.4 GFLOP against 37.7 MB moved: 0.0348 ms
// at 989 TFLOP/s bf16 on the tensor cores (the bytes take 0.0113 ms).
// What the design does about it: both products run on the tensor cores
// (wgmma, sm_90a), so the CUDA cores only do the softmax; K and V reach
// shared memory by TMA, so no thread spends instructions on addresses or
// copies; and query tiles wholly past the diagonal or outside the window
// are never loaded.
//
// Numerics.  S = Q Kᵀ takes bf16 operands and accumulates in f32; the
// products of two bf16 values are exact in f32, so S differs from the
// reference's f32 dot only in the order of the sum.  The scale (times
// log2 e, for exp2) multiplies the f32 scores after the product, so Q is
// never rounded again.  P = exp(S - m) is f32; P V runs as two products
// into the same f32 accumulator, P_hi = bf16(P) and P_lo = bf16(P - P_hi),
// so P carries about 16 bits (the "hi/lo split").  The row sum l is taken
// from the f32 P.  NEG_INF is the reference's finite -2^30, and the output
// divides by max(l, 1e-30): a row whose first visited tile is fully masked
// accumulates exp2(0) = 1 weights, which the next tile's correction
// exp2(-2^30 - m) wipes out.
//
// Design.  One block of one warpgroup (128 threads) owns 64 query rows of
// one (b, head): the wgmma tile is 64 rows, and the f32 output tile 64 x D
// lives in registers (D / 2 a thread; 128 at D 256).  Key tiles of BN rows
// (64, or 32 at D 256 so that two blocks fit an SM: 32 KB of Q plus two
// stages of 16 KB K and 16 KB V) are brought in by TMA into a two-stage
// ring with one mbarrier a stage; thread 0 refills a stage as soon as the
// block has finished with it, so the next tile's copy runs under this
// tile's products.  Tiles are 64 columns wide with the 128-byte swizzle,
// which is the layout wgmma reads: Q and K as K-major operands, V as an
// MN-major (transposed) operand, so nothing is transposed in shared
// memory.  P goes from the score accumulator straight into wgmma's A
// registers (the accumulator's layout is the A fragment's).  TMA fills
// rows past S or T with zeros, and the output is stored by rows < S, so
// no input is padded or copied.  Key tiles wholly above the diagonal, left
// of the window or past T are skipped, as the reference skips its blocks.
// The causal half makes query tiles unequal (tile i visits i + 1 key
// tiles), so blocks are numbered longest first.

#include "local_attn_tc_common.cuh"

template <int D>
struct TcShape {
  static constexpr int BN = D == 256 ? 32 : 64;   // key rows a tile
  static constexpr int PANELS = D / 64;           // 64-column swizzled panels
  static constexpr int QPANEL = TC_BM * 128;      // bytes of one Q panel
  static constexpr int KPANEL = BN * 128;         // bytes of one K/V panel
  static constexpr int QBYTES = QPANEL * PANELS;
  static constexpr int KVBYTES = KPANEL * PANELS; // one K (or V) tile
  static constexpr int SMEM = QBYTES + TC_STAGES * 2 * KVBYTES + 1024;
};

template <int D>
__device__ __forceinline__ void tc_load_kv(const CUtensorMap* kmap,
                                           const CUtensorMap* vmap,
                                           uint32_t bar, uint32_t ks, int k0,
                                           int kvh, int bb) {
  using Sh = TcShape<D>;
  tc_mbar_expect_tx(bar, 2 * Sh::KVBYTES);
#pragma unroll
  for (int p = 0; p < Sh::PANELS; ++p) {
    tc_tma_load(ks + p * Sh::KPANEL, kmap, bar, 64 * p, k0, kvh, bb);
    tc_tma_load(ks + Sh::KVBYTES + p * Sh::KPANEL, vmap, bar, 64 * p, k0,
                kvh, bb);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
local_attn_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     __nv_bfloat16* __restrict__ o, int64_t osb, int64_t osh,
                     int64_t oss, float* __restrict__ lse, int B, int H,
                     int KV, int S, int T, float scale_log2, int causal,
                     int window) {
  using Sh = TcShape<D>;
  constexpr int BN = Sh::BN;
  __shared__ __align__(8) uint64_t bars[TC_STAGES + 1];  // stages, then Q
  extern __shared__ uint8_t tc_dyn[];
  // the 128-byte swizzle repeats every 1024 bytes: align every tile to it
  const uint32_t qs = (tc_smem_addr(tc_dyn) + 1023u) & ~1023u;
  const uint32_t kv0 = qs + Sh::QBYTES;   // stage s: K, then V

  const int tid = threadIdx.x;
  const int nq = (S + TC_BM - 1) / TC_BM;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (nq - 1 - (int)(blockIdx.x / (B * H))) * TC_BM;
  const int bb = bh / H, hh = bh % H, kvh = hh / (H / KV);

  // the key tiles this query tile visits: [kt_lo, kt_hi)
  int kt_hi = (T + BN - 1) / BN;
  if (causal) kt_hi = min(kt_hi, (q0 + TC_BM - 1) / BN + 1);
  const int kt_lo =
      (window && q0 - window + 1 > 0) ? (q0 - window + 1) / BN : 0;
  const int ntiles = kt_hi - kt_lo;

  const uint32_t qbar = tc_smem_addr(&bars[TC_STAGES]);
  if (tid == 0) {
    for (int s = 0; s <= TC_STAGES; ++s)
      tc_mbar_init(tc_smem_addr(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    tc_mbar_expect_tx(qbar, Sh::QBYTES);
#pragma unroll
    for (int p = 0; p < Sh::PANELS; ++p)
      tc_tma_load(qs + p * Sh::QPANEL, &qmap, qbar, 64 * p, q0, hh, bb);
    for (int i = 0; i < TC_STAGES && i < ntiles; ++i)
      tc_load_kv<D>(&kmap, &vmap, tc_smem_addr(&bars[i]),
                    kv0 + i * 2 * Sh::KVBYTES, (kt_lo + i) * BN, kvh, bb);
  }

  // thread (warp, lane) holds rows r0 and r0 + 8 of every 8-column group
  // of the accumulators, columns cq and cq + 1
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = q0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;
  float m0 = TC_NEG_INF, m1 = TC_NEG_INF, l0 = 0.0f, l1 = 0.0f;

  tc_mbar_wait(qbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % TC_STAGES;
    const uint32_t ks = kv0 + st * 2 * Sh::KVBYTES, vs = ks + Sh::KVBYTES;
    const int k0 = (kt_lo + i) * BN;
    tc_mbar_wait(tc_smem_addr(&bars[st]), (i / TC_STAGES) & 1);

    // S = Q Kᵀ: D / 16 steps of k 16, four to a 64-column panel
    float s[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) s[e] = 0.0f;
    tc_pin(s);
    tc_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      TcMmaSS<BN>::run(
          s, tc_desc(qs + (kk >> 2) * Sh::QPANEL + (kk & 3) * 32, 16),
          tc_desc(ks + (kk >> 2) * Sh::KPANEL + (kk & 3) * 32, 16), kk > 0);
    tc_wgmma_commit();
    tc_wgmma_wait_all();
    tc_pin(s);

    // online softmax in the log2 domain; only tiles that cross the
    // diagonal, the window's edge or T are masked
    const bool edge = (causal && k0 + BN - 1 > q0) ||
                      (window && k0 <= q0 + TC_BM - 1 - window) ||
                      k0 + BN > T;
    float mx0 = TC_NEG_INF, mx1 = TC_NEG_INF;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      float x = s[e] * scale_log2;
      if (edge) {
        const int qp = (e & 2) ? r1 : r0;
        const int kp = k0 + 8 * (e >> 2) + cq + (e & 1);
        bool ok = kp < T;
        if (causal) ok = ok && kp <= qp;
        if (window) ok = ok && kp > qp - window;
        if (!ok) x = TC_NEG_INF;
      }
      s[e] = x;
      if (e & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const float p = exp2f(s[e] - ((e & 2) ? mn1 : mn0));
      s[e] = p;
      if (e & 2)
        ps1 += p;
      else
        ps0 += p;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= (e & 2) ? c1 : c0;

    // P as wgmma's A fragments, k step t = keys 16t..16t+15: register r
    // holds the pair s[8t + 2r], s[8t + 2r + 1]; hi and lo halves
    uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
    for (int t = 0; t < BN / 16; ++t) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[8 * t + 2 * r], b = s[8 * t + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
        ph[t][r] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[t][r] = tc_pack(a - __low2float(hi), b - __high2float(hi));
      }
    }

    // O += P_hi V + P_lo V: V is the MN-major operand, its 64-column
    // panels KPANEL bytes apart, 16 keys = 2048 bytes a k step
    tc_pin(acc);
    tc_wgmma_fence();
#pragma unroll
    for (int t = 0; t < BN / 16; ++t)
      TcMmaRS<D>::run(acc, ph[t], tc_desc(vs + t * 2048, Sh::KPANEL));
#pragma unroll
    for (int t = 0; t < BN / 16; ++t)
      TcMmaRS<D>::run(acc, pl[t], tc_desc(vs + t * 2048, Sh::KPANEL));
    tc_wgmma_commit();
    tc_wgmma_wait_all();
    tc_pin(acc);
#pragma unroll
    for (int t = 0; t < BN / 16; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        asm volatile("" : "+r"(ph[t][r]), "+r"(pl[t][r])::"memory");

    __syncthreads();   // every warp is done with this stage: refill it
    if (tid == 0 && i + TC_STAGES < ntiles)
      tc_load_kv<D>(&kmap, &vmap, tc_smem_addr(&bars[st]), ks,
                    (kt_lo + i + TC_STAGES) * BN, kvh, bb);
  }

  // the rows' log-sum-exp of the scaled scores, for the backward
  // (local_attn_bwd_tc.cu); a quad's four lanes hold the same m and l
  if (lse != nullptr && (lane & 3) == 0) {
    float* lrow = lse + ((int64_t)bb * H + hh) * S;
    if (r0 < S) lrow[r0] = (m0 + log2f(l0)) * TC_LN2;
    if (r1 < S) lrow[r1] = (m1 + log2f(l1)) * TC_LN2;
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + (int64_t)bb * osb + (int64_t)hh * osh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + cq;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)r0 * oss + col) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)r1 * oss + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

template <int D>
static int tc_launch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int H, int KV, int S, int T,
                     const long long* st, float scale, int causal, int window,
                     cudaStream_t stream) {
  using Sh = TcShape<D>;
  CUtensorMap qm, km, vm;
  int err = tc_map(&qm, q, D, S, H, B, st[2], st[1], st[0], TC_BM);
  if (err == 0) err = tc_map(&km, k, D, T, KV, B, st[5], st[4], st[3], Sh::BN);
  if (err == 0) err = tc_map(&vm, v, D, T, KV, B, st[8], st[7], st[6], Sh::BN);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      local_attn_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((S + TC_BM - 1) / TC_BM) * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  local_attn_tc_kernel<D><<<(unsigned)blocks, TC_THREADS, Sh::SMEM, stream>>>(
      qm, km, vm, (__nv_bfloat16*)o, st[9], st[10], st[11], lse, B, H, KV,
      S, T, scale * TC_LOG2E, causal, window);
  return (int)cudaGetLastError();
}

// bf16 only; D must be 64, 128 or 256.  Strides are in elements, (batch,
// head, row) for each of q, k, v and o, each a positive multiple of 8 (16
// bytes, as TMA needs), with the last dimension contiguous and every
// pointer 16-byte aligned.  lse: null, or (B, H, S) f32 for each row's
// log-sum-exp of the scaled scores (the backward's softmax statistics).
extern "C" int local_attn_tc_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int S, int T, int D, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, long long osb, long long osh,
    long long oss, float scale, int causal, int window, float* lse,
    void* stream) {
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kst,
                            vsb, vsh, vst, osb, osh, oss};
  bool ok = B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && S >= 1 && T >= 1 &&
            window >= 0;
  for (int i = 0; i < 12; ++i) ok = ok && st[i] > 0 && st[i] % 8 == 0;
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) ok = ok && ((uintptr_t)ptrs[i] & 15) == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return tc_launch<64>(q, k, v, o, lse, B, H, KV, S, T, st, scale,
                           causal, window, s);
    case 128:
      return tc_launch<128>(q, k, v, o, lse, B, H, KV, S, T, st, scale,
                            causal, window, s);
    case 256:
      return tc_launch<256>(q, k, v, o, lse, B, H, KV, S, T, st, scale,
                            causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
