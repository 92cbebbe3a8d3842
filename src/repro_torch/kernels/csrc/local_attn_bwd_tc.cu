// Gradient of the windowed causal / bidirectional flash attention with GQA
// on Hopper's tensor cores, for bf16 q, k, v, dout at head_dim D of 64, 128
// or 256 (the forward's tensor-core route, local_attn_tc.cu).  The
// function is local_attn_bwd_tf32.cu's:
//   P_st = exp(scale q_s . k_t - lse_s) where allowed (t < T, causal:
//   t <= s, window: t > s - window), else 0; lse (B, H, S) f32 is the
//   forward's row log-sum-exp;
//   dP = dout V^T; delta_s = sum_t P_st dP_st; dS = P (dP - delta);
//   dq = scale dS K; dk = scale sum_g dS^T Q; dv = sum_g P^T dout, the sums
//   over the H / KV query heads of a kv head.
// q, dout (B, H, S, D) and k, v (B, KV, T, D) are read by their strides
// (last dimension contiguous); dq (B, H, S, D), dk and dv (B, KV, T, D)
// are written dense, bf16.  f32 calls, and bf16 at D 16 or 32, take the
// split-tf32 kernels of local_attn_bwd_tf32.cu; the wrapper
// (kernels/local_attn/ops.py, route()) chooses, as for the forward.
//
// Replaces the gradient of the Pallas kernel
// src/repro/kernels/local_attn/local_attn.py (flash_tiled -> _flash_kernel),
// which has none: the reference trains through its jnp attention.  The
// plain version is kernels/local_attn/ref.py's local_attention_bwd_ref.
//
// Bound on the H100: operations.  At gemma-2b (H 8, KV 1, D 256), B 2 and
// S 2048 the causal half needs five products of 2 D operations a pair (S,
// dP, dq, dk, dv): about 86 GFLOP against 59 MB moved, 0.087 ms at 989
// TFLOP/s bf16.  What the design does about it: every product runs on
// wgmma (sm_90a) from operands that TMA brings into shared memory with the
// 128-byte swizzle (the forward's machinery, local_attn_tc_common.cuh), so
// the CUDA cores only form P and dS; tiles wholly above the diagonal, left
// of the window or past S or T are never loaded.
//
// Numerics.  S = Q K^T and dP = dO V^T take bf16 operands, whose products
// are exact in f32, and accumulate in f32.  P = exp2(scale log2(e) S -
// log2(e) lse) and dS = P (dP - delta) are f32; where they enter a product
// as its A operand they enter as a hi/lo pair, X_hi = bf16(X) and X_lo =
// bf16(X - X_hi): two wgmma into one f32 accumulator, so P and dS carry
// about 16 bits (the forward's "hi/lo split").  delta is not taken from
// the bf16 output (that moves it by the output's rounding, and dS cancels
// against it); nor from an f32 copy of the output, which
// the forward would have to write and autograd keep (33.5 MB a layer at
// gemma-2b's shape).  The dq kernel makes it on the tensor cores: a first
// pass over its key tiles forms S and dP and sums P dP per row in f32
// (each thread's columns in order, then the quad's four in a fixed tree),
// then writes it for the dk kernel; a second pass forms S and dP again and
// runs dq += dS K.  That costs two of the ten products a pair (S and dP
// once more), against the 33.5 MB an f32 output would add a layer.  The
// lo halves stay on every product: the CPU emulation without them
// (tests/test_torch_attn_bwd_tc.py's scheme) came near the 2x limit of
// the f64 witness at short bidirectional rows.
//
// Layout: FlashAttention-2's split, no float atomics.
//   local_attn_bwd_tc_dq_kernel: one CTA of one warpgroup per (64 query
//     rows, head, batch); Q and dO stay in shared memory, K and V tiles of
//     BN keys stream through a two-stage TMA ring; the dq tile 64 x D lives
//     in registers (128 a thread at D 256).
//   local_attn_bwd_tc_dkdv_kernel<D, DK>: one CTA per (64 keys, query
//     head, batch); K (and V) stay, Q and dO tiles of BN queries stream.
//     S^T = K Q^T (and dP^T = V dO^T) put the keys on wgmma's M, so P^T and
//     dS^T are the next product's A fragments straight from the
//     accumulator, and Q and dO are its MN-major B operands.  At D 256 one
//     warpgroup cannot hold both dk and dv (2 x 128 f32 registers a thread,
//     over the 255 limit), so dv and dk are two passes, two launches of the
//     kernel: the dv pass forms S and dv += P^T dO, the dk pass S, dP and
//     dk += dS^T Q.  That recomputes S once more (ten products a pair in
//     all with delta's pass, against five; thirteen wgmma passes with the
//     lo halves of dq, dv and dk), and keeps one warpgroup of simple
//     code where two consumer warpgroups would share S^T and dP^T through
//     shared memory.  D 64 and 128 take the same two passes.  Each writes
//     its query head's partial, f32.
//   local_attn_bwd_fold_kernel (local_attn_bwd.cu): a kv head's dk and dv,
//     the sum of its query heads' partials in head order in f64.
// All run in one C call, dq first (it writes delta), on one stream.  BN is
// 32 at D 256 (the dq and dk passes hold 128 accumulator registers, S and
// dP tiles and the hi/lo fragments) and 64 below.  Blocks are numbered
// longest first: query tile i visits i + 1 key tiles, key tile j is
// visited by the query tiles from j on.  TMA fills rows past S or T with
// zeros; they are masked (keys past T, queries past S) on the tiles that
// cross an edge, and never stored.

#include "local_attn_tc_common.cuh"

template <int D>
struct TbShape {
  static constexpr int BN = D == 256 ? 32 : 64;   // rows of a streamed tile
  static constexpr int PANELS = D / 64;           // 64-column swizzled panels
  static constexpr int MPANEL = TC_BM * 128;      // a panel of the CTA's rows
  static constexpr int NPANEL = BN * 128;         // a panel of a streamed tile
  static constexpr int MBYTES = MPANEL * PANELS;  // one 64-row tile
  static constexpr int NBYTES = NPANEL * PANELS;  // one BN-row tile
  static constexpr int STAGE = 2 * NBYTES;        // two streamed tiles
  static constexpr int RING = TC_STAGES * STAGE;
};

// shared memory of a kernel that keeps `kept` 64-row tiles
__host__ __device__ constexpr int tb_smem(int kept, int mbytes, int ring) {
  return kept * mbytes + ring + 1024;
}

// rows r0 .. r0 + BN - 1 of two maps into one stage, one barrier
template <int D>
__device__ __forceinline__ void tb_load_pair(const CUtensorMap* amap,
                                             const CUtensorMap* bmap,
                                             uint32_t bar, uint32_t dst,
                                             int r0, int head, int bb) {
  using Sh = TbShape<D>;
  tc_mbar_expect_tx(bar, Sh::STAGE);
#pragma unroll
  for (int p = 0; p < Sh::PANELS; ++p) {
    tc_tma_load(dst + p * Sh::NPANEL, amap, bar, 64 * p, r0, head, bb);
    tc_tma_load(dst + Sh::NBYTES + p * Sh::NPANEL, bmap, bar, 64 * p, r0,
                head, bb);
  }
}

// 64 rows of one map (its barrier's bytes are expected by the caller)
template <int D>
__device__ __forceinline__ void tb_load_rows(const CUtensorMap* map,
                                             uint32_t bar, uint32_t dst,
                                             int r0, int head, int bb) {
  using Sh = TbShape<D>;
#pragma unroll
  for (int p = 0; p < Sh::PANELS; ++p)
    tc_tma_load(dst + p * Sh::MPANEL, map, bar, 64 * p, r0, head, bb);
}

// X (64 x N, f32 accumulator) as wgmma's A fragments of k steps of 16,
// hi = bf16(X) and lo = bf16(X - hi): register r of step t holds the pair
// x[8t + 2r], x[8t + 2r + 1]
template <int N>
__device__ __forceinline__ void tb_split(const float (&x)[N / 2],
                                         uint32_t (&hi)[N / 16][4],
                                         uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int t = 0; t < N / 16; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * t + 2 * r], b = x[8 * t + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[t][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[t][r] = tc_pack(a - __low2float(h), b - __high2float(h));
    }
}

// acc (64 x D) += X_hi B + X_lo B, B the streamed tile at `b` read as the
// MN-major operand (N = D, k = its BN rows)
template <int D>
__device__ __forceinline__ void tb_mma_split(float (&acc)[D / 2],
                                             uint32_t (&hi)[TbShape<D>::BN / 16][4],
                                             uint32_t (&lo)[TbShape<D>::BN / 16][4],
                                             uint32_t b) {
  using Sh = TbShape<D>;
  tc_pin(acc);
  tc_wgmma_fence();
#pragma unroll
  for (int t = 0; t < Sh::BN / 16; ++t)
    TcMmaRS<D>::run(acc, hi[t], tc_desc(b + t * 2048, Sh::NPANEL));
#pragma unroll
  for (int t = 0; t < Sh::BN / 16; ++t)
    TcMmaRS<D>::run(acc, lo[t], tc_desc(b + t * 2048, Sh::NPANEL));
  tc_wgmma_commit();
  tc_wgmma_wait_all();
  tc_pin(acc);
#pragma unroll
  for (int t = 0; t < Sh::BN / 16; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      asm volatile("" : "+r"(hi[t][r]), "+r"(lo[t][r])::"memory");
}

// s (64 x BN) = A B^T over D: A the kept 64-row tile at `a`, B the
// streamed BN-row tile at `b`, both K-major
template <int D>
__device__ __forceinline__ void tb_scores(float (&s)[TbShape<D>::BN / 2],
                                          uint32_t a, uint32_t b) {
  using Sh = TbShape<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    TcMmaSS<Sh::BN>::run(
        s, tc_desc(a + (kk >> 2) * Sh::MPANEL + (kk & 3) * 32, 16),
        tc_desc(b + (kk >> 2) * Sh::NPANEL + (kk & 3) * 32, 16), kk > 0);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
local_attn_bwd_tc_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap omap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const float* __restrict__ lse,
                            float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int B, int H,
                            int KV, int S, int T, float scale_log2,
                            float scale, int causal, int window) {
  using Sh = TbShape<D>;
  constexpr int BN = Sh::BN;
  __shared__ __align__(8) uint64_t bars[TC_STAGES + 1];  // stages, then Q/dO
  extern __shared__ uint8_t tb_dyn[];
  const uint32_t qs = (tc_smem_addr(tb_dyn) + 1023u) & ~1023u;
  const uint32_t os = qs + Sh::MBYTES;
  const uint32_t ring = os + Sh::MBYTES;   // stage s: K, then V

  const int tid = threadIdx.x;
  const int nq = (S + TC_BM - 1) / TC_BM;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (nq - 1 - (int)(blockIdx.x / (B * H))) * TC_BM;
  const int bb = bh / H, hh = bh % H, kvh = hh / (H / KV);

  // the key tiles the rows see, as the forward visits them: [kt_lo, kt_hi)
  int kt_hi = (T + BN - 1) / BN;
  if (causal) kt_hi = min(kt_hi, (q0 + TC_BM - 1) / BN + 1);
  const int kt_lo =
      (window && q0 - window + 1 > 0) ? (q0 - window + 1) / BN : 0;
  const int ntiles = max(kt_hi - kt_lo, 0);
  const int steps = 2 * ntiles;           // delta's pass, then dq's

  const uint32_t mbar = tc_smem_addr(&bars[TC_STAGES]);
  if (tid == 0) {
    for (int s = 0; s <= TC_STAGES; ++s)
      tc_mbar_init(tc_smem_addr(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    tc_mbar_expect_tx(mbar, 2 * Sh::MBYTES);
    tb_load_rows<D>(&qmap, mbar, qs, q0, hh, bb);
    tb_load_rows<D>(&omap, mbar, os, q0, hh, bb);
    for (int i = 0; i < TC_STAGES && i < steps; ++i)
      tb_load_pair<D>(&kmap, &vmap, tc_smem_addr(&bars[i]),
                      ring + i * Sh::STAGE, (kt_lo + i % ntiles) * BN, kvh,
                      bb);
  }

  // thread (warp, lane) holds rows r0 and r0 + 8 of every 8-column group
  // of the accumulators, columns cq and cq + 1
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = q0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  const float* lrow = lse + (int64_t)bh * S;
  const float lz0 = r0 < S ? lrow[r0] * TC_LOG2E : 0.0f;
  const float lz1 = r1 < S ? lrow[r1] * TC_LOG2E : 0.0f;
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;
  float sum0 = 0.0f, sum1 = 0.0f, dl0 = 0.0f, dl1 = 0.0f;

  tc_mbar_wait(mbar, 0);
  for (int i = 0; i < steps; ++i) {
    const int st = i % TC_STAGES;
    const uint32_t ks = ring + st * Sh::STAGE, vs = ks + Sh::NBYTES;
    const bool second = i >= ntiles;
    const int k0 = (kt_lo + (second ? i - ntiles : i)) * BN;
    tc_mbar_wait(tc_smem_addr(&bars[st]), (i / TC_STAGES) & 1);

    float s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) s[e] = dp[e] = 0.0f;
    tc_pin(s);
    tc_pin(dp);
    tc_wgmma_fence();
    tb_scores<D>(s, qs, ks);      // S = Q K^T
    tb_scores<D>(dp, os, vs);     // dP = dO V^T
    tc_wgmma_commit();
    tc_wgmma_wait_all();
    tc_pin(s);
    tc_pin(dp);

    const bool edge = (causal && k0 + BN - 1 > q0) ||
                      (window && k0 <= q0 + TC_BM - 1 - window) ||
                      k0 + BN > T;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int qp = (e & 2) ? r1 : r0;
      const int kp = k0 + 8 * (e >> 2) + cq + (e & 1);
      bool ok = true;
      if (edge) {
        ok = kp < T;
        if (causal) ok = ok && kp <= qp;
        if (window) ok = ok && kp > qp - window;
      }
      const float p =
          ok ? exp2f(s[e] * scale_log2 - ((e & 2) ? lz1 : lz0)) : 0.0f;
      if (!second) {
        if (e & 2)
          sum1 = fmaf(p, dp[e], sum1);
        else
          sum0 = fmaf(p, dp[e], sum0);
      } else {
        s[e] = p * (dp[e] - ((e & 2) ? dl1 : dl0));
      }
    }
    if (i == ntiles - 1) {
      // a row's delta: its four lanes' sums in a fixed tree
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
      dl0 = sum0 + __shfl_xor_sync(0xffffffffu, sum0, 2);
      dl1 = sum1 + __shfl_xor_sync(0xffffffffu, sum1, 2);
    }
    if (second) {
      // dq += dS K: K is the MN-major operand
      uint32_t hi[BN / 16][4], lo[BN / 16][4];
      tb_split<BN>(s, hi, lo);
      tb_mma_split<D>(acc, hi, lo, ks);
    }

    __syncthreads();   // every warp is done with this stage: refill it
    if (tid == 0 && i + TC_STAGES < steps)
      tb_load_pair<D>(&kmap, &vmap, tc_smem_addr(&bars[st]), ks,
                      (kt_lo + (i + TC_STAGES) % ntiles) * BN, kvh, bb);
  }

  // delta for the dk kernel (0 for a row that sees no key)
  if ((lane & 3) == 0) {
    float* drow = delta + (int64_t)bh * S;
    if (r0 < S) drow[r0] = dl0;
    if (r1 < S) drow[r1] = dl1;
  }
  __nv_bfloat16* out = dq + (int64_t)bh * S * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + cq;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)r0 * D + col) =
          __floats2bfloat162_rn(scale * acc[4 * j], scale * acc[4 * j + 1]);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)r1 * D + col) =
          __floats2bfloat162_rn(scale * acc[4 * j + 2],
                                scale * acc[4 * j + 3]);
  }
}

// DK false: dv_head += P^T dO; DK true: dk_head += dS^T Q (unscaled; the
// fold scales).  `out` is this pass's (B, H, T, D) f32 partials.
template <int D, bool DK>
__global__ void __launch_bounds__(TC_THREADS, 1)
local_attn_bwd_tc_dkdv_kernel(const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap omap,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ out, int B, int H, int KV,
                              int S, int T, float scale_log2, int causal,
                              int window) {
  using Sh = TbShape<D>;
  constexpr int BN = Sh::BN;
  __shared__ __align__(8) uint64_t bars[TC_STAGES + 1];  // stages, then K/V
  extern __shared__ uint8_t tb_dyn[];
  const uint32_t ks = (tc_smem_addr(tb_dyn) + 1023u) & ~1023u;
  const uint32_t vs = ks + Sh::MBYTES;     // the dk pass only
  const uint32_t ring = ks + (DK ? 2 : 1) * Sh::MBYTES;  // stage: Q, dO

  const int tid = threadIdx.x;
  const int bh = blockIdx.x % (B * H);
  const int k0 = (int)(blockIdx.x / (B * H)) * TC_BM;  // first: most tiles
  const int bb = bh / H, hh = bh % H, kvh = hh / (H / KV);

  // the query tiles that see these keys: [qt_lo, qt_hi)
  const int k_last = min(k0 + TC_BM, T) - 1;
  const int qt_lo = causal ? k0 / BN : 0;
  int qt_hi = (S + BN - 1) / BN;
  if (window) qt_hi = min(qt_hi, (k_last + window - 1) / BN + 1);
  const int ntiles = max(qt_hi - qt_lo, 0);

  const uint32_t mbar = tc_smem_addr(&bars[TC_STAGES]);
  if (tid == 0) {
    for (int s = 0; s <= TC_STAGES; ++s)
      tc_mbar_init(tc_smem_addr(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    tc_mbar_expect_tx(mbar, (DK ? 2 : 1) * Sh::MBYTES);
    tb_load_rows<D>(&kmap, mbar, ks, k0, kvh, bb);
    if (DK) tb_load_rows<D>(&vmap, mbar, vs, k0, kvh, bb);
    for (int i = 0; i < TC_STAGES && i < ntiles; ++i)
      tb_load_pair<D>(&qmap, &omap, tc_smem_addr(&bars[i]),
                      ring + i * Sh::STAGE, (qt_lo + i) * BN, hh, bb);
  }

  // thread (warp, lane) holds key rows r0 and r0 + 8, query columns cq
  // and cq + 1 of every 8-column group
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = k0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  const float* lrow = lse + (int64_t)bh * S;
  const float* drow = delta + (int64_t)bh * S;
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;

  tc_mbar_wait(mbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % TC_STAGES;
    const uint32_t qs = ring + st * Sh::STAGE, os = qs + Sh::NBYTES;
    const int q0 = (qt_lo + i) * BN;
    tc_mbar_wait(tc_smem_addr(&bars[st]), (i / TC_STAGES) & 1);

    float s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) s[e] = dp[e] = 0.0f;
    tc_pin(s);
    if (DK) tc_pin(dp);
    tc_wgmma_fence();
    tb_scores<D>(s, ks, qs);              // S^T = K Q^T
    if (DK) tb_scores<D>(dp, vs, os);     // dP^T = V dO^T
    tc_wgmma_commit();
    tc_wgmma_wait_all();
    tc_pin(s);
    if (DK) tc_pin(dp);

    const bool edge = (causal && k0 + TC_BM - 1 > q0) ||
                      (window && k0 <= q0 + BN - 1 - window) ||
                      k0 + TC_BM > T || q0 + BN > S;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qp = q0 + 8 * j + cq + c;
        const float lz = qp < S ? lrow[qp] * TC_LOG2E : 0.0f;
        const float dl = (DK && qp < S) ? drow[qp] : 0.0f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int e = 4 * j + 2 * hf + c;
          const int kp = hf ? r1 : r0;
          bool ok = true;
          if (edge) {
            ok = kp < T && qp < S;
            if (causal) ok = ok && kp <= qp;
            if (window) ok = ok && kp > qp - window;
          }
          const float p = ok ? exp2f(s[e] * scale_log2 - lz) : 0.0f;
          s[e] = DK ? p * (dp[e] - dl) : p;
        }
      }

    // dv += P^T dO or dk += dS^T Q: dO or Q is the MN-major operand
    uint32_t hi[BN / 16][4], lo[BN / 16][4];
    tb_split<BN>(s, hi, lo);
    tb_mma_split<D>(acc, hi, lo, DK ? qs : os);

    __syncthreads();
    if (tid == 0 && i + TC_STAGES < ntiles)
      tb_load_pair<D>(&qmap, &omap, tc_smem_addr(&bars[st]), qs,
                      (qt_lo + i + TC_STAGES) * BN, hh, bb);
  }

  float* ob = out + (int64_t)bh * T * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + cq;
    if (r0 < T)
      *reinterpret_cast<float2*>(ob + (int64_t)r0 * D + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r1 < T)
      *reinterpret_cast<float2*>(ob + (int64_t)r1 * D + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// local_attn_bwd.cu: dk = scale sum_g dk_head, dv = sum_g dv_head in head
// order in f64, out in dtype (1: bf16)
int local_attn_bwd_fold(const float* dk_head, const float* dv_head, void* dk,
                        void* dv, int64_t total, int g, int64_t head_stride,
                        float scale, int dtype, cudaStream_t s);

template <int D>
static int tb_launch(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, void* dq, void* dk,
                     void* dv, float* delta, float* heads, int B, int H,
                     int KV, int S, int T, const long long* st, float scale,
                     int causal, int window, cudaStream_t stream) {
  using Sh = TbShape<D>;
  // the runtime calls first: they make the device's context current on
  // this thread, which the CUDA driver's map encoding needs (autograd runs
  // the backward on a thread of its own, where nothing has touched the
  // context yet: cuTensorMapEncodeTiled returned CUDA_ERROR_INVALID_CONTEXT
  // there)
  const int smem2 = tb_smem(2, Sh::MBYTES, Sh::RING);
  const int smem1 = tb_smem(1, Sh::MBYTES, Sh::RING);
  cudaError_t e = cudaFuncSetAttribute(
      local_attn_bwd_tc_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(local_attn_bwd_tc_dkdv_kernel<D, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(local_attn_bwd_tc_dkdv_kernel<D, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem1);
  if (e != cudaSuccess) return (int)e;
  // q and dO as the dq kernel's kept 64-row tiles and as the dk/dv
  // kernels' streamed BN-row ones; k and v the other way round
  CUtensorMap q64, o64, kbn, vbn, k64, v64, qbn, obn;
  int err = tc_map(&q64, q, D, S, H, B, st[2], st[1], st[0], TC_BM);
  if (err == 0) err = tc_map(&qbn, q, D, S, H, B, st[2], st[1], st[0], Sh::BN);
  if (err == 0) err = tc_map(&k64, k, D, T, KV, B, st[5], st[4], st[3], TC_BM);
  if (err == 0) err = tc_map(&kbn, k, D, T, KV, B, st[5], st[4], st[3], Sh::BN);
  if (err == 0) err = tc_map(&v64, v, D, T, KV, B, st[8], st[7], st[6], TC_BM);
  if (err == 0) err = tc_map(&vbn, v, D, T, KV, B, st[8], st[7], st[6], Sh::BN);
  if (err == 0)
    err = tc_map(&o64, dout, D, S, H, B, st[11], st[10], st[9], TC_BM);
  if (err == 0)
    err = tc_map(&obn, dout, D, S, H, B, st[11], st[10], st[9], Sh::BN);
  if (err != 0) return err;
  const long long bhs = (long long)B * H;
  const long long qblocks = (long long)((S + TC_BM - 1) / TC_BM) * bhs;
  const long long kblocks = (long long)((T + TC_BM - 1) / TC_BM) * bhs;
  if (qblocks > 0x7fffffffLL || kblocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * TC_LOG2E;
  local_attn_bwd_tc_dq_kernel<D>
      <<<(unsigned)qblocks, TC_THREADS, smem2, stream>>>(
          q64, o64, kbn, vbn, lse, delta, (__nv_bfloat16*)dq, B, H, KV, S,
          T, scale_log2, scale, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t per_head = (int64_t)T * D;
  float* dk_head = heads;
  float* dv_head = heads + bhs * per_head;
  local_attn_bwd_tc_dkdv_kernel<D, false>
      <<<(unsigned)kblocks, TC_THREADS, smem1, stream>>>(
          k64, v64, qbn, obn, lse, delta, dv_head, B, H, KV, S, T,
          scale_log2, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  local_attn_bwd_tc_dkdv_kernel<D, true>
      <<<(unsigned)kblocks, TC_THREADS, smem2, stream>>>(
          k64, v64, qbn, obn, lse, delta, dk_head, B, H, KV, S, T,
          scale_log2, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return local_attn_bwd_fold(dk_head, dv_head, dk, dv,
                             (int64_t)B * KV * per_head, H / KV, per_head,
                             scale, 1, stream);
}

// bf16 only; D must be 64, 128 or 256.  Strides are in elements, (batch,
// head, row) for each of q, k, v and dout, each a positive multiple of 8
// (16 bytes, as TMA needs), with the last dimension contiguous and every
// pointer 16-byte aligned.  lse (B, H, S) f32 is the forward's; dq (B, H,
// S, D), dk and dv (B, KV, T, D) are dense bf16; delta is (B, H, S) f32
// scratch and heads 2 B H T D floats (each query head's dk, then dv,
// before the fold).
extern "C" int local_attn_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, void* dq, void* dk, void* dv, float* delta,
    float* heads, int B, int H, int KV, int S, int T, int D, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh,
    long long kst, long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long oss, float scale, int causal,
    int window, void* stream) {
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kst,
                            vsb, vsh, vst, osb, osh, oss};
  bool ok = B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && S >= 1 && T >= 1 &&
            window >= 0;
  for (int i = 0; i < 12; ++i) ok = ok && st[i] > 0 && st[i] % 8 == 0;
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  for (int i = 0; i < 7; ++i) ok = ok && ((uintptr_t)ptrs[i] & 15) == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return tb_launch<64>(q, k, v, dout, lse, dq, dk, dv, delta, heads, B,
                           H, KV, S, T, st, scale, causal, window, s);
    case 128:
      return tb_launch<128>(q, k, v, dout, lse, dq, dk, dv, delta, heads, B,
                            H, KV, S, T, st, scale, causal, window, s);
    case 256:
      return tb_launch<256>(q, k, v, dout, lse, dq, dk, dv, delta, heads, B,
                            H, KV, S, T, st, scale, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
