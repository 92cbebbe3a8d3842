// Gradient of the windowed causal / bidirectional flash attention with GQA
// on Hopper's tensor cores in split tf32, for f32 q, k, v, dout at every
// head dim D of 16, 32, 64, 128, 256, and bf16 at D 16 or 32 (the calls
// local_attn_bwd_tc.cu does not take; the wrapper kernels/local_attn/ops.py
// route() chooses).  The function is local_attn_bwd_tc.cu's:
//   P_st = exp(scale q_s . k_t - lse_s) where allowed (t < T, causal:
//   t <= s, window: t > s - window), else 0; lse (B, H, S) f32 is the
//   forward's row log-sum-exp;
//   dP = dout V^T; delta_s = sum_t P_st dP_st; dS = P (dP - delta);
//   dq = scale dS K; dk = scale sum_g dS^T Q; dv = sum_g P^T dout, the sums
//   over the H / KV query heads of a kv head.
// q, dout (B, H, S, D), k, v (B, KV, T, D) dense; dq, dk, dv dense in the
// inputs' dtype.
//
// Replaces the gradient of the Pallas kernel
// src/repro/kernels/local_attn/local_attn.py (flash_tiled -> _flash_kernel),
// which has none: the reference trains through its jnp attention.  The
// plain version is kernels/local_attn/ref.py's local_attention_bwd_ref.
//
// Bound on the H100: operations.  At gemma-2b (H 8, KV 1, D 256), B 2 and
// S 2048 the causal half needs five products of 2 D operations a pair (S,
// dP, dq, dk, dv): 86 GFLOP of useful work, 1.28 ms in f32 on the CUDA
// cores; on the tf32 tensor cores (494 TFLOP/s dense) 1.04 ms for six
// partial products a product, 0.52 ms for three.
//
// Products (local_attn_tf32_common.cuh, shared with the forward,
// local_attn_tf32.cu).  Every product runs on mma.sync m16n8k8 tf32 with f32
// accumulation over a split of both operands done as a fragment is loaded
// from shared memory: LT_PARTS 2 takes hi = tf32(x) and lo = x - hi (read
// by the tensor core cut to tf32) and three partial products (lo hi, hi
// lo, hi hi); LT_PARTS 3 the exact
// three-way split (hi, mid = tf32(x - hi), lo the rest) and six (lo hi, hi
// lo, mid mid, mid hi, hi mid, hi hi).  Each k-step of 8 takes its partial
// products into a fresh accumulator, then one round-to-nearest add into
// the running sum (ssd_common.cuh's scheme).  Two parts: the CPU emulation
// of both schemes (tests/test_torch_attn_bwd_tf32.py) sits within the 2x
// limit of the plain VJP's distance to f64 at gemma-2b's shape and the
// test shapes, and on the card three products run faster than six, each
// output nearer f64 than the plain VJP (tools/bwd_bench.py attn; the
// times are in PERF.md).  bf16 inputs are exact in a tf32 hi part.
//
// P is renormalised.  The forward's f32 lse carries a rounding of up to
// |lse| / 2 ulps, which moves a whole row of exp(scale s - lse) by that
// factor; dS = P (dP - delta) then carries it times delta, and the CPU
// emulation sat 1.8-1.9x the plain VJP's distance from the f64 answer at
// the test shapes from that alone.  So the dq kernel's first pass sums
// each row's P~ = exp(fma(scale, s, -lse)) beside P~ dP, and every pass
// takes P = P~ / sum_t P~ (rinv, a row's reciprocal sum, goes to global
// memory with delta for the dk/dv passes): the softmax itself, as the
// plain version forms it.
//
// Layout: FlashAttention-2's split, no float atomics.  A CTA has 8 warps:
// 4 row groups of 16 kept rows, two warps each, in two roles.  Role 0
// forms S (or S^T) of its rows against a streamed tile and P~ = exp(fma(
// scale, S, -lse)), which it leaves in a shared tile E; role 1 forms dP
// (or dP^T) over the same pairs, reads P~ back and does the rest of the
// elementwise work; the output products are shared out.  So every warp
// holds one score tile of 16 x BN (a split A fragment feeds BN / 8
// n-tiles).  (4 warps a CTA each forming both S and dP, and 8 warps
// splitting the columns, were earlier designs, both slower: PERF.md.)
//   local_attn_bwd_tf32_dq_kernel: one CTA per (64 query rows, head,
//     batch); Q and dO stay in shared memory, K and V tiles of BN keys
//     stream through a cp.async ring.  A first pass over the key tiles
//     forms S and dP and sums P~ and P~ dP per row (role 1: each thread's
//     columns in order, then the quad's four in a fixed tree); a second
//     forms them again, role 1 writes dS over P~ in E, and dq += dS K, each
//     role half of the D columns (16 x D/2 a warp in registers).
//   local_attn_bwd_tf32_dkdv_kernel: one CTA per (64 keys, query head,
//     batch); K and V stay, Q and dO tiles of BN queries stream with their
//     rows' lse, rinv and delta.  Role 0: S^T = K Q^T, P^T into E, dv +=
//     P^T dO; role 1: dP^T = V dO^T, dS^T into a second E, dk += dS^T Q
//     (16 x D a warp).  S^T is formed once for both (the tensor-core
//     route's dv and dk passes form it twice): four products a pair here,
//     five in the dq kernel.  Each writes its query head's f32 partials.
//   local_attn_bwd_fold_kernel (local_attn_bwd.cu): a kv head's dk and dv,
//     the sum of its query heads' partials in head order in f64.
// All run in one C call, dq first (it writes delta and rinv), on one
// stream.  Blocks are numbered longest first.  Tiles wholly above the
// diagonal, left of the window or past S or T are never loaded; rows past
// S or T are zero-filled by cp.async and masked.  Rows of D + 4 floats (D
// + 8 bf16) are 4 banks apart, so the fragment loads that walk a row (A,
// and B of S = X Y^T) hit 32 banks; the B loads of the output products
// (walking down the rows) are 2-way.  BN is 32 at D 256, 64 below; a
// kernel streams through two stages where they fit 227 KB (lt_stages),
// else one (D 256; the dk/dv kernel at D 128).

#include "local_attn_tf32_common.cuh"

#define LT_WARPS 8
#define LT_THREADS (32 * LT_WARPS)

// the dynamic shared memory of a kernel (tests/test_torch_attn_bwd_tf32.py
// mirrors it):
// `kept` 64-row tiles, `stages` x 2 streamed BN-row tiles, `etiles` P / dS
// tiles (64 x (BN + 4) f32) and, with `stats`, the lse, rinv and delta of
// each stage's BN queries
template <int D, typename T>
__host__ __device__ constexpr int lt_smem(int kept, int stages, int etiles,
                                          int stats) {
  return (kept * LT_BM + stages * 2 * LtShape<D>::BN) * (D + LtPad<T>::v) *
             (int)sizeof(T) +
         4 * (etiles * LT_BM * LtShape<D>::EW +
              stats * stages * 3 * LtShape<D>::BN);
}

// cp.async stages: two where they fit the 227 KB a block can take
template <int D, typename T>
__host__ __device__ constexpr int lt_stages(int etiles, int stats) {
  return lt_smem<D, T>(2, 2, etiles, stats) <= 232448 ? 2 : 1;
}

// BN values of a (rows_total,) row statistic from r0 on, zero past the end
template <int BN>
__device__ __forceinline__ void lt_row_stat(float* dst,
                                            const float* __restrict__ src,
                                            int r0, int rows_total) {
  for (int i = threadIdx.x; i < BN; i += LT_THREADS) {
    const bool ok = r0 + i < rows_total;
    ssd_cp<1>(dst + i, ok ? src + r0 + i : src, ok);
  }
}

// The 8 warps of a CTA: row group wm = w % 4 (16 kept rows) and role w / 4.
// Role 0 forms the scores S (of the kept rows and a streamed tile's) and
// P~ = exp(fma(scale, S, -lse)); role 1 forms dP over the same pairs, reads
// P~ from the shared tile E and does the rest of the elementwise work; the
// output products are shared out (see each kernel).  Thread (warp, lane)
// holds rows gq and gq + 8 of its row group and columns 2 tq, 2 tq + 1 of
// every 8-column group of its accumulators.

template <int D, typename T>
__global__ void __launch_bounds__(LT_THREADS, 1)
local_attn_bwd_tf32_dq_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              T* __restrict__ dq, float* __restrict__ delta,
                              float* __restrict__ rinv, int B, int H, int KV,
                              int S, int Tk, float scale, int causal,
                              int window) {
  using Sh = LtShape<D>;
  constexpr int BN = Sh::BN, EW = Sh::EW, ST = lt_stages<D, T>(1, 0);
  constexpr int LD = D + LtPad<T>::v;
  extern __shared__ __align__(16) unsigned char lt_dyn[];
  T* Qs = reinterpret_cast<T*>(lt_dyn);
  T* Os = Qs + LT_BM * LD;
  T* ring = Os + LT_BM * LD;              // stage st: K, then V
  float* Es = reinterpret_cast<float*>(ring + ST * 2 * BN * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, role = warp >> 2, gq = lane >> 2, tq = lane & 3;
  const int nq = (S + LT_BM - 1) / LT_BM;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (nq - 1 - (int)(blockIdx.x / (B * H))) * LT_BM;
  const int bb = bh / H, hh = bh % H, kvh = hh / (H / KV);
  const T* qp = q + (int64_t)bh * S * D;
  const T* op = dout + (int64_t)bh * S * D;
  const T* kp = k + ((int64_t)bb * KV + kvh) * Tk * D;
  const T* vp = v + ((int64_t)bb * KV + kvh) * Tk * D;

  // the key tiles the rows see: [kt_lo, kt_hi)
  int kt_hi = (Tk + BN - 1) / BN;
  if (causal) kt_hi = min(kt_hi, (min(q0 + LT_BM, S) - 1) / BN + 1);
  const int kt_lo =
      (window && q0 - window + 1 > 0) ? (q0 - window + 1) / BN : 0;
  const int ntiles = max(kt_hi - kt_lo, 0);
  const int steps = 2 * ntiles;           // the sums' pass, then dq's

  lt_tile<LT_BM, D, LT_THREADS>(Qs, qp, q0, S);
  lt_tile<LT_BM, D, LT_THREADS>(Os, op, q0, S);
  ssd_commit();
#pragma unroll
  for (int i = 0; i < ST; ++i) {
    if (i < steps) {
      const int r0 = (kt_lo + i % ntiles) * BN;
      lt_tile<BN, D, LT_THREADS>(ring + i * 2 * BN * LD, kp, r0, Tk);
      lt_tile<BN, D, LT_THREADS>(ring + (i * 2 + 1) * BN * LD, vp, r0, Tk);
    }
    ssd_commit();
  }

  const int r0 = q0 + 16 * wm + gq, r1 = r0 + 8;
  const float* lrow = lse + (int64_t)bh * S;
  const float lz0 = r0 < S ? lrow[r0] : 0.0f;
  const float lz1 = r1 < S ? lrow[r1] : 0.0f;
  // role 0: S = Q K^T; role 1: dP = dO V^T
  const T* X = (role ? Os : Qs) + 16 * wm * LD;
  float* Eg = Es + 16 * wm * EW;          // the row group's P~, then dS
  float acc[D / 16][4];                   // dq, columns role D/2 on
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  float ps0 = 0.0f, ps1 = 0.0f, pd0 = 0.0f, pd1 = 0.0f;
  float ri0 = 0.0f, ri1 = 0.0f, dl0 = 0.0f, dl1 = 0.0f;

  for (int i = 0; i < steps; ++i) {
    const int st = i % ST;
    const T* Ky = ring + st * 2 * BN * LD;
    const bool second = i >= ntiles;
    const int k0 = (kt_lo + (second ? i - ntiles : i)) * BN;
    ssd_wait<ST - 1>();
    __syncthreads();

    float x[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nt][e] = 0.0f;
    lt_mm<BN / 8, D / 8, true, LT_PARTS, LD, LD>(x, X, Ky + role * BN * LD);
    if (role == 0) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = (e & 2) ? r1 : r0;
          const int col = k0 + 8 * nt + 2 * tq + (e & 1);
          x[nt][e] = lt_allowed(row, col, S, Tk, causal, window)
                         ? expf(fmaf(scale, x[nt][e], (e & 2) ? -lz1 : -lz0))
                         : 0.0f;
        }
      lt_store_e<BN / 8>(Eg, EW, x);
    }
    __syncthreads();                      // P~ in E
    if (role == 1) {
      float pt[BN / 8][4];
      lt_load_e<BN / 8>(pt, Eg, EW);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!second) {
            if (e & 2) {
              ps1 += pt[nt][e];
              pd1 = fmaf(pt[nt][e], x[nt][e], pd1);
            } else {
              ps0 += pt[nt][e];
              pd0 = fmaf(pt[nt][e], x[nt][e], pd0);
            }
          } else {
            const float p = pt[nt][e] * ((e & 2) ? ri1 : ri0);
            x[nt][e] = p * (x[nt][e] - ((e & 2) ? dl1 : dl0));
          }
        }
      if (i == ntiles - 1) {
        // a row's sums: its quad's four lanes in a fixed tree
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
          ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
          pd0 += __shfl_xor_sync(0xffffffffu, pd0, off);
          pd1 += __shfl_xor_sync(0xffffffffu, pd1, off);
        }
        ri0 = ps0 > 0.0f ? 1.0f / ps0 : 0.0f;
        ri1 = ps1 > 0.0f ? 1.0f / ps1 : 0.0f;
        dl0 = pd0 * ri0;
        dl1 = pd1 * ri1;
      }
      if (second) lt_store_e<BN / 8>(Eg, EW, x);   // dS over P~, in place
    }
    if (second) {
      // dq += dS K, each role half of the columns
      __syncthreads();
      lt_out<D, D / 2>(acc, Eg, Ky + role * (D / 2));
    }

    __syncthreads();   // every warp is done with this stage: refill it
    if (i + ST < steps) {
      const int rn = (kt_lo + (i + ST) % ntiles) * BN;
      lt_tile<BN, D, LT_THREADS>(ring + st * 2 * BN * LD, kp, rn, Tk);
      lt_tile<BN, D, LT_THREADS>(ring + (st * 2 + 1) * BN * LD, vp, rn, Tk);
    }
    ssd_commit();
  }

  // delta and rinv for the dk/dv kernel (0 for a row that sees no key)
  if (role == 1 && tq == 0) {
    if (r0 < S) {
      delta[(int64_t)bh * S + r0] = dl0;
      rinv[(int64_t)bh * S + r0] = ri0;
    }
    if (r1 < S) {
      delta[(int64_t)bh * S + r1] = dl1;
      rinv[(int64_t)bh * S + r1] = ri1;
    }
  }
  T* out = dq + (int64_t)bh * S * D + role * (D / 2);
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    const int col = 8 * nt + 2 * tq;
    if (r0 < S) {
      lt_put(out + (int64_t)r0 * D + col, scale * acc[nt][0]);
      lt_put(out + (int64_t)r0 * D + col + 1, scale * acc[nt][1]);
    }
    if (r1 < S) {
      lt_put(out + (int64_t)r1 * D + col, scale * acc[nt][2]);
      lt_put(out + (int64_t)r1 * D + col + 1, scale * acc[nt][3]);
    }
  }
}

// dv_head += P^T dO (role 0) and dk_head += dS^T Q (role 1, unscaled: the
// fold scales), each query head's (B, H, T, D) f32 partials
template <int D, typename T>
__global__ void __launch_bounds__(LT_THREADS, 1)
local_attn_bwd_tf32_dkdv_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                const float* __restrict__ rinv,
                                float* __restrict__ dk_head,
                                float* __restrict__ dv_head, int B, int H,
                                int KV, int S, int Tk, float scale,
                                int causal, int window) {
  using Sh = LtShape<D>;
  constexpr int BN = Sh::BN, EW = Sh::EW, ST = lt_stages<D, T>(2, 1);
  constexpr int LD = D + LtPad<T>::v;
  extern __shared__ __align__(16) unsigned char lt_dyn[];
  T* Ks = reinterpret_cast<T*>(lt_dyn);
  T* Vs = Ks + LT_BM * LD;
  T* ring = Vs + LT_BM * LD;                    // stage st: Q, then dO
  float* Ep = reinterpret_cast<float*>(ring + ST * 2 * BN * LD);   // P^T
  float* Eds = Ep + LT_BM * EW;                 // dS^T
  float* stats = Eds + LT_BM * EW;              // stage st: lse, rinv, delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, role = warp >> 2, gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x % (B * H);
  const int k0 = (int)(blockIdx.x / (B * H)) * LT_BM;   // first: most tiles
  const int bb = bh / H, hh = bh % H, kvh = hh / (H / KV);
  const T* qp = q + (int64_t)bh * S * D;
  const T* op = dout + (int64_t)bh * S * D;
  const float* lrow = lse + (int64_t)bh * S;
  const float* rrow = rinv + (int64_t)bh * S;
  const float* drow = delta + (int64_t)bh * S;

  // the query tiles that see these keys: [qt_lo, qt_hi)
  const int k_last = min(k0 + LT_BM, Tk) - 1;
  const int qt_lo = causal ? k0 / BN : 0;
  int qt_hi = (S + BN - 1) / BN;
  if (window) qt_hi = min(qt_hi, (k_last + window - 1) / BN + 1);
  const int ntiles = max(qt_hi - qt_lo, 0);

  const int64_t kvoff = ((int64_t)bb * KV + kvh) * Tk * D;
  lt_tile<LT_BM, D, LT_THREADS>(Ks, k + kvoff, k0, Tk);
  lt_tile<LT_BM, D, LT_THREADS>(Vs, v + kvoff, k0, Tk);
  ssd_commit();
  auto load = [&](int i, int st) {
    const int r0 = (qt_lo + i) * BN;
    lt_tile<BN, D, LT_THREADS>(ring + st * 2 * BN * LD, qp, r0, S);
    lt_tile<BN, D, LT_THREADS>(ring + (st * 2 + 1) * BN * LD, op, r0, S);
    float* sx = stats + st * 3 * BN;
    lt_row_stat<BN>(sx, lrow, r0, S);
    lt_row_stat<BN>(sx + BN, rrow, r0, S);
    lt_row_stat<BN>(sx + 2 * BN, drow, r0, S);
  };
#pragma unroll
  for (int i = 0; i < ST; ++i) {
    if (i < ntiles) load(i, i);
    ssd_commit();
  }

  const int r0 = k0 + 16 * wm + gq, r1 = r0 + 8;     // key rows
  // role 0: S^T = K Q^T, then dv += P^T dO; role 1: dP^T = V dO^T, then
  // dk += dS^T Q
  const T* X = (role ? Vs : Ks) + 16 * wm * LD;
  float* Eo = (role ? Eds : Ep) + 16 * wm * EW;   // this role's operand
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % ST;
    const T* Qy = ring + st * 2 * BN * LD;
    const T* Oy = Qy + BN * LD;
    const float* sx = stats + st * 3 * BN;
    const int q0 = (qt_lo + i) * BN;
    ssd_wait<ST - 1>();
    __syncthreads();

    float x[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nt][e] = 0.0f;
    lt_mm<BN / 8, D / 8, true, LT_PARTS, LD, LD>(x, X, role ? Oy : Qy);
    if (role == 0) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = (e & 2) ? r1 : r0;
          const int qc = 8 * nt + 2 * tq + (e & 1);
          const float pt = lt_allowed(q0 + qc, key, S, Tk, causal, window)
                               ? expf(fmaf(scale, x[nt][e], -sx[qc]))
                               : 0.0f;
          x[nt][e] = pt * sx[BN + qc];
        }
      lt_store_e<BN / 8>(Eo, EW, x);
    }
    __syncthreads();                      // P^T in Ep
    if (role == 1) {
      float p[BN / 8][4];
      lt_load_e<BN / 8>(p, Ep + 16 * wm * EW, EW);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * nt + 2 * tq + (e & 1);
          x[nt][e] = p[nt][e] * (x[nt][e] - sx[2 * BN + qc]);
        }
      lt_store_e<BN / 8>(Eo, EW, x);
      __syncwarp();
    }
    lt_out<D, D>(acc, Eo, role ? Qy : Oy);

    __syncthreads();
    if (i + ST < ntiles) load(i + ST, st);
    ssd_commit();
  }

  float* ob = (role ? dk_head : dv_head) + (int64_t)bh * Tk * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = 8 * nt + 2 * tq;
    if (r0 < Tk)
      *reinterpret_cast<float2*>(ob + (int64_t)r0 * D + col) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (r1 < Tk)
      *reinterpret_cast<float2*>(ob + (int64_t)r1 * D + col) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

// local_attn_bwd.cu: dk = scale sum_g dk_head, dv = sum_g dv_head in head
// order in f64, out in dtype (0 f32, 1 bf16)
int local_attn_bwd_fold(const float* dk_head, const float* dv_head, void* dk,
                        void* dv, int64_t total, int g, int64_t head_stride,
                        float scale, int dtype, cudaStream_t s);

template <int D, typename T>
static int lt_launch(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, void* dq, void* dk,
                     void* dv, float* delta, float* rinv, float* heads,
                     int B, int H, int KV, int S, int Tk, float scale,
                     int causal, int window, int dtype, cudaStream_t s) {
  const int smem_dq = lt_smem<D, T>(2, lt_stages<D, T>(1, 0), 1, 0);
  const int smem_kv = lt_smem<D, T>(2, lt_stages<D, T>(2, 1), 2, 1);
  cudaError_t e = cudaFuncSetAttribute(
      local_attn_bwd_tf32_dq_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(local_attn_bwd_tf32_dkdv_kernel<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (e != cudaSuccess) return (int)e;
  const long long bhs = (long long)B * H;
  const long long qblocks = (long long)((S + LT_BM - 1) / LT_BM) * bhs;
  const long long kblocks = (long long)((Tk + LT_BM - 1) / LT_BM) * bhs;
  if (qblocks > 0x7fffffffLL || kblocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  local_attn_bwd_tf32_dq_kernel<D, T>
      <<<(unsigned)qblocks, LT_THREADS, smem_dq, s>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, (T*)dq,
          delta, rinv, B, H, KV, S, Tk, scale, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t per_head = (int64_t)Tk * D;
  float* dk_head = heads;
  float* dv_head = heads + bhs * per_head;
  local_attn_bwd_tf32_dkdv_kernel<D, T>
      <<<(unsigned)kblocks, LT_THREADS, smem_kv, s>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
          rinv, dk_head, dv_head, B, H, KV, S, Tk, scale, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return local_attn_bwd_fold(dk_head, dv_head, dk, dv,
                             (int64_t)B * KV * per_head, H / KV, per_head,
                             scale, dtype, s);
}

// All tensors dense, every pointer 16-byte aligned; dtype 0 = float32 (D
// 16, 32, 64, 128 or 256), 1 = bfloat16 (D 16 or 32).  lse (B, H, S) f32 is
// the forward's; delta and rinv are (B, H, S) f32 scratch, heads 2 B H T D
// floats (each query head's dk, then dv, before the fold).
extern "C" int local_attn_bwd_tf32_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, void* dq, void* dk, void* dv, float* delta,
    float* rinv, float* heads, int B, int H, int KV, int S, int Tk, int D,
    float scale, int causal, int window, int dtype, void* stream) {
  bool ok = B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && S >= 1 &&
            Tk >= 1 && window >= 0 && (dtype == 0 || dtype == 1);
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  for (int i = 0; i < 7; ++i) ok = ok && ((uintptr_t)ptrs[i] & 15) == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LT_ARGS \
  q, k, v, dout, lse, dq, dk, dv, delta, rinv, heads, B, H, KV, S, Tk, \
      scale, causal, window, dtype, s
  if (dtype == 1) {
    switch (D) {
      case 16:
        return lt_launch<16, __nv_bfloat16>(LT_ARGS);
      case 32:
        return lt_launch<32, __nv_bfloat16>(LT_ARGS);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16:
      return lt_launch<16, float>(LT_ARGS);
    case 32:
      return lt_launch<32, float>(LT_ARGS);
    case 64:
      return lt_launch<64, float>(LT_ARGS);
    case 128:
      return lt_launch<128, float>(LT_ARGS);
    case 256:
      return lt_launch<256, float>(LT_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LT_ARGS
}
