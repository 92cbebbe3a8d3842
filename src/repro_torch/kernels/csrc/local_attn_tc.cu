// Windowed causal / bidirectional flash attention with GQA on Hopper's
// tensor cores, for bf16 q, k, v at head_dim D of 64, 128 or 256:
//   q (B, H, S, D), k and v (B, KV, T, D), each by its strides with the
//   last dimension contiguous; o (B, H, S, D) by its strides, bf16;
//   query head hh reads key/value head hh / (H / KV);
//   score = (q . k) * scale, masked to NEG_INF unless k_pos < T and
//   (causal: k_pos <= q_pos) and (window: k_pos > q_pos - window);
//   out = softmax(score) @ v / max(l, 1e-30), by an online softmax over
//   key tiles.
// f32 calls, and bf16 at D 16 or 32, take the CUDA-core kernel in
// local_attn.cu; the wrapper (kernels/local_attn/ops.py, route()) chooses.
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TC_THREADS 128
#define TC_BM 64
#define TC_STAGES 2
#define TC_NEG_INF (-1073741824.0f)
#define TC_LOG2E 1.4426950408889634f
#define TC_LN2 0.6931471805599453f

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

__device__ __forceinline__ uint32_t tc_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void tc_mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void tc_mbar_expect_tx(uint32_t bar,
                                                  uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tc_mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of 64 columns x rows of a 4-d tensor map into shared memory
__device__ __forceinline__ void tc_tma_load(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (the stride between 64-column panels of an
// MN-major operand; unused for K-major), stride byte offset 1024 (the
// next 8 rows), layout 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t tc_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void tc_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void tc_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void tc_wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product
template <int N>
__device__ __forceinline__ void tc_pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t tc_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x N) = or += A (shared, K-major) B (shared, K-major), k 16
template <int N>
struct TcMmaSS;
// O (64 x N) += A (registers) B (shared, MN-major), k 16
template <int N>
struct TcMmaRS;

template <>
struct TcMmaSS<32> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct TcMmaSS<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct TcMmaRS<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct TcMmaRS<128> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct TcMmaRS<256> {
  __device__ __forceinline__ static void run(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
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
  // (local_attn_bwd.cu); a quad's four lanes hold the same m and l
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

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so that the library needs no link against libcuda
typedef CUresult (*TcEncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                               void*, const cuuint64_t*, const cuuint64_t*,
                               const cuuint32_t*, const cuuint32_t*,
                               CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion,
                               CUtensorMapFloatOOBfill);

static TcEncodeFn tc_encode() {
  static TcEncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (TcEncodeFn)p;
  }
  return fn;
}

// a 4-d map (D, rows, heads, batch) of bf16 with the given element strides
// of rows, heads and batch; boxes of 64 columns x box_rows, 128-byte swizzle,
// out-of-bounds rows read as zeros
static int tc_map(CUtensorMap* map, const void* ptr, int D, int rows,
                  int heads, int batch, long long s_row, long long s_head,
                  long long s_batch, int box_rows) {
  const TcEncodeFn encode = tc_encode();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
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
