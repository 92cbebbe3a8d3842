// The solar forecaster's LSTM over a whole sequence in one launch: a forward
// scan and the reverse scan of its backward.
//
// Replaces the per-step use of the Pallas kernel
// src/repro/kernels/lstm_cell/lstm_cell.py (lstm_step_tiled ->
// _lstm_kernel), which the reference's model runs under lax.scan
// (src/repro/models/lstm.py lstm_scan); the JAX package differentiates its
// jnp cell, so the backward has no TPU kernel and is new here.
//
// Bound on the H100: neither bytes nor operations but the recurrence.  At
// B 8, T 672, I 10, H 128 the forward does 2*T*B*(I+H)*4H = 0.76 GFLOP
// (11 us on the CUDA cores) and moves ~17 MB with the saved activations
// (5 us), yet step t needs h_{t-1}: T steps run one after another, and each
// costs a chain of I+H dependent FMAs per gate column, the exchange of h
// between blocks and a wait for it.  The step kernel paid a launch per step
// (768 a forecaster forward) and the backward ~20 PyTorch ops per step.
//
// Design: a thread-block cluster of cs CTAs (8 at H 128) runs all T steps.
// CTA r owns hidden columns [r*H/cs, (r+1)*H/cs) of all four gates and
// keeps its slice of Wh (H x 4H/cs f32, 32 KB at H 128; the whole of Wh is
// 256 KB, more than the 227 KB a block may use) and of Wx in shared memory,
// loaded once.  Clusters tile the batch, at most SEQ_MAX_TILE rows each.
//
// Forward step t: thread (column j, R batch rows; R = 1 where the threads
// fit a block) sums the four gates of column j in registers, in
// lstm_cell.cu's order (k = 0..I-1 over x, then 0..H-1 over h, f32 FMAs
// from 0; the shared-memory loads of 8 k are issued before their FMAs),
// applies lstm_common.cuh's gate arithmetic, keeps c in registers,
// and sends h' into the next h buffer of every other CTA of the cluster with
// st.async, which completes its bytes on that CTA's mbarrier (its own CTA's
// buffer takes plain stores and a __syncthreads).  A CTA waits
// on its own mbarrier for the next step: a one-way signal instead of a
// cluster barrier's round trip.  The h buffer is double-buffered; no CTA can
// overwrite a buffer another still reads, since writing step t+1's h needs
// every CTA's step-t h, which each CTA sends only after it read the buffer.
// x_t is copied into a ring in shared memory by cp.async three steps
// ahead.  The result equals the chained step kernel bit for bit.
//
// Backward step t (t = T-1..0), the formulas of LSTMCellFn.backward:
//   dc_t = dc + dh * o * (1 - tanh(c_t)^2)
//   da_i = dc_t g i(1-i)   da_f = dc_t c_{t-1} f(1-f)
//   da_g = dc_t i (1-g^2)  da_o = dh tanh(c_t) o(1-o)
//   dc_{t-1} = dc_t f      dh_{t-1} = da_t Wh^T (+ dys[t-1])
// with a sigmoid's slope rounded as (1 - s) * s, as autograd's sigmoid
// backward does: s - s*s cancels where a gate saturates near 1.
// Each CTA forms da for its columns, then its partial of da_t Wh^T over its
// own 4H/cs gate columns for every k (Wh^T's slice in shared memory), and
// sends each partial to the CTA that owns k by st.async on the owner's
// mbarrier.  The owner adds the cs partials in rank order: no atomics, the
// same answer on every run.  The weight gradients are three large products
// over the T*B axis, left to torch.matmul (as the reference leaves them to
// XLA).
//
// Saved for the backward (forward outputs, skipped when null): the c
// sequence (T, B, H) and the gate activations i, f, g, o (T, B, 4H); with
// ys (T, B, H) that is 24 bytes per hidden unit per row and step, 16.5 MB
// at B 8, T 672, H 128.  Recomputing the gates instead would cost a second
// pass of the recurrence's products inside the reverse scan.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

#define SEQ_MAX_TILE 8      // batch rows per cluster
#define SEQ_MAX_THREADS 256
#define SEQ_MAX_SMEM 232448 // 227 KB, the most a block may use
#define SEQ_XRING 4         // x_t buffers: cp.async runs 3 steps ahead
#define SEQ_BWD_ROWS 2      // batch rows per thread in the backward

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* smem_dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem_dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest n groups of this thread's copies have landed
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// this CTA's arrival for the phase, and the bytes the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of the given parity completes; acquire at cluster scope,
// so the other CTAs' st.async data is visible after it
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the shared::cluster address of a local shared address in CTA `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// stores into another CTA's shared memory that complete their bytes on
// that CTA's mbarrier
__device__ __forceinline__ void st_async(uint32_t dst, float a, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "f"(a), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t dst, float a, float b,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t dst, float4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// acc[e] += v * w.e in the step kernel's argument order
__device__ __forceinline__ void fma4(float* acc, float v, float4 w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

// R consecutive batch rows of one k from a [k][tile_pad] buffer
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float* v) {
  if constexpr (R == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// acc[q][g] += sum_k v[k][q] * w[k].g for k = 0..n-1 in order.  The k
// run in chunks of SEQ_CHUNK: a chunk's loads are all issued before its
// FMAs, so one wait on shared memory's latency serves SEQ_CHUNK k (one
// thread's chain of FMAs is what bounds a step, not the loads' bandwidth).
#define SEQ_CHUNK 8
template <int R>
__device__ __forceinline__ void dot_rows(const float4* __restrict__ w,
                                         int wstride,
                                         const float* __restrict__ v,
                                         int vstride, int n,
                                         float (&acc)[R][4]) {
  int k = 0;
#pragma unroll 2
  for (; k + SEQ_CHUNK <= n; k += SEQ_CHUNK) {
    float4 wk[SEQ_CHUNK];
    float vk[SEQ_CHUNK][R];
#pragma unroll
    for (int u = 0; u < SEQ_CHUNK; ++u) {
      wk[u] = w[(k + u) * wstride];
      load_rows<R>(v + (k + u) * vstride, vk[u]);
    }
#pragma unroll
    for (int u = 0; u < SEQ_CHUNK; ++u) {
#pragma unroll
      for (int q = 0; q < R; ++q) fma4(acc[q], vk[u][q], wk[u]);
    }
  }
  for (; k < n; ++k) {
    const float4 wk = w[k * wstride];
    float vk[R];
    load_rows<R>(v + k * vstride, vk);
#pragma unroll
    for (int q = 0; q < R; ++q) fma4(acc[q], vk[q], wk);
  }
}

template <int R>
__global__ void __launch_bounds__(SEQ_MAX_THREADS)
    lstm_seq_fwd_kernel(const float* __restrict__ xs,
                        const float* __restrict__ h0,
                        const float* __restrict__ c0,
                        const float* __restrict__ wx,
                        const float* __restrict__ wh,
                        const float* __restrict__ b, int T, int B, int I,
                        int H, int tile, int tile_pad, float* __restrict__ ys,
                        float* __restrict__ cseq, float* __restrict__ gates,
                        float* __restrict__ hT, float* __restrict__ cT) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cols = H / cs;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int row0 = blockIdx.y * tile;
  const int rows = min(tile, B - row0);
  const int64_t G = 4 * (int64_t)H;

  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);   // [2]: h buffers
  float4* whs = smem4 + 1;                          // [H][cols] (i, f, g, o)
  float4* wxs = whs + (size_t)H * cols;             // [I][cols]
  float* hbuf = reinterpret_cast<float*>(wxs + (size_t)I * cols);
  float* xbuf = hbuf + 2 * (size_t)H * tile_pad;    // [SEQ_XRING][k][tile_pad]
  const size_t xslot = (size_t)I * tile_pad;        // hbuf is [2][k][tile_pad]

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < H * cols; e += nt) {
    const float* w = wh + (e / cols) * G + rank * cols + e % cols;
    whs[e] = make_float4(w[0], w[H], w[2 * H], w[3 * H]);
  }
  for (int e = tid; e < I * cols; e += nt) {
    const float* w = wx + (e / cols) * G + rank * cols + e % cols;
    wxs[e] = make_float4(w[0], w[H], w[2 * H], w[3 * H]);
  }
  // padding rows hold zeros: they never mix with real rows
  for (int e = tid; e < H * tile_pad; e += nt) {
    const int k = e / tile_pad, r = e % tile_pad;
    hbuf[e] = r < rows ? h0[(int64_t)(row0 + r) * H + k] : 0.0f;
    hbuf[(size_t)H * tile_pad + e] = 0.0f;
  }
  // x of steps 0..SEQ_XRING-2 now; the ring's later copies fill real rows
  for (int e = tid; e < SEQ_XRING * I * tile_pad; e += nt) {
    const int st = e / (I * tile_pad), k = (e / tile_pad) % I,
              r = e % tile_pad;
    xbuf[e] = (st < SEQ_XRING - 1 && st < T && r < rows)
                  ? xs[((int64_t)st * B + row0 + r) * I + k]
                  : 0.0f;
  }
  const int j = tid % cols, r0 = (tid / cols) * R;
  const int jg = rank * cols + j;
  const float bi = b[jg], bf = b[H + jg], bg = b[2 * H + jg],
              bo = b[3 * H + jg];
  float c[R], h[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const bool ok = r0 + q < rows;
    const int64_t at = (int64_t)(row0 + r0 + q) * H + jg;
    c[q] = ok ? c0[at] : 0.0f;
    h[q] = ok ? h0[at] : 0.0f;
  }
  const uint32_t hbuf_u32 = smem_u32(hbuf), bar_u32 = smem_u32(bar);
  // the other CTAs' columns; this CTA writes its own with plain stores
  const uint32_t hbytes = (uint32_t)((H - cols) * tile_pad * sizeof(float));
  cluster.sync();   // every CTA's buffers and barriers are ready

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (t > 0) mbar_wait(&bar[cur], ((t - 1) >> 1) & 1);
    if (tid == 0 && t + 1 < T) mbar_expect_tx(&bar[cur ^ 1], hbytes);
    {   // x of step t + SEQ_XRING - 1 into the slot step t - 1 read
      const int ts = t + SEQ_XRING - 1;
      if (ts < T) {
        float* xn = xbuf + (size_t)(ts % SEQ_XRING) * xslot;
        const float* src = xs + ((int64_t)ts * B + row0) * I;
        for (int e = tid; e < rows * I; e += nt) {
          cp_async4(xn + (e % I) * tile_pad + e / I, src + e);
        }
      }
      cp_async_commit();   // one group a step, empty or not
    }
    const float* xb = xbuf + (size_t)(t % SEQ_XRING) * xslot;
    const float* hb = hbuf + (size_t)cur * H * tile_pad;
    float acc[R][4] = {};
    dot_rows<R>(wxs + j, cols, xb + r0, tile_pad, I, acc);
    dot_rows<R>(whs + j, cols, hb + r0, tile_pad, H, acc);
    LstmAct a[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      a[q] = lstm_apply(acc[q][0], acc[q][1], acc[q][2], acc[q][3], bi, bf,
                        bg, bo, c[q]);
      c[q] = a[q].c;
      h[q] = a[q].h;
    }
    if (t + 1 < T) {   // h' into the next buffer of every CTA
      const int at = ((cur ^ 1) * H + jg) * tile_pad + r0;
#pragma unroll
      for (int q = 0; q < R; ++q) hbuf[at + q] = h[q];
      const uint32_t off = (uint32_t)(at * sizeof(float));
      const uint32_t nbar = bar_u32 + (cur ^ 1) * (uint32_t)sizeof(uint64_t);
      for (int r = 1; r < cs; ++r) {
        const uint32_t dst = (rank + r) % cs;
        if constexpr (R == 2) {
          st_async(mapa(hbuf_u32 + off, dst), h[0], h[1], mapa(nbar, dst));
        } else {
          st_async(mapa(hbuf_u32 + off, dst), h[0], mapa(nbar, dst));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (r0 + q < rows) {
        const int64_t o = (int64_t)t * B + row0 + r0 + q;
        if (ys) ys[o * H + jg] = a[q].h;
        if (cseq) cseq[o * H + jg] = a[q].c;
        if (gates) {
          float* gp = gates + o * G + jg;
          gp[0] = a[q].i;
          gp[H] = a[q].f;
          gp[2 * H] = a[q].g;
          gp[3 * H] = a[q].o;
        }
      }
    }
    cp_async_wait<SEQ_XRING - 2>();   // step t + 1's x has landed
    __syncthreads();   // and this CTA's own h' columns are written
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (r0 + q < rows) {
      const int64_t at = (int64_t)(row0 + r0 + q) * H + jg;
      hT[at] = h[q];
      cT[at] = c[q];
    }
  }
  cluster.sync();   // no CTA leaves while another may address its memory
}

__global__ void __launch_bounds__(SEQ_MAX_THREADS)
    lstm_seq_bwd_kernel(const float* __restrict__ dys,
                        const float* __restrict__ dhT,
                        const float* __restrict__ dcT,
                        const float* __restrict__ gates,
                        const float* __restrict__ cseq,
                        const float* __restrict__ c0,
                        const float* __restrict__ wh, int T, int B, int H,
                        int tile, int tile_pad, float* __restrict__ da,
                        float* __restrict__ dh0, float* __restrict__ dc0) {
  constexpr int R = SEQ_BWD_ROWS;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cols = H / cs;
  const int KQ = H / 4, NL = 4 * cols;   // k quads; this CTA's gate columns
  const int tid = threadIdx.x, nt = blockDim.x;
  const int row0 = blockIdx.y * tile;
  const int rows = min(tile, B - row0);
  const int64_t G = 4 * (int64_t)H;

  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);   // [2]: recv buffers
  float4* wts = smem4 + 1;   // [NL][KQ]: Wh[4kq..4kq+3][n] of local column n
  float* das = reinterpret_cast<float*>(wts + (size_t)NL * KQ);  // [NL][tp]
  float* recv = das + (size_t)NL * tile_pad;     // [2][cs][tile_pad][cols]
  const size_t part = (size_t)tile_pad * cols;   // one sender's partials

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < NL * KQ; e += nt) {
    const int nl = e / KQ, kq = e % KQ;
    const float* w = wh + (int64_t)(4 * kq) * G + (nl / cols) * H
                     + rank * cols + nl % cols;
    wts[e] = make_float4(w[0], w[G], w[2 * G], w[3 * G]);
  }
  // phase A, the cell's backward: thread (column j, R rows), the first
  // cols * tile_pad / R threads; phase B, the partial products: every thread
  const bool cell = tid < cols * (tile_pad / R);
  const int j = tid % cols, r0 = (tid / cols) * R;
  const int jg = rank * cols + j;
  float dh[R], dc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const bool ok = cell && r0 + q < rows;
    const int64_t at = (int64_t)(row0 + r0 + q) * H + jg;
    dh[q] = ok ? dhT[at] : 0.0f;
    dc[q] = ok ? dcT[at] : 0.0f;
  }
  // step t's saved values, loaded one step ahead of their use
  float pg[R][4], pc[R], pp[R], py[R];
#define SEQ_FETCH(t)                                                     \
  _Pragma("unroll") for (int q = 0; q < R; ++q) {                        \
    const bool ok = cell && r0 + q < rows;                                \
    const int64_t o = (int64_t)(t) * B + row0 + r0 + q;                  \
    const float* gp = gates + o * G + jg;                                 \
    pg[q][0] = ok ? gp[0] : 0.0f;                                         \
    pg[q][1] = ok ? gp[H] : 0.0f;                                         \
    pg[q][2] = ok ? gp[2 * H] : 0.0f;                                     \
    pg[q][3] = ok ? gp[3 * H] : 0.0f;                                     \
    pc[q] = ok ? cseq[o * H + jg] : 0.0f;                                 \
    pp[q] = !ok ? 0.0f                                                    \
            : (t) > 0 ? cseq[(o - B) * H + jg]                            \
                      : c0[(int64_t)(row0 + r0 + q) * H + jg];            \
    py[q] = (ok && dys) ? dys[o * H + jg] : 0.0f;                         \
  }
  if (T > 0) { SEQ_FETCH(T - 1) }
  const uint32_t recv_u32 = smem_u32(recv), bar_u32 = smem_u32(bar);
  // the other CTAs' partials; this CTA writes its own with plain stores
  const uint32_t pbytes = (uint32_t)((cs - 1) * part * sizeof(float));
  cluster.sync();   // every CTA's buffers and barriers are ready

  for (int t = T - 1; t >= 0; --t) {
    const int u = T - 1 - t;   // the loop's step count
    if (tid == 0) mbar_expect_tx(&bar[t & 1], pbytes);   // step t's partials
    float g4[R][4], ct[R], cp[R], dy[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      g4[q][0] = pg[q][0];
      g4[q][1] = pg[q][1];
      g4[q][2] = pg[q][2];
      g4[q][3] = pg[q][3];
      ct[q] = pc[q];
      cp[q] = pp[q];
      dy[q] = py[q];
    }
    if (t > 0) { SEQ_FETCH(t - 1) }
    if (u > 0) {   // dh_t: the partials of step t + 1, in rank order
      mbar_wait(&bar[(t + 1) & 1], ((u - 1) >> 1) & 1);
      const float* rv = recv + (size_t)((t + 1) & 1) * cs * part;
#pragma unroll
      for (int q = 0; q < R && cell; ++q) {
        float s = rv[(r0 + q) * cols + j];
        for (int src = 1; src < cs; ++src) s += rv[src * part + (r0 + q) * cols + j];
        dh[q] = s;
      }
    }
    float dav[R][4];
    if (cell) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float dht = dys ? dh[q] + dy[q] : dh[q];
        const float i = g4[q][0], f = g4[q][1], g = g4[q][2], o = g4[q][3];
        const float tc = tanhf(ct[q]);
        const float dct = dc[q] + (dht * o) * (1.0f - tc * tc);
        dav[q][0] = (dct * g) * ((1.0f - i) * i);
        dav[q][1] = (dct * cp[q]) * ((1.0f - f) * f);
        dav[q][2] = (dct * i) * (1.0f - g * g);
        dav[q][3] = (dht * tc) * ((1.0f - o) * o);
        dc[q] = dct * f;
        float* ds = das + (size_t)j * tile_pad + r0 + q;
        ds[0] = dav[q][0];
        ds[(size_t)cols * tile_pad] = dav[q][1];
        ds[(size_t)2 * cols * tile_pad] = dav[q][2];
        ds[(size_t)3 * cols * tile_pad] = dav[q][3];
      }
    }
    __syncthreads();
    // this CTA's partial of da_t Wh^T for every k, sent to k's owner
    for (int it = tid; it < KQ * (tile_pad / R); it += nt) {
      const int kq = it % KQ, rr = (it / KQ) * R;
      float p[R][4] = {};
      dot_rows<R>(wts + kq, KQ, das + rr, tile_pad, NL, p);
      const int owner = (4 * kq) / cols, kl = 4 * kq - owner * cols;
      const size_t at = ((t & 1) * cs + rank) * part + rr * cols + kl;
      if (owner == rank) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          *reinterpret_cast<float4*>(recv + at + q * cols) =
              make_float4(p[q][0], p[q][1], p[q][2], p[q][3]);
        }
      } else {
        const uint32_t dst =
            mapa(recv_u32 + (uint32_t)(at * sizeof(float)), owner);
        const uint32_t obar =
            mapa(bar_u32 + (t & 1) * (uint32_t)sizeof(uint64_t), owner);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          st_async(dst + (uint32_t)(q * cols * sizeof(float)),
                   make_float4(p[q][0], p[q][1], p[q][2], p[q][3]), obar);
        }
      }
    }
    __syncthreads();   // das is free, and this CTA's own partials written
    if (cell) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (r0 + q < rows) {
          float* dp = da + ((int64_t)t * B + row0 + r0 + q) * G + jg;
          dp[0] = dav[q][0];
          dp[H] = dav[q][1];
          dp[2 * H] = dav[q][2];
          dp[3 * H] = dav[q][3];
        }
      }
    }
  }
  if (T > 0) {   // dh_{-1}: the partials of step 0 (buffer 0)
    mbar_wait(&bar[0], ((T - 1) >> 1) & 1);
#pragma unroll
    for (int q = 0; q < R && cell; ++q) {
      float s = recv[(r0 + q) * cols + j];
      for (int src = 1; src < cs; ++src) s += recv[src * part + (r0 + q) * cols + j];
      dh[q] = s;
    }
  }
  if (cell) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (r0 + q < rows) {
        const int64_t at = (int64_t)(row0 + r0 + q) * H + jg;
        dh0[at] = dh[q];
        dc0[at] = dc[q];
      }
    }
  }
  cluster.sync();   // no CTA leaves while another may address its memory
#undef SEQ_FETCH
}

// Threads of the forward (one batch row a thread where they fit a block,
// else two) and of the backward; returns 1 where the shape is refused.
static int seq_threads(int H, int cluster, int tile, int* tile_pad,
                       int* fwd_rows, int* fwd_threads, int* bwd_threads) {
  if (H < 4 || tile < 1 || tile > SEQ_MAX_TILE) return 1;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) return 1;
  if (H % (4 * cluster) != 0) return 1;
  const int cols = H / cluster;
  *tile_pad = tile + (tile & 1);
  *fwd_rows = cols * *tile_pad <= SEQ_MAX_THREADS ? 1 : 2;
  *fwd_threads = cols * *tile_pad / *fwd_rows;
  // every cell thread of phase A, and as many of phase B's items as fit
  const int pairs = *tile_pad / SEQ_BWD_ROWS;
  const int quads = (H / 4) * pairs;
  *bwd_threads = cols * pairs;
  if (*bwd_threads < quads) {
    *bwd_threads = quads < SEQ_MAX_THREADS ? quads : SEQ_MAX_THREADS;
    if (*bwd_threads < cols * pairs) *bwd_threads = cols * pairs;
  }
  return (*fwd_threads > SEQ_MAX_THREADS || *bwd_threads > SEQ_MAX_THREADS)
             ? 1 : 0;
}

template <typename Kernel, typename... Args>
static int launch_cluster(Kernel kernel, int cluster, int B, int tile,
                          int threads, size_t smem, void* stream,
                          Args... args) {
  if (smem > SEQ_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (B + tile - 1) / tile, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int lstm_seq_fwd_launch(const float* xs, const float* h0,
                                   const float* c0, const float* wx,
                                   const float* wh, const float* b, int T,
                                   int B, int I, int H, int cluster, int tile,
                                   float* ys, float* cseq, float* gates,
                                   float* hT, float* cT, void* stream) {
  int tile_pad, rows, threads, bwd_threads;
  if (T < 0 || B < 1 || I < 1 || (B + tile - 1) / tile > 65535 ||
      seq_threads(H, cluster, tile, &tile_pad, &rows, &threads,
                  &bwd_threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const int cols = H / cluster;
  const size_t smem = 16 + (size_t)16 * (H + I) * cols
                      + (size_t)4 * (2 * H + SEQ_XRING * I) * tile_pad;
  if (rows == 1) {
    return launch_cluster(lstm_seq_fwd_kernel<1>, cluster, B, tile, threads,
                          smem, stream, xs, h0, c0, wx, wh, b, T, B, I, H,
                          tile, tile_pad, ys, cseq, gates, hT, cT);
  }
  return launch_cluster(lstm_seq_fwd_kernel<2>, cluster, B, tile, threads,
                        smem, stream, xs, h0, c0, wx, wh, b, T, B, I, H, tile,
                        tile_pad, ys, cseq, gates, hT, cT);
}

extern "C" int lstm_seq_bwd_launch(const float* dys, const float* dhT,
                                   const float* dcT, const float* gates,
                                   const float* cseq, const float* c0,
                                   const float* wh, int T, int B, int H,
                                   int cluster, int tile, float* da,
                                   float* dh0, float* dc0, void* stream) {
  int tile_pad, rows, fwd_threads, threads;
  if (T < 0 || B < 1 || (B + tile - 1) / tile > 65535 ||
      seq_threads(H, cluster, tile, &tile_pad, &rows, &fwd_threads,
                  &threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const int cols = H / cluster;
  const size_t smem = 16 + (size_t)16 * cols * H
                      + (size_t)16 * cols * tile_pad
                      + (size_t)8 * cluster * tile_pad * cols;
  return launch_cluster(lstm_seq_bwd_kernel, cluster, B, tile, threads, smem,
                        stream, dys, dhT, dcT, gates, cseq, c0, wh, T, B, H,
                        tile, tile_pad, da, dh0, dc0);
}
