// One fused LSTM step of the solar forecaster:
//   gates = x @ Wx + h @ Wh + b, split into i, f, g, o (each H wide)
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
//
// Replaces the Pallas kernel src/repro/kernels/lstm_cell/lstm_cell.py
// (lstm_step_tiled -> _lstm_kernel).  The +1.0 forget-gate bias is the
// reference's (lstm_cell.py, models/lstm.py).
//
// Bound on the H100: bytes, and in practice launch latency.  A step reads
// Wx (I x 4H) and Wh (H x 4H) once: 276 KB at I = 10, H = 128, against
// 2 * B * (I + H) * 4H = 1.1 MFLOP at B = 8, i.e. about 0.08 us of HBM time.
// A forward pass would launch the step 672 + 96 times, so the launch
// overhead, not the step, would set the pace: the forecaster's scan runs
// the whole-sequence kernels of lstm_seq.cu instead, and this kernel stays
// the single-step API (ops.lstm_step, LSTMCellFn).
//
// Design: grid (ceil(H / LSTM_COLS), B).  A block serves one batch row and
// LSTM_COLS hidden columns; it stages x[b, :] and h[b, :] in shared memory.
// Thread j accumulates the four gate pre-activations of column j
// (j, j + H, j + 2H, j + 3H) with f32 FMAs over k = 0..I-1 then 0..H-1, so a
// warp reads 32 adjacent floats of each weight row (coalesced).  The gates
// stay in registers; only h' and c' are written.  Rows after the first
// reread the weights from L2.  Any B works (no padding to a tile); no tensor
// cores and no TF32, so the result is plain f32 arithmetic.  The gate
// arithmetic is lstm_common.cuh's, shared with lstm_seq.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

#define LSTM_COLS 32

__global__ void lstm_cell_kernel(const float* __restrict__ x,
                                 const float* __restrict__ h,
                                 const float* __restrict__ c,
                                 const float* __restrict__ wx,
                                 const float* __restrict__ wh,
                                 const float* __restrict__ b, int in_dim,
                                 int hidden, float* __restrict__ h_out,
                                 float* __restrict__ c_out) {
  extern __shared__ float stage[];
  float* xs = stage;
  float* hs = stage + in_dim;
  const int64_t row = blockIdx.y;
  for (int k = threadIdx.x; k < in_dim; k += blockDim.x) {
    xs[k] = x[row * in_dim + k];
  }
  for (int k = threadIdx.x; k < hidden; k += blockDim.x) {
    hs[k] = h[row * hidden + k];
  }
  __syncthreads();

  const int j = blockIdx.x * LSTM_COLS + threadIdx.x;
  if (j >= hidden) return;
  const int64_t g4 = 4 * (int64_t)hidden;
  float ai = 0.0f, af = 0.0f, ag = 0.0f, ao = 0.0f;
#pragma unroll 4
  for (int k = 0; k < in_dim; ++k) {
    const float v = xs[k];
    const float* w = wx + k * g4 + j;
    ai = fmaf(v, w[0], ai);
    af = fmaf(v, w[hidden], af);
    ag = fmaf(v, w[2 * hidden], ag);
    ao = fmaf(v, w[3 * hidden], ao);
  }
#pragma unroll 4
  for (int k = 0; k < hidden; ++k) {
    const float v = hs[k];
    const float* w = wh + k * g4 + j;
    ai = fmaf(v, w[0], ai);
    af = fmaf(v, w[hidden], af);
    ag = fmaf(v, w[2 * hidden], ag);
    ao = fmaf(v, w[3 * hidden], ao);
  }
  const LstmAct a = lstm_apply(ai, af, ag, ao, b[j], b[j + hidden],
                               b[j + 2 * hidden], b[j + 3 * hidden],
                               c[row * hidden + j]);
  c_out[row * hidden + j] = a.c;
  h_out[row * hidden + j] = a.h;
}

extern "C" int lstm_cell_launch(const float* x, const float* h, const float* c,
                                const float* wx, const float* wh,
                                const float* b, int batch, int in_dim,
                                int hidden, float* h_out, float* c_out,
                                void* stream) {
  if (batch < 1 || in_dim < 1 || hidden < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(in_dim + hidden) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((hidden + LSTM_COLS - 1) / LSTM_COLS, batch);
  lstm_cell_kernel<<<grid, LSTM_COLS, smem, (cudaStream_t)stream>>>(
      x, h, c, wx, wh, b, in_dim, hidden, h_out, c_out);
  return (int)cudaGetLastError();
}
