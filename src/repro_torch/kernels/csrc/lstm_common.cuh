// The LSTM cell's gate arithmetic, shared by the step kernel
// (lstm_cell.cu) and the whole-sequence kernels (lstm_seq.cu) so that both
// round alike: a sequence run equals the chained step kernel bit for bit.
//
//   i = sigmoid(a_i + b_i)          f = sigmoid(a_f + b_f + 1)
//   g = tanh(a_g + b_g)             o = sigmoid(a_o + b_o)
//   c' = f * c + i * g              h' = o * tanh(c')
//
// a_* are the gate pre-activations without the bias (x @ Wx + h @ Wh, summed
// by the caller in the order k = 0..I-1 over x, then 0..H-1 over h).  The
// +1.0 forget-gate bias is the reference's (src/repro/models/lstm.py).
// c' and h' are written with explicit roundings (no FMA contraction), the
// order the plain PyTorch version takes.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float lstm_sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

struct LstmAct {
  float i, f, g, o;   // gate activations
  float c, h;         // the new cell and hidden state
};

__device__ __forceinline__ LstmAct lstm_apply(float ai, float af, float ag,
                                              float ao, float bi, float bf,
                                              float bg, float bo, float c) {
  LstmAct a;
  a.i = lstm_sigmoidf(ai + bi);
  a.f = lstm_sigmoidf(af + bf + 1.0f);
  a.g = tanhf(ag + bg);
  a.o = lstm_sigmoidf(ao + bo);
  a.c = __fadd_rn(__fmul_rn(a.f, c), __fmul_rn(a.i, a.g));
  a.h = __fmul_rn(a.o, tanhf(a.c));
  return a;
}
