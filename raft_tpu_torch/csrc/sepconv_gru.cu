// SepConvGRU cell, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_gru_kernel` of raft_tpu/ops/gru_pallas.py
// (reached through `_pallas_gru`, :361, from `sepconv_gru`, :602): both
// halves of RAFT's separable ConvGRU, the horizontal (1x5) step and then
// the vertical (5x1) step, each
//     z, r = sigmoid(conv([h, x]; W_zr) + b_zr)      (z and r merged)
//     q    = tanh(conv([r * h, x]; W_q) + b_q)
//     h'   = (1 - z) * h + z * q
// with zero padding at the image border, in f32 with f32 accumulation.
// x is one tensor or two parts (inp, [motion | flow]), read where they lie
// (the counterpart of gru_pallas.split_x_weights and `nparts`): the packed
// weights' rows per tap are [h | x0 | x1], exactly the [h | x] rows.
//
// Bound on an H100 SXM (Sintel, B=1, 55x128 pixels, C=128, Cx=256): the six
// 5-tap convolutions are 2 x (5*384*256 + 5*384*128) * 2 * 7040 = 20.8 GFLOP
// of f32 FMA, 310 us at 67 TFLOP/s, against about 20 MB of compulsory
// traffic (6 us at 3.35 TB/s). The cell is bound by f32 operations.
//
// Design: four phases of the shared conv tile (conv_phase.cuh) in one
// cooperative launch: gates (z and r*h into scratch) then candidate+blend,
// for each half. The gate nonlinearities and the blend run in the tile's
// epilogue, so z, r and q never exist as pre-activation tensors; z, r*h and
// the half-way state are the only intermediates (3 x M x C floats, in L2 at
// Sintel size). This is plain SIMT f32: a tensor-core path is later work.

#include "conv_phase.cuh"

using namespace conv_phase;

namespace {

__global__ void __launch_bounds__(kThreads, 2) sepconv_gru_kernel(const __grid_constant__ Program p) {
  run_program(p);
}

}  // namespace

// h (B, H, W, C) and the x parts x0 (B, H, W, Cx0) and x1 (B, H, W, Cx1)
// (x1 null and Cx1 = 0 for a single x), NHWC float32, contiguous and
// 16-byte aligned; weights packed per half as w_zr (5 (C+Cx), 2C), b_zr
// (2C), w_q (5 (C+Cx), C), b_q (C). Scratch h1, z, rh and the result out
// are (B, H, W, C). C must be a multiple of 64, each Cx of 16.
// Returns a cudaError_t (0 on success); one cooperative launch on `stream`.
extern "C" int raft_sepconv_gru(const void* h, const void* x0, const void* x1,
                                const void* w_zr1, const void* b_zr1, const void* w_q1,
                                const void* b_q1, const void* w_zr2, const void* b_zr2,
                                const void* w_q2, const void* b_q2, void* h1, void* z, void* rh,
                                void* out, int batch, int height, int width, int channels,
                                int x0_channels, int x1_channels, void* stream) {
  const bool x1_ok = x1_channels == 0 ? x1 == nullptr
                                      : x1 != nullptr && x1_channels > 0 && x1_channels % BK == 0;
  if (channels <= 0 || channels % BN != 0 || x0_channels <= 0 || x0_channels % BK != 0 ||
      !x1_ok || !valid_geometry(batch, height, width)) {
    return (int)cudaErrorInvalidValue;
  }
  Program p{};
  p.M = batch * height * width;
  p.H = height;
  p.W = width;
  if (p.M == 0) return 0;
  const float* xs[2] = {static_cast<const float*>(x0), static_cast<const float*>(x1)};
  const int cxs[2] = {x0_channels, x1_channels};
  const GruWeights gw{static_cast<const float*>(w_zr1), static_cast<const float*>(b_zr1),
                      static_cast<const float*>(w_q1),  static_cast<const float*>(b_q1),
                      static_cast<const float*>(w_zr2), static_cast<const float*>(b_zr2),
                      static_cast<const float*>(w_q2),  static_cast<const float*>(b_q2)};
  add_gru_phases(p, static_cast<const float*>(h), channels, xs, cxs, x1 ? 2 : 1, gw,
                 static_cast<float*>(z), static_cast<float*>(rh), static_cast<float*>(h1),
                 static_cast<float*>(out));
  return (int)launch_program(sepconv_gru_kernel, p, static_cast<cudaStream_t>(stream));
}
