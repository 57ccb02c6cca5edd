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
// 5-tap convolutions are 2 x (5*384*256 + 5*384*128) * 2 * 7040 = 20.8 GFLOP,
// against about 20 MB of compulsory traffic (6 us at 3.35 TB/s). On the
// conv tile's 3xTF32 tensor-core products (three TF32 passes, 495 / 3 =
// 165 TFLOP/s of f32-grade work) that is 126 us; the f32 SIMT bound of the
// plain-fmaf tile this replaces was 310 us at 67 TFLOP/s. The cell is
// bound by tensor-core operations.
//
// Design: four phases of the shared conv tile (conv_phase.cuh) in one
// cooperative launch: gates (z and r*h into scratch) then candidate+blend,
// for each half. The gate nonlinearities and the blend run in the tile's
// epilogue, in the accumulator's fragment layout, so z, r and q never
// exist as pre-activation tensors; z, r*h and the half-way state are the
// only intermediates (3 x M x C floats, in L2 at Sintel size). Every
// phase is K = 5 x 384 = 1,920 deep: 60 cp.async stages of 32 a 64 x 64
// tile. The N = 256 gate phases have 440 tiles and the N = 128 candidate
// phases 220 at Sintel size, on 264 co-resident blocks (two a SM): in
// either, a sixth of the SMs run one tile fewer than the rest.
//
// The bf16 form (raft_sepconv_gru_bf16) replaces the same TPU kernel at the
// compute dtype bfloat16 (sepconv_gru(dtype=bfloat16), :602): the same four
// phases (add_gru_phases<bf16>) on the bf16 conv tile (conv_phase.cuh),
// bfloat16 h, x parts, weights, scratch (z, r*h, the half-way state) and
// h', each conv's f32 sum rounded to bfloat16 before its bfloat16 bias and
// the gates, the candidate and the blend rounded where the TPU kernel
// rounds (gru_pallas.py:300-305). Bound on an H100 SXM at the Sintel shape:
// 20.8 GFLOP at 989 TFLOP/s is 0.0210 ms, against about 10 MB of
// compulsory bfloat16 traffic (3 us): bound by tensor-core operations.

#include "conv_phase.cuh"

using namespace conv_phase;

namespace {

__global__ void __launch_bounds__(kThreads, 2) sepconv_gru_kernel(const __grid_constant__ Program p) {
  run_program(p);
}

__global__ void __launch_bounds__(kThreads, 2)
    sepconv_gru_bf16_kernel(const __grid_constant__ ProgramT<bf16> p) {
  run_program(p);
}

// The cell's program in T (float or bf16), launched on `kernel`.
template <typename T, typename Kernel>
int sepconv_gru(Kernel kernel, const void* h, const void* x0, const void* x1, const void* w_zr1,
                const void* b_zr1, const void* w_q1, const void* b_q1, const void* w_zr2,
                const void* b_zr2, const void* w_q2, const void* b_q2, void* h1, void* z,
                void* rh, void* out, int batch, int height, int width, int channels,
                int x0_channels, int x1_channels, void* stream) {
  const bool x1_ok = x1_channels == 0 ? x1 == nullptr
                                      : x1 != nullptr && x1_channels > 0 && x1_channels % KC == 0;
  if (channels <= 0 || channels % BN != 0 || x0_channels <= 0 || x0_channels % KC != 0 ||
      !x1_ok || !valid_geometry(batch, height, width)) {
    return (int)cudaErrorInvalidValue;
  }
  ProgramT<T> p{};
  p.M = batch * height * width;
  p.H = height;
  p.W = width;
  if (p.M == 0) return 0;
  const T* xs[2] = {static_cast<const T*>(x0), static_cast<const T*>(x1)};
  const int cxs[2] = {x0_channels, x1_channels};
  const GruWeightsT<T> gw{static_cast<const T*>(w_zr1), static_cast<const float*>(b_zr1),
                          static_cast<const T*>(w_q1),  static_cast<const float*>(b_q1),
                          static_cast<const T*>(w_zr2), static_cast<const float*>(b_zr2),
                          static_cast<const T*>(w_q2),  static_cast<const float*>(b_q2)};
  add_gru_phases(p, static_cast<const T*>(h), channels, xs, cxs, x1 ? 2 : 1, gw,
                 static_cast<T*>(z), static_cast<T*>(rh), static_cast<T*>(h1),
                 static_cast<T*>(out));
  return (int)launch_program(kernel, p, static_cast<cudaStream_t>(stream));
}

}  // namespace

// h (B, H, W, C) and the x parts x0 (B, H, W, Cx0) and x1 (B, H, W, Cx1)
// (x1 null and Cx1 = 0 for a single x), NHWC float32, contiguous and
// 16-byte aligned; weights packed per half as w_zr (5 (C+Cx), 2C), b_zr
// (2C), w_q (5 (C+Cx), C), b_q (C). Scratch h1, z, rh and the result out
// are (B, H, W, C), the packed matrices (2, rows, cols) hi then lo. C must
// be a multiple of 64, each Cx of 16.
// Returns a cudaError_t (0 on success); one cooperative launch on `stream`.
extern "C" int raft_sepconv_gru(const void* h, const void* x0, const void* x1,
                                const void* w_zr1, const void* b_zr1, const void* w_q1,
                                const void* b_q1, const void* w_zr2, const void* b_zr2,
                                const void* w_q2, const void* b_q2, void* h1, void* z, void* rh,
                                void* out, int batch, int height, int width, int channels,
                                int x0_channels, int x1_channels, void* stream) {
  return sepconv_gru<float>(sepconv_gru_kernel, h, x0, x1, w_zr1, b_zr1, w_q1, b_q1, w_zr2,
                            b_zr2, w_q2, b_q2, h1, z, rh, out, batch, height, width, channels,
                            x0_channels, x1_channels, stream);
}

// The bf16 form: the arguments of raft_sepconv_gru with h, the x parts, the
// weight matrices, the scratch h1, z, rh and out in bfloat16, packed by
// gru_cuda.pack_weights_bf16 (one matrix each, no lo part) and the biases
// float32 holding bfloat16 values.
extern "C" int raft_sepconv_gru_bf16(const void* h, const void* x0, const void* x1,
                                     const void* w_zr1, const void* b_zr1, const void* w_q1,
                                     const void* b_q1, const void* w_zr2, const void* b_zr2,
                                     const void* w_q2, const void* b_q2, void* h1, void* z,
                                     void* rh, void* out, int batch, int height, int width,
                                     int channels, int x0_channels, int x1_channels,
                                     void* stream) {
  return sepconv_gru<bf16>(sepconv_gru_bf16_kernel, h, x0, x1, w_zr1, b_zr1, w_q1, b_q1, w_zr2,
                           b_zr2, w_q2, b_q2, h1, z, rh, out, batch, height, width, channels,
                           x0_channels, x1_channels, stream);
}
