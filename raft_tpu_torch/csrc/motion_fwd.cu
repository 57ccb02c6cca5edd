// BasicMotionEncoder, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_motion_kernel` of raft_tpu/ops/motion_pallas.py
// (:165, reached through `_pallas_motion`, :255, from `motion_encoder`):
// RAFT-large's five motion convolutions, each with bias and ReLU,
//     cor = convc2(convc1(corr))   1x1 Cc->256, 3x3 256->192
//     flo = convf2(convf1(flow))   7x7 2->128,  3x3 128->64
//     out = conv([cor | flo])      3x3 256->126
// emitted as [out (126) | flow (2)], the flow copied bit for bit, with zero
// padding at the image border, in f32 with f32 accumulation.
//
// Bound on an H100 SXM (Sintel, B=1, 55x128 pixels, Cc=324): 901,888
// multiply-adds a pixel, 12.70 GFLOP, against about 13 MB of compulsory
// traffic (4 us at 3.35 TB/s): bound by tensor-core operations, 0.077 ms on
// the conv tile's 3xTF32 products (165 TFLOP/s of f32-grade work; 0.190
// ms at the f32 SIMT peak of 67 TFLOP/s).
//
// Design: one cooperative launch of three phases of the shared conv tile
// (conv_phase.cuh): convc1 | convf1, then convc2 | convf2 stored side by
// side into one [cor | flo] buffer (so the concatenation is free), then the
// fusing conv, whose epilogue writes channels 0-125 and copies the flow
// into 126-127. The TPU kernel recomputes a +-5-row halo per row tile to
// keep everything in VMEM; here the intermediates (640 floats a pixel,
// 18 MB at Sintel size) stay in scratch that lives in the 50 MB L2, and a
// grid barrier replaces the halo. convc1's K (Cc = 324) is padded per tap
// to a multiple of 16 with zero weight rows; convf1's 2-channel input is
// read as 8-byte pixels by 8-byte cp.async copies (the flow is an input of
// the launch, so they may cache in L1).

#include "conv_phase.cuh"

using namespace conv_phase;

namespace {

__global__ void __launch_bounds__(kThreads, 2) motion_fwd_kernel(const __grid_constant__ Program p) {
  run_program(p);
}

__global__ void __launch_bounds__(kThreadsH, 1)
    motion_fwd_bf16_kernel(const __grid_constant__ ProgramH p) {
  run_program_h(p);
}

// The encoder's program in T (float or bf16), launched on `kernel`.
template <typename T, typename Kernel>
int motion_fwd(Kernel kernel, const void* corr, const void* flow, const void* wc1,
               const void* bc1, const void* wc2, const void* bc2, const void* wf1,
               const void* bf1, const void* wf2, const void* bf2, const void* wo, const void* bo,
               void* scratch, void* out, int batch, int height, int width, int corr_channels,
               const int* plan, int plan_len, void* stream) {
  if (corr_channels <= 0 || corr_channels % 4 != 0 || !valid_geometry(batch, height, width)) {
    return (int)cudaErrorInvalidValue;
  }
  ProgramT<T> p{};
  p.M = batch * height * width;
  p.H = height;
  p.W = width;
  if (p.M == 0) return 0;
  const MotionWeightsT<T> mw{static_cast<const T*>(wc1), static_cast<const float*>(bc1),
                             static_cast<const T*>(wc2), static_cast<const float*>(bc2),
                             static_cast<const T*>(wf1), static_cast<const float*>(bf1),
                             static_cast<const T*>(wf2), static_cast<const float*>(bf2),
                             static_cast<const T*>(wo),  static_cast<const float*>(bo)};
  add_motion_phases(p, static_cast<const T*>(corr), corr_channels, static_cast<const T*>(flow),
                    mw, static_cast<T*>(scratch), static_cast<T*>(out));
  return (int)launch_program(kernel, p, plan, plan_len, static_cast<cudaStream_t>(stream));
}

}  // namespace

// corr (B, H, W, Cc) and flow (B, H, W, 2), NHWC float32, contiguous and
// 16-byte aligned; the weights as motion_cuda.pack_weights packs them;
// scratch of B*H*W*640 floats; out (B, H, W, 128). Cc must be a multiple
// of 4. Returns a cudaError_t (0 on success); one cooperative launch on
// `stream`.
extern "C" int raft_motion_fwd(const void* corr, const void* flow, const void* wc1,
                               const void* bc1, const void* wc2, const void* bc2,
                               const void* wf1, const void* bf1, const void* wf2,
                               const void* bf2, const void* wo, const void* bo, void* scratch,
                               void* out, int batch, int height, int width, int corr_channels,
                               void* stream) {
  return motion_fwd<float>(motion_fwd_kernel, corr, flow, wc1, bc1, wc2, bc2, wf1, bf1, wf2,
                           bf2, wo, bo, scratch, out, batch, height, width, corr_channels,
                           nullptr, 0, stream);
}

// The bf16 form: the arguments of raft_motion_fwd with corr, flow, the
// weight matrices, the scratch (B*H*W*640 bfloat16s) and out in bfloat16,
// packed by motion_cuda.pack_weights_bf16 (one matrix each, no lo part),
// the biases float32 holding bfloat16 values, and the tile plan of
// ops/conv_tile.py (`plan_len` ints). It runs the same three phases on the
// bf16 form's warp-specialised tile (conv_phase.cuh): convc1's lookup and
// convf1's flow gathered by the producer's cp.async, the later convs' parts
// by TMA.
extern "C" int raft_motion_fwd_bf16(const void* corr, const void* flow, const void* wc1,
                                    const void* bc1, const void* wc2, const void* bc2,
                                    const void* wf1, const void* bf1, const void* wf2,
                                    const void* bf2, const void* wo, const void* bo,
                                    void* scratch, void* out, int batch, int height, int width,
                                    int corr_channels, const int* plan, int plan_len,
                                    void* stream) {
  return motion_fwd<bf16>(motion_fwd_bf16_kernel, corr, flow, wc1, bc1, wc2, bc2, wf1, bf1,
                          wf2, bf2, wo, bo, scratch, out, batch, height, width, corr_channels,
                          plan, plan_len, stream);
}
