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
// multiply-adds a pixel, 12.70 GFLOP, 0.190 ms at 67 TFLOP/s, against about
// 13 MB of compulsory traffic (4 us at 3.35 TB/s): bound by f32 operations.
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
// read as 8-byte pixels, two taps per 16-byte slice.

#include "conv_phase.cuh"

using namespace conv_phase;

namespace {

__global__ void __launch_bounds__(kThreads, 2) motion_fwd_kernel(const __grid_constant__ Program p) {
  run_program(p);
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
  if (corr_channels <= 0 || corr_channels % 4 != 0 || !valid_geometry(batch, height, width)) {
    return (int)cudaErrorInvalidValue;
  }
  Program p{};
  p.M = batch * height * width;
  p.H = height;
  p.W = width;
  if (p.M == 0) return 0;
  const MotionWeights mw{static_cast<const float*>(wc1), static_cast<const float*>(bc1),
                         static_cast<const float*>(wc2), static_cast<const float*>(bc2),
                         static_cast<const float*>(wf1), static_cast<const float*>(bf1),
                         static_cast<const float*>(wf2), static_cast<const float*>(bf2),
                         static_cast<const float*>(wo),  static_cast<const float*>(bo)};
  add_motion_phases(p, static_cast<const float*>(corr), corr_channels,
                    static_cast<const float*>(flow), mw, static_cast<float*>(scratch),
                    static_cast<float*>(out));
  return (int)launch_program(motion_fwd_kernel, p, static_cast<cudaStream_t>(stream));
}
