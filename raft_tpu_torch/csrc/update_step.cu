// One refine iteration of RAFT-large's update block, forward, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_step_kernel` of raft_tpu/ops/step_pallas.py
// (:127, reached through `_pallas_step`, :287, from `fused_step`): the
// motion encoder (motion_fwd.cu), then the SepConvGRU cell (sepconv_gru.cu)
// with x = (inp, [motion | flow]) as two parts, and at depth 'mgf' the flow
// head, 3x3 C->256 with ReLU then 3x3 256->2 with bias only, emitting h2
// and delta (f32). Depth 'mg' stops after the GRU and emits h2.
//
// Bound on an H100 SXM (Sintel, B=1, 55x128 pixels, C=128, Cc=324): 'mg'
// 33.46 GFLOP, 'mgf' 37.68 GFLOP, against about 20 MB of compulsory
// traffic (6 us at 3.35 TB/s). On the conv tile's 3xTF32 tensor-core
// products (495 / 3 = 165 TFLOP/s of f32-grade work) that is 0.203 ms
// ('mg') and 0.228 ms ('mgf'); the f32 SIMT bound of the plain-fmaf tile
// this replaces was 0.499 and 0.562 ms at 67 TFLOP/s. Bound by tensor-core
// operations.
//
// Design: one cooperative launch of 7 ('mg') or 9 ('mgf') phases of the
// shared conv tile (conv_phase.cuh), a grid barrier between two phases:
//   1-3  the motion phases into the [motion | flow] buffer;
//   4-7  GRU gates and candidate+blend for each half, reading [h | inp |
//        motion] as three parts where they lie;
//   8    flow-head conv1 (ReLU, 256 channels, into the dead convc1 buffer);
//   9    flow-head conv2 (N = 2), one warp per pixel.
// The TPU kernel recomputes a +-9 ('mg') or +-11 ('mgf') row halo per row
// tile to keep the chain in VMEM; at a 4-row tile that is the motion chain
// 6.5 times over, and the intermediates of a tile would not fit in 228 KB of
// shared memory. Here they live in scratch (1,152 floats a pixel at C=128,
// 32 MB at Sintel size, mostly in the 50 MB L2) and nothing is recomputed.
// The phases have 660, 440, 220, 440, 220, 440, 220 and 440 tiles of 64 x
// 64 at Sintel size on 264 co-resident blocks (two a SM), then the
// warp-per-pixel N = 2 conv.
//
// The bf16 form (raft_update_step_bf16) replaces the same TPU kernel at the
// compute dtype bfloat16 (fused_step(dtype=bfloat16), :503): the same
// program on the bf16 form's warp-specialised tile (conv_phase.cuh, the
// geometry from ops/conv_tile.py): bfloat16 activations, weights and
// scratch, each conv's sum rounded to bfloat16 before its bfloat16 bias and
// the gates and blends rounded where the TPU kernel rounds; h2 and delta
// come back bfloat16. Its flow-head N = 2 conv runs on the tile too (its
// columns padded to 64: a sum of exact bfloat16 products in f32, as the
// warp-per-pixel path of the float32 form). A block, one an SM, computes
// 64 pixels of a row x the conv's whole N (at most 256); the phases have
// 220, 220, 110, 110, 110, 110, 110, 110 and 110 tiles at Sintel size on
// 132 blocks. Bound on an H100 SXM at the Sintel shape: 37.68 GFLOP
// ('mgf') at 989 TFLOP/s is 0.038 ms, against about 10 MB of compulsory
// bfloat16 traffic (3 us): bound by tensor-core operations.

#include "conv_phase.cuh"

using namespace conv_phase;

namespace {

constexpr int kFlowHead = 256;  // FlowHead hidden width (fits the convc1 buffer)

__global__ void __launch_bounds__(kThreads, 2) update_step_kernel(const __grid_constant__ Program p) {
  run_program(p);
}

__global__ void __launch_bounds__(kThreadsH, 1)
    update_step_bf16_kernel(const __grid_constant__ ProgramH p) {
  run_program_h(p);
}

// The program of one iteration in T (float or bf16), launched on `kernel`.
template <typename T, typename Kernel>
int update_step(Kernel kernel, const void* net, const void* inp, const void* corr,
                const void* flow, const void* wc1, const void* bc1, const void* wc2,
                const void* bc2, const void* wf1, const void* bf1, const void* wf2,
                const void* bf2, const void* wo, const void* bo, const void* w_zr1,
                const void* b_zr1, const void* w_q1, const void* b_q1, const void* w_zr2,
                const void* b_zr2, const void* w_q2, const void* b_q2, const void* wfh1,
                const void* bfh1, const void* wfh2, const void* bfh2, void* scratch, void* h2,
                void* delta, int batch, int height, int width, int channels, int inp_channels,
                int corr_channels, int flow_head, const int* plan, int plan_len,
                void* stream) {
  if (channels <= 0 || channels % BN != 0 || inp_channels <= 0 || inp_channels % KC != 0 ||
      corr_channels <= 0 || corr_channels % 4 != 0 || (flow_head && delta == nullptr) ||
      !valid_geometry(batch, height, width)) {
    return (int)cudaErrorInvalidValue;
  }
  ProgramT<T> p{};
  p.M = batch * height * width;
  p.H = height;
  p.W = width;
  if (p.M == 0) return 0;
  const long long M = p.M;
  T* motion_scratch = static_cast<T*>(scratch);
  T* motion = motion_scratch + M * kMotionScratch;
  T* z = motion + M * kMotion;
  T* rh = z + M * channels;
  T* h1 = rh + M * channels;
  const MotionWeightsT<T> mw{static_cast<const T*>(wc1), static_cast<const float*>(bc1),
                             static_cast<const T*>(wc2), static_cast<const float*>(bc2),
                             static_cast<const T*>(wf1), static_cast<const float*>(bf1),
                             static_cast<const T*>(wf2), static_cast<const float*>(bf2),
                             static_cast<const T*>(wo),  static_cast<const float*>(bo)};
  add_motion_phases(p, static_cast<const T*>(corr), corr_channels,
                    static_cast<const T*>(flow), mw, motion_scratch, motion);
  const T* xs[2] = {static_cast<const T*>(inp), motion};
  const int cxs[2] = {inp_channels, kMotion};
  const GruWeightsT<T> gw{static_cast<const T*>(w_zr1), static_cast<const float*>(b_zr1),
                          static_cast<const T*>(w_q1),  static_cast<const float*>(b_q1),
                          static_cast<const T*>(w_zr2), static_cast<const float*>(b_zr2),
                          static_cast<const T*>(w_q2),  static_cast<const float*>(b_q2)};
  T* out_h = static_cast<T*>(h2);
  add_gru_phases(p, static_cast<const T*>(net), channels, xs, cxs, 2, gw, z, rh, h1, out_h);
  if (flow_head) {
    T* fh = motion_scratch;  // convc1's buffer, dead since phase 2
    ConvT<T> fh1 = make_conv(3, 3, static_cast<const T*>(wfh1), static_cast<const float*>(bfh1),
                             kFlowHead, kBiasRelu, fh, kFlowHead, 0);
    add_part(fh1, static_cast<const T*>(out_h), channels);
    add_phase(p, fh1);
    // the float32 form runs the N = 2 conv one warp a pixel, the bf16 form
    // on its tile (columns padded to 64)
    const int fh2_epi = sizeof(T) == sizeof(float) ? kBiasWarp : kBias;
    ConvT<T> fh2 = make_conv(3, 3, static_cast<const T*>(wfh2), static_cast<const float*>(bfh2),
                             2, fh2_epi, static_cast<T*>(delta), 2, 0);
    add_part(fh2, static_cast<const T*>(fh), kFlowHead);
    add_phase(p, fh2);
  }
  return (int)launch_program(kernel, p, plan, plan_len, static_cast<cudaStream_t>(stream));
}

}  // namespace

// net (B, H, W, C), inp (B, H, W, Ci), corr (B, H, W, Cc), flow (B, H, W, 2),
// NHWC float32, contiguous and 16-byte aligned; the motion weights as
// motion_cuda.pack_weights packs them, the GRU's as gru_cuda.pack_weights,
// the flow head's as step_cuda.pack_flow_head (null at depth 'mg');
// scratch of B*H*W*(640 + 128 + 3C) floats; h2 (B, H, W, C); delta
// (B, H, W, 2) at 'mgf', null at 'mg'. C must be a multiple of 64, Ci of
// 16, Cc of 4. The packed matrices are (2, rows, cols), hi then lo, but
// for the flow head's N = 2 conv. Returns a cudaError_t (0 on success); one cooperative
// launch on `stream`.
extern "C" int raft_update_step(const void* net, const void* inp, const void* corr,
                                const void* flow, const void* wc1, const void* bc1,
                                const void* wc2, const void* bc2, const void* wf1,
                                const void* bf1, const void* wf2, const void* bf2,
                                const void* wo, const void* bo, const void* w_zr1,
                                const void* b_zr1, const void* w_q1, const void* b_q1,
                                const void* w_zr2, const void* b_zr2, const void* w_q2,
                                const void* b_q2, const void* wfh1, const void* bfh1,
                                const void* wfh2, const void* bfh2, void* scratch, void* h2,
                                void* delta, int batch, int height, int width, int channels,
                                int inp_channels, int corr_channels, int flow_head,
                                void* stream) {
  return update_step<float>(update_step_kernel, net, inp, corr, flow, wc1, bc1, wc2, bc2, wf1,
                            bf1, wf2, bf2, wo, bo, w_zr1, b_zr1, w_q1, b_q1, w_zr2, b_zr2, w_q2,
                            b_q2, wfh1, bfh1, wfh2, bfh2, scratch, h2, delta, batch, height,
                            width, channels, inp_channels, corr_channels, flow_head, nullptr,
                            0, stream);
}

// The bf16 form: the arguments of raft_update_step with the activations,
// the weight matrices, the scratch (B*H*W*(640 + 128 + 3C) bfloat16s), h2
// and delta in bfloat16, packed by step_cuda.pack_bf16 (one matrix, no lo
// part; the flow head's N = 2 one (64, 9*256), its columns padded as the
// others') and the biases float32 holding bfloat16 values; the tile plan
// of ops/conv_tile.py (`plan_len` ints).
extern "C" int raft_update_step_bf16(const void* net, const void* inp, const void* corr,
                                     const void* flow, const void* wc1, const void* bc1,
                                     const void* wc2, const void* bc2, const void* wf1,
                                     const void* bf1, const void* wf2, const void* bf2,
                                     const void* wo, const void* bo, const void* w_zr1,
                                     const void* b_zr1, const void* w_q1, const void* b_q1,
                                     const void* w_zr2, const void* b_zr2, const void* w_q2,
                                     const void* b_q2, const void* wfh1, const void* bfh1,
                                     const void* wfh2, const void* bfh2, void* scratch,
                                     void* h2, void* delta, int batch, int height, int width,
                                     int channels, int inp_channels, int corr_channels,
                                     int flow_head, const int* plan, int plan_len,
                                     void* stream) {
  return update_step<bf16>(update_step_bf16_kernel, net, inp, corr, flow, wc1, bc1, wc2, bc2,
                           wf1, bf1, wf2, bf2, wo, bo, w_zr1, b_zr1, w_q1, b_q1, w_zr2, b_zr2,
                           w_q2, b_q2, wfh1, bfh1, wfh2, bfh2, scratch, h2, delta, batch, height,
                           width, channels, inp_channels, corr_channels, flow_head, plan,
                           plan_len, stream);
}
