// On-demand windowed correlation, backward, bf16 forms, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of raft_tpu/ops/corr_pallas.py
// (:276, reached through `_pallas_bwd`, :411, from the custom VJP
// `_windowed_bwd`, :468) on the operands the bf16 mixed-precision policy
// gives it in training: the function of corr_bwd.cu (df1 and one df2 per
// pooled level for the cotangent g of the lookup; no coordinate gradient)
// with
//   - the feature maps in bfloat16 or float32 (M), the cotangent in
//     bfloat16 or float32, loaded as float32 (the TPU kernel's :302);
//   - mxu "float32" on bfloat16 maps (the policy's default in training):
//     the float32 coefficients times the maps at float32 precision. The
//     map is exact in bfloat16, and the coefficient is split into three
//     bfloat16 parts, c = hi + mid + lo (24 significant bits): three
//     m16n8k16 bf16 mma.sync passes with float32 sums;
//   - mxu "bfloat16" (an explicit corr_mxu_dtype="bfloat16", on bfloat16
//     or float32 maps): the folded coefficient rounded to bfloat16 where
//     the TPU kernel rounds g2 (:342, :346), the maps rounded to bfloat16
//     (to nearest even), and one m16n8k16 bf16 mma.sync pass per 16 of K
//     with float32 accumulation, as corr_fwd_bf16.cu multiplies.
// df1 and the df2 levels are summed in float32 by 16-byte vector atomics
// into float32 buffers; the wrapper rounds each once, after the whole sum,
// to the maps' dtype (`_windowed_bwd` casts outside its kernel too). The
// float32 maps with mxu "float32" are corr_bwd.cu's.
//
// The coefficient of neighbour (i, j) (x index first) is folded in the TPU
// kernel's order: the cotangent scaled by 1/sqrt(C) first, then the x-side
// adjoint U_b = sum over windows a of g[a, b] * hat_x, then the y side,
// g2 = sum over b of hat_y * U_b; so its float32 value, and the bfloat16
// rounding of it, are the TPU kernel's up to the float32 rounding of the
// hats.
//
// Bound on an H100 SXM (chairs training, B=8, 46x62 queries, C=256, 4
// levels, r=4, bfloat16 maps, coherent flows): about 6.1 GFLOP of products
// for the two C-long updates per in-range neighbour, 0.019 ms at 329.7
// TFLOP/s (three bf16 passes: a third of the 989 TFLOP/s bf16 rate; two
// TF32 passes would take 0.025 ms at 247.5), 0.0062 ms at 989 TFLOP/s (mxu
// "bfloat16"), against about 69 MB of compulsory traffic (the bfloat16
// maps read, the cotangent, the float32 gradients written), 0.021 ms at
// 3.35 TB/s: bound by bytes. chip_smoke.py counts this run's in-range
// neighbours for the exact bounds.
//
// Design: corr_tile.cuh's tile, box and path rule, fold and warp path
// (the float32 form's lanes, rounding a float32 map and the coefficient to
// bfloat16 under mxu "bfloat16"), with a shared path of its own in
// corr_tile_bf16.cuh: box chunks of 64 pixels as the only loop, each block
// over the whole C, the tile's F1 staged once, G built once a chunk in
// bfloat16 planes, the maps staged in bfloat16 on a ring of two chunk
// stages by cp.async, ldmatrix fragments, bf16 mma.sync, df2 out of the
// accumulators by float4 atomics. C is 128 or 256 (RAFT-small's and
// RAFT-large's feature widths), radius 3 or 4, 1-4 levels, rescale 0 or 1.
//
// What was hard, and what the design does about it:
// - The parent's time was spread over its parts, not held by one: taking
//   out the copies, the products, the G build or the df2 atomics each saved
//   7-19% (scripts/corr_tile_bench.py bwd_bf16). Its channel chunks were
//   the outer loop, so G was rebuilt for every 64 channels, and each chunk
//   waited for its copies and crossed three barriers in turn. Here a chunk
//   crosses two barriers, its G is built once, and the next chunk's copies
//   land while it is multiplied.
// - bfloat16 maps went through registers into float32 staging (twice the
//   bytes of bfloat16); here they are staged as they are by cp.async, and
//   only float32 maps are converted on the way in.
// - Rounding points: the coefficient must be rounded after the fold, not
//   its parts, and only under mxu "bfloat16"; the two paths round the same
//   float32 values, so they multiply the same bfloat16 ones.
// - m16n8k16 fragments pair two K-neighbours in one 32-bit register; G^T
//   and the maps (N-major) have K along their rows, so ldmatrix .trans
//   builds those fragments from 16-byte rows, padded so that the eight
//   rows of a block fall in distinct banks.
// - As in corr_bwd.cu, every sum ends in float atomics in no fixed order,
//   so df1 and df2 are not bit-reproducible from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "corr_tile_bf16.cuh"

namespace {

using namespace corr_tile;

using bf16 = __nv_bfloat16;

// A bf16 form: maps of type M, products in bfloat16 (kMxuBf16: G one plane)
// or at float32 precision on bfloat16 maps (G three planes); C 128 or 256.
template <typename M, bool kMxuBf16>
struct Bf16Form {
  static_assert(kMxuBf16 || std::is_same<M, bf16>::value,
                "float32 maps at float32 precision are corr_bwd.cu's");
  using T = M;
  static constexpr int kPlanes = kMxuBf16 ? 1 : 3;
  // The warp path's coefficient and lanes (float32 FMAs): the coefficient
  // and a float32 map rounded to bfloat16 under mxu "bfloat16".
  __device__ __forceinline__ static float coef(float c) { return kMxuBf16 ? round_bf16(c) : c; }
  template <typename Vec>
  __device__ __forceinline__ static float4 load(const float* p) {
    static_assert(std::is_same<Vec, float4>::value, "the bf16 forms' lanes are float4s");
    float4 v = __ldg(reinterpret_cast<const float4*>(p));
    if (kMxuBf16) v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
    return v;
  }
  template <typename Vec>
  __device__ __forceinline__ static float4 load(const bf16* p) {
    static_assert(std::is_same<Vec, float4>::value, "the bf16 forms' lanes are float4s");
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

// The three operand combinations: bfloat16 maps with mxu float32 or
// bfloat16, float32 maps with mxu bfloat16.
struct Bf16Forms {
  template <int R>
  static cudaError_t launch(const BwdArgs& a, int maps_bf16, int mxu_bf16) {
    using corr_tile_bf16::launch_width;
    if (maps_bf16) {
      return mxu_bf16 ? launch_width<R, Bf16Form<bf16, true>>(a)
                      : launch_width<R, Bf16Form<bf16, false>>(a);
    }
    return mxu_bf16 ? launch_width<R, Bf16Form<float, true>>(a) : cudaErrorInvalidValue;
  }
};

}  // namespace

// The bf16 forms: the arguments of raft_corr_bwd, with fmap1 and the
// levels bfloat16 when maps_bf16 (else float32), grad bfloat16 when
// grad_bf16 (else float32), the products in bfloat16 when mxu_bf16 (else at
// float32 precision, bfloat16 maps only); df1 and the dlevels float32
// holding zeros (the kernel adds into them). C is 128 or 256. Returns a
// cudaError_t (0 on success); launches on `stream`.
extern "C" int raft_corr_bwd_bf16(const void* fmap1, const void* level0, const void* level1,
                                  const void* level2, const void* level3, int h0, int w0,
                                  int h1, int w1, int h2, int w2, int h3, int w3,
                                  int num_levels, const void* coords, const void* grad,
                                  void* df1, void* dlevel0, void* dlevel1, void* dlevel2,
                                  void* dlevel3, int batch, int height, int width,
                                  int channels, int radius, int rescale, float inv_scale,
                                  int budget, int maps_bf16, int grad_bf16, int mxu_bf16,
                                  void* path_counts, void* stream) {
  const void* levels[kMaxLevels] = {level0, level1, level2, level3};
  void* dlevels[kMaxLevels] = {dlevel0, dlevel1, dlevel2, dlevel3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  return bwd_entry<Bf16Forms>(fmap1, levels, hs, ws, num_levels, coords, grad, df1, dlevels,
                              batch, height, width, channels, radius, rescale, inv_scale,
                              budget, maps_bf16, grad_bf16, mxu_bf16, path_counts, stream);
}
