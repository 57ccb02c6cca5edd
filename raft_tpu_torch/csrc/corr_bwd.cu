// On-demand windowed correlation, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of raft_tpu/ops/corr_pallas.py
// (reached through `_pallas_bwd`, :411, from the custom VJP `_windowed_bwd`,
// :468): given the cotangent g (B, H, W, L * (2r+1)^2) of the forward of
// csrc/corr_fwd.cu, it returns df1 (B, H, W, C) and one df2 per pooled level
// (B, h_l, w_l, C), accumulated in f32. The coordinates get no gradient (the
// wrapper returns None for them), the contract of `_windowed_bwd` and of the
// reference's alt_cuda_corr extension.
//
// Forward, per query q and level l: with (cx, cy) = coords[q] / 2^l (or
// coords[q] itself with rescale = 0, the sparse family's lookup; the
// forward's per-level centre rule exactly), the dots d[n] = f1[q] . f2_l[n]
// over the (2r+2)^2 integer neighbours n of (floor(cx) - r, floor(cy) - r),
// zero where n lies outside the level, and out[k = i*(2r+1) + j] = sum of the
// four bilinear corner weights times d around neighbour (i, j), divided by
// sqrt(C). So the backward first folds the window's cotangents into one
// coefficient per neighbour, coef[n] = dL/dd[n] = sum over the windows
// touching n of g * weight / sqrt(C), and then, for every in-range
// neighbour,
//   df1[q]    += coef[n] * f2_l[n]
//   df2_l[n]  += coef[n] * f1[q]
// Out-of-range neighbours contribute nothing (zero padding), and neither
// does a centre that fails the forward's `near` test (far or NaN).
//
// Bound on an H100 SXM (chairs training, B=8, 46x62 queries, C=256, 4
// levels, r=4): about 7.4 GFLOP of f32-grade products for the two C-long
// updates per in-range neighbour, 0.11 ms at 67 TFLOP/s (f32 SIMT), 0.045 ms
// at 165 TFLOP/s (3xTF32), against about 140 MB of compulsory traffic (f1,
// the pyramid, g, df1 and the df2 levels), 0.04 ms at 3.35 TB/s: bound by
// operations. chip_smoke.py counts this run's in-range neighbours for the
// exact bounds.
//
// Design: one block per (tile of 8 x 8 queries, level), corr_tile.cuh's
// tile, box and path rule and its backward shell (corr_bwd_kernel, shared
// with the bf16 forms of corr_bwd_bf16.cu), filled here with the float32
// form: float32 maps staged by cp.async, 3xTF32 products, the four corner
// weights of each window folded in turn; the TPU kernel's two matmuls per
// chunk (df1 += g2^T f2, df2 += g2 f1) on the tensor cores. The block first folds
// its queries' cotangents into coef (64 x (2r+2)^2, shared memory).
//   Shared path (box <= budget pixels): with G (64 x box) the dense matrix
//   of the coefficients, G[q, n] = coef of q at neighbour n and zero where
//   n is not a neighbour of q,
//     df1_tile (64 x C) = G . F2_box (box x C)
//     df2_box (box x C) = G^T . F1_tile (64 x C)
//   in chunks of kBCC = 64 channels (outer) and kBNC = 64 box pixels
//   (inner), 3xTF32 mma.sync m16n8k8, 8 warps as 4 x 2 tiles of 16 x 32.
//   Each chunk of df2_box is complete after its one product (K = the 64
//   queries): it is summed in registers, staged in shared memory and added
//   to df2_l with one 16-byte vector atomic per box pixel and channel quad,
//   where the warp path issues one per query, in-range neighbour and quad.
//   df1 sums over the chunks in registers and over the levels (blocks of
//   one tile at other levels) by the same vector atomics into a zeroed df1.
//   Every f2 row of the box and every f1 row of the tile is read once per
//   (tile, level).
//   Warp path (a larger box, or a C with no tile form): one warp per query,
//   lanes over C, alt_cuda_corr's scheme. The warp walks the query's
//   in-range neighbours: a vector load of f2_l[n] per lane feeds df1 in
//   registers, and df2_l[n] takes coef * f1[q] by a 16-byte (float4),
//   8-byte (float2: C = 64, 192) or 4-byte (C under 128) atomic add.
//
// Both paths end in float atomics in no fixed order, so df1 and df2 are not
// bit-reproducible from run to run (the TPU kernel revisits each df2 block
// across its sequential query grid, which has no counterpart on 132 SMs
// running blocks in no order).
//
// What was hard, and what the design does about it:
// - TF32 wgmma takes K-major operands only, and both products here have an
//   N-major B (F2_box for df1, F1_tile for df2) and df2's A is G^T: mma.sync
//   loads each fragment element from shared memory in whatever order the
//   product wants. Strides of 72 floats keep the F1, F2 and G^T fragment
//   loads free of bank conflicts (G's own loads for df1 take two ways).
// - Both operands are activations: split hi/lo in registers after each load.
// - The tensor cores round their sums toward zero, which drifts in a long
//   chain of products: each k8 step's large product is a fresh sum added in
//   f32 (corr_tile.cuh, mma_3xtf32), as in the forward.
// - A box is ragged: its chunks are padded with zero-filled copies, G is
//   zero past the box, a warp skips products over pixels past it, and no
//   atomic goes outside the box, which never leaves the level.
// - The coarse levels: at level 3 of the chairs shape (5 x 7 pixels) every
//   pixel took an atomic from each of an image's 2,852 queries, serialised
//   in L2. On the shared path it takes one per tile.
// - G would be 64 x box floats: it is rebuilt per 64-pixel chunk from coef
//   (each thread owns one pixel of the chunk and 16 queries).

#include <cuda_runtime.h>

#include "corr_tile.cuh"

namespace {

using namespace corr_tile;

// The float32 form: float32 maps, cotangent and products (3xTF32), any
// width of the lookup.
struct Float32Form {
  using T = float;
  static constexpr Product kProduct = Product::k3xTF32;
  static constexpr bool kTpuOrder = false;
  static constexpr bool kBf16Cotangent = false;
  static constexpr bool kAnyWidth = true;
  __device__ __forceinline__ static float coef(float c) { return c; }
  template <typename Vec>
  __device__ __forceinline__ static Vec load(const float* p) {
    return __ldg(reinterpret_cast<const Vec*>(p));
  }
  __device__ __forceinline__ static void stage4(float* dst, const float* src, bool ok) {
    cp_async16(dst, src, ok);
  }
};

struct Float32Forms {
  template <int R>
  static cudaError_t launch(const BwdArgs& a, int maps_bf16, int mxu_bf16) {
    if (maps_bf16 || mxu_bf16 || a.grad_bf16) return cudaErrorInvalidValue;
    return launch_bwd_width<R, Float32Form>(a);
  }
};

}  // namespace

// fmap1 (B, H, W, C), level l (B, h_l, w_l, C), coords (B, H, W, 2) at level-0
// scale, grad (B, H, W, L * (2r+1)^2), df1 (B, H, W, C) and dlevel l
// (B, h_l, w_l, C): all float32, contiguous, 16-byte aligned; df1 and each
// dlevel must hold zeros (the kernel adds into them). C is 64, 128, 192,
// 256, 384, 512 or under 128; radius is 3 or 4; 1 <= L <= 4; rescale 1
// samples level l around coords / 2^l, 0 around coords. inv_scale is
// 1/sqrt(C), or 1 without the scale. budget and path_counts as for
// raft_corr_fwd. maps_bf16, grad_bf16 and mxu_bf16 are raft_corr_bwd_bf16's
// and must be 0 here. Returns a cudaError_t (0 on success); launches on
// `stream`.
extern "C" int raft_corr_bwd(const void* fmap1, const void* level0, const void* level1,
                             const void* level2, const void* level3, int h0, int w0,
                             int h1, int w1, int h2, int w2, int h3, int w3,
                             int num_levels, const void* coords, const void* grad,
                             void* df1, void* dlevel0, void* dlevel1, void* dlevel2,
                             void* dlevel3, int batch, int height, int width, int channels,
                             int radius, int rescale, float inv_scale, int budget,
                             int maps_bf16, int grad_bf16, int mxu_bf16, void* path_counts,
                             void* stream) {
  const void* levels[kMaxLevels] = {level0, level1, level2, level3};
  void* dlevels[kMaxLevels] = {dlevel0, dlevel1, dlevel2, dlevel3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  return bwd_entry<Float32Forms>(fmap1, levels, hs, ws, num_levels, coords, grad, df1, dlevels,
                                 batch, height, width, channels, radius, rescale, inv_scale,
                                 budget, maps_bf16, grad_bf16, mxu_bf16, path_counts, stream);
}
