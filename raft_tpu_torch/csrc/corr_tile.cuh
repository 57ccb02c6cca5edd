// The shared query tile of the windowed-correlation kernels (corr_fwd.cu,
// corr_bwd.cu), NVIDIA Hopper (sm_90a).
//
// A block takes one tile of kTile x kTile = 64 queries of one image and one
// pooled level (grid: tiles x levels). At level l a query's centre is
// (cx, cy) = coords / 2^l (coords itself with kRescale false, the sparse
// family's lookup), and its (2r+2)^2 integer neighbours start at
// (floor(cx) - r, floor(cy) - r). The tile's *box* is the bounding box of
// those neighbours over the tile's queries, each query's neighbours first
// clipped to the level; a query whose centre fails the `near` test (far or
// NaN) or whose neighbours all lie off the level adds nothing to it. Every
// in-level neighbour of every query lies in the box, and the box never
// leaves the level, so zero padding is the zero of a neighbour outside it.
// A box of at most `budget` pixels takes the shared path: the box's rows of
// the level are staged in shared memory once, and the tile's products with
// them run on the tensor cores. A larger box (flows that scatter the tile's
// windows over the level) takes the per-query warp path, which reads each
// query's neighbours itself. Each block adds one to path_counts[0] (shared
// path) or path_counts[1] (warp path).
//
// The forward's kernel, corr_fwd_kernel below, is the float32 form's shell
// (corr_fwd.cu); the bf16 form (corr_fwd_bf16.cu) runs a kernel of its own
// on this tile, box and path rule. The backward's, corr_bwd_kernel, is the
// float32 form's (corr_bwd.cu); the bf16 forms (corr_bwd_bf16.cu) run a
// kernel of their own on this tile, box, path rule and warp path
// (corr_tile_bf16.cuh).
//
// Products are mma.sync m16n8k8 in 3xTF32: both operands are activations,
// split in registers after their shared-memory load (split_tf32 of
// conv_phase.cuh: hi rounded to TF32, lo the remainder whose top 11 bits the
// tensor core reads), a product a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with f32
// accumulation (mma_3xtf32 below for how the sums are kept).

#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_phase.cuh"

namespace corr_tile {

using conv_phase::cp_async16;
using conv_phase::cp_async_commit;
using conv_phase::cp_async_wait;
using conv_phase::split_tf32;

constexpr int kMaxLevels = 4;
constexpr int kTile = 8;            // a tile is kTile x kTile queries
constexpr int kQ = kTile * kTile;   // queries per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// A path count: 64 bits, so that a long training run's blocks never wrap it.
using Count = unsigned long long;

struct Levels {
  const float* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// The tile's queries at the block's level, in shared memory.
struct TileQueries {
  long long q[kQ];  // global query index (b * H + y) * W + x, -1 past the image
  int x0[kQ];       // first integer neighbour (floor(cx) - r), 0 unless near
  int y0[kQ];
  float dx[kQ];     // bilinear fractions cx - floor(cx)
  float dy[kQ];
  int near[kQ];     // the centre is finite and not far off
  int box[4];       // x_lo, y_lo, x_hi, y_hi (inclusive); x_lo > x_hi if empty
  int b;            // the tile's image
};

__host__ __device__ inline int tiles_of(int batch, int H, int W) {
  return batch * ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
}

// Fills `t` for tile blockIdx.x at level l: the queries' centres (the
// per-query rule of the warp path exactly) and the box. Ends in a barrier.
template <int R, bool kRescale>
__device__ void load_tile(TileQueries& t, const float* __restrict__ coords, int H, int W,
                          int l, int h2, int w2) {
  constexpr int D = 2 * R + 2;
  const int tid = threadIdx.x;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int per_image = tiles_x * ((H + kTile - 1) / kTile);
  const int b = blockIdx.x / per_image;
  const int ty = (blockIdx.x % per_image) / tiles_x;
  const int tx = blockIdx.x % tiles_x;
  if (tid == 0) {
    t.box[0] = t.box[1] = INT_MAX;
    t.box[2] = t.box[3] = INT_MIN;
    t.b = b;
  }
  __syncthreads();
  if (tid < kQ) {
    const int y = ty * kTile + tid / kTile;
    const int x = tx * kTile + tid % kTile;
    const bool valid = y < H && x < W;
    const long long q = valid ? ((long long)b * H + y) * W + x : -1;
    float dx = 0.f, dy = 0.f;
    int x0 = 0, y0 = 0, near = 0;
    if (valid) {
      const float lvl_div = kRescale ? (float)(1 << l) : 1.f;
      const float cx = coords[2 * q] / lvl_div;
      const float cy = coords[2 * q + 1] / lvl_div;
      const float fx = floorf(cx);
      const float fy = floorf(cy);
      dx = cx - fx;
      dy = cy - fy;
      // A centre this far out has no neighbour inside any level (and a NaN
      // fails the test too); it also keeps the int conversion defined.
      near = fabsf(fx) < 1.0e8f && fabsf(fy) < 1.0e8f;
      if (near) {
        x0 = (int)fx - R;
        y0 = (int)fy - R;
        const int xl = max(x0, 0), xh = min(x0 + D - 1, w2 - 1);
        const int yl = max(y0, 0), yh = min(y0 + D - 1, h2 - 1);
        if (xl <= xh && yl <= yh) {
          atomicMin(&t.box[0], xl);
          atomicMin(&t.box[1], yl);
          atomicMax(&t.box[2], xh);
          atomicMax(&t.box[3], yh);
        }
      }
    }
    t.q[tid] = q;
    t.x0[tid] = x0;
    t.y0[tid] = y0;
    t.dx[tid] = dx;
    t.dy[tid] = dy;
    t.near[tid] = near;
  }
  __syncthreads();
}

// The forward's shared path (corr_fwd.cu): the box in chunks of kNC pixels,
// C in stages of kKC channels, a staged float row kLdk floats apart
// (conflict-free fragments).
constexpr int kNC = 128;
constexpr int kKC = 32;
constexpr int kLdk = kKC + 4;

// The window of query slot qi from its dots (row-major, D per row).
template <int R>
__device__ __forceinline__ float window_value(const TileQueries& t, int qi, const float* dots,
                                              int k) {
  constexpr int D = 2 * R + 2;
  constexpr int WIN = 2 * R + 1;
  const float dx = t.dx[qi], dy = t.dy[qi];
  const float w00 = (1.f - dx) * (1.f - dy);
  const float w10 = dx * (1.f - dy);
  const float w01 = (1.f - dx) * dy;
  const float w11 = dx * dy;
  const int i = k / WIN;  // x offset index
  const int j = k % WIN;  // y offset index
  return w00 * dots[j * D + i] + w10 * dots[j * D + i + 1] + w01 * dots[(j + 1) * D + i] +
         w11 * dots[(j + 1) * D + i + 1];
}

// Pixels in the box (0 if it is empty) and its width.
__device__ __forceinline__ int box_pixels(const TileQueries& t, int& bw) {
  bw = t.box[2] - t.box[0] + 1;
  return t.box[0] <= t.box[2] ? bw * (t.box[3] - t.box[1] + 1) : 0;
}

// Which path the block takes: the shared one when the width has a tile form
// and the box fits the budget. Counted once per block.
__device__ __forceinline__ bool choose_path(bool tile_width, int nb, int budget,
                                            Count* path_counts) {
  const bool shared = tile_width && nb <= budget;
  if (threadIdx.x == 0) atomicAdd(path_counts + (shared ? 0 : 1), 1ULL);
  return shared;
}

// d += a * b: one m16n8k8 TF32 product with f32 accumulation. a in the
// fragment layout (a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
// a3 = (g + 8, t + 4)), b0 = (t, g), b1 = (t + 4, g), d0..d3 = (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b: one m16n8k16 bfloat16 product with f32 accumulation. a0..a3
// hold (g, 2t..2t+1), (g + 8, 2t..2t+1), (g, 2t+8..2t+9), (g + 8,
// 2t+8..2t+9); b0, b1 hold (2t..2t+1, g), (2t+8..2t+9, g); d as m16n8k8's.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k8 step of a 3xTF32 product, a and b split hi and lo; the product is
// big + small once every step is in. The tensor cores round each sum toward
// zero, so a chain of products into one accumulator drifts with it. With
// all three terms of a 32-channel stage chained into one partial sum (the
// conv tile's scheme) the kernels held the 1e-4 bar against their plain
// versions, but a train step through them moved 3,067 of 5,257,984
// parameters by more than 1e-6 from the plain route's after AdamW's first
// update (tests/test_torch_train.py allows 525): AdamW's first step turns
// a gradient's last bits near zero into whole steps. So the large term
// a_hi*b_hi is taken into a fresh sum each step and added to `big` in f32,
// rounded to nearest; the small terms a_lo*b_hi + a_hi*b_lo, 2^-11 of the
// result, chain in `small`, where the drift is below f32's resolution of
// the result.
__device__ __forceinline__ void mma_3xtf32(float* big, float* small, const uint32_t* ah,
                                           const uint32_t* al, const uint32_t* bh,
                                           const uint32_t* bl) {
  float step[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(step, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) big[e] += step[e];
  mma_tf32(small, al, bh);
  mma_tf32(small, ah, bl);
}

// The A fragment of the 16 x 8 block at (m0, k0) of a matrix whose element
// (m, k) is at p[m * sm + k * sk], split hi and lo.
__device__ __forceinline__ void load_a(const float* p, int sm, int sk, int m0, int k0,
                                       uint32_t* hi, uint32_t* lo) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = m0 + g + 8 * (e & 1), k = k0 + t + 4 * (e >> 1);
    split_tf32(p[m * sm + k * sk], hi[e], lo[e]);
  }
}

// The B fragment of the 8 x 8 block at (k0, n0) of a matrix whose element
// (k, n) is at p[k * sk + n * sn], split hi and lo.
__device__ __forceinline__ void load_b(const float* p, int sk, int sn, int k0, int n0,
                                       uint32_t* hi, uint32_t* lo) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) split_tf32(p[(k0 + t + 4 * e) * sk + (n0 + g) * sn], hi[e], lo[e]);
}

// -- the forward's shell ------------------------------------------------------

// A window stored in float32, or rounded to the nearest bfloat16.
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One block of the forward: the tile and its box at level blockIdx.y, the
// path, and the shared path's window epilogue. A form of the forward (one
// struct per maps' type and width) supplies
//   T                 the maps' type, which is the windows' type too;
//   kTileForm         whether the width has the shared path;
//   channels(c)       the width C (a constant where the form fixes it);
//   smem_bytes<R>()   the dynamic shared memory: S (kQ x (2r+2)^2 floats)
//                     and the stage ring after it, or the warp path's dots;
//   shared_path<R>(t, fmap1, f2, w2, C, nb, bw, S, stage): the shared
//                     path's dots of every query of the tile into S;
//   warp_path<R>(t, fmap1, f2, h2, w2, C, dots, out, out_stride, out_off,
//                scale_div): the warp path, its windows written.
template <int R, bool kRescale, class Form>
__global__ void __launch_bounds__(kThreads, 2)
corr_fwd_kernel(const typename Form::T* __restrict__ fmap1, const Levels lv,
                const int num_levels, const float* __restrict__ coords,
                typename Form::T* __restrict__ out, const int H, const int W,
                const int channels, const float scale_div, const int budget,
                Count* __restrict__ path_counts) {
  using T = typename Form::T;
  constexpr int D = 2 * R + 2;
  constexpr int WIN = 2 * R + 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ TileQueries t;
  const int C = Form::channels(channels);
  const int l = blockIdx.y;
  const int h2 = lv.h[l], w2 = lv.w[l];
  load_tile<R, kRescale>(t, coords, H, W, l, h2, w2);
  int bw;
  const int nb = box_pixels(t, bw);
  const T* f2 = reinterpret_cast<const T*>(lv.ptr[l]) + (long long)t.b * h2 * w2 * C;
  const int out_stride = num_levels * WIN * WIN;
  if (!choose_path(Form::kTileForm, nb, budget, path_counts)) {
    Form::template warp_path<R>(t, fmap1, f2, h2, w2, C, smem, out, out_stride, l * WIN * WIN,
                                scale_div);
    return;
  }
  if constexpr (Form::kTileForm) {
    float* S = smem;
    Form::template shared_path<R>(t, fmap1, f2, w2, C, nb, bw, S,
                                  reinterpret_cast<T*>(smem + kQ * D * D));
    for (int k = threadIdx.x; k < kQ * WIN * WIN; k += kThreads) {
      const int qi = k / (WIN * WIN);
      const long long q = t.q[qi];
      if (q >= 0) {
        const int kw = k % (WIN * WIN);
        store_out(out + q * out_stride + l * WIN * WIN + kw,
                  window_value<R>(t, qi, S + qi * D * D, kw) / scale_div);
      }
    }
  }
}

// A forward launch's arguments, checked by fwd_entry.
struct FwdArgs {
  const void* fmap1;
  Levels lv;
  int num_levels;
  const float* coords;
  void* out;
  int H, W, channels;
  float scale_div;
  int budget;
  Count* path_counts;
  dim3 grid;
  cudaStream_t stream;
};

template <int R, bool kRescale, class Form>
cudaError_t launch_fwd(const FwdArgs& a) {
  using T = typename Form::T;
  auto kernel = corr_fwd_kernel<R, kRescale, Form>;
  constexpr int bytes = Form::template smem_bytes<R>();
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<a.grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.fmap1), a.lv, a.num_levels, a.coords, static_cast<T*>(a.out), a.H,
      a.W, a.channels, a.scale_div, a.budget, a.path_counts);
  return cudaGetLastError();
}

// The forward entries' body: checks the arguments and runs
// Widths::launch<R, kRescale>(args), which picks the form of the width, at
// radius 4 or 3. Returns a cudaError_t (0 on success).
template <class Widths>
int fwd_entry(const void* fmap1, const void* const* levels, const int* hs, const int* ws,
              int num_levels, const void* coords, void* out, int batch, int height, int width,
              int channels, int radius, int rescale, float scale_div, int budget,
              void* path_counts, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || channels < 1 || batch < 0 ||
      height < 0 || width < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)batch * height * width == 0) return 0;
  FwdArgs a;
  for (int l = 0; l < kMaxLevels; ++l) {
    a.lv.ptr[l] = static_cast<const float*>(levels[l]);
    a.lv.h[l] = hs[l];
    a.lv.w[l] = ws[l];
  }
  a.fmap1 = fmap1;
  a.num_levels = num_levels;
  a.coords = static_cast<const float*>(coords);
  a.out = out;
  a.H = height;
  a.W = width;
  a.channels = channels;
  a.scale_div = scale_div;
  a.budget = budget;
  a.path_counts = static_cast<Count*>(path_counts);
  a.grid = dim3((unsigned)tiles_of(batch, height, width), (unsigned)num_levels);
  a.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (radius == 4) {
    err = rescale ? Widths::template launch<4, true>(a) : Widths::template launch<4, false>(a);
  } else if (radius == 3) {
    err = rescale ? Widths::template launch<3, true>(a) : Widths::template launch<3, false>(a);
  }
  return (int)err;
}

// -- the backward's shell -----------------------------------------------------
//
// The backward (corr_bwd.cu; the bf16 forms' own shared path is in
// corr_tile_bf16.cuh) folds the
// window's cotangents of each query into one coefficient per neighbour,
// coef[n] = dL/d(dot n), and then, for every in-range neighbour,
//   df1[q]   += coef[n] * f2_l[n]
//   df2_l[n] += coef[n] * f1[q]
// into float32 buffers that hold zeros. A block is (tile, level), as in the
// forward. Shared path: with G (64 x box) the dense coefficients of the
// tile (zero where a pixel is not a query's neighbour),
//   df1_tile (64 x C) = G . F2_box (box x C)
//   df2_box (box x C) = G^T . F1_tile (64 x C)
// in chunks of kBCC = 64 channels (outer) and kBNC = 64 box pixels (inner)
// on mma.sync, 8 warps as 4 x 2 tiles of 16 x 32; each df2 chunk is
// complete after its one product (K = the 64 queries) and is added to df2_l
// with one 16-byte vector atomic per box pixel and channel quad; df1 sums
// over the chunks in registers and over the levels by the same atomics.
// Warp path (a larger box, or a width with no tile form): one warp per
// query, lanes over C; each in-range neighbour's coefficient times the map
// into df1 (registers) and, by a vector atomic, into df2_l.
//
// A form of the backward (a struct) supplies
//   T                 the maps' type;
//   kProduct          the shared path's products: Product::k3xTF32;
//   kAnyWidth         whether C may be any width of the float32 lookup, or
//                     only 128 and 256 (RAFT-small's and RAFT-large's);
//   coef(c)           the coefficient as the warp path multiplies it;
//   load<Vec>(p)      Vec's floats of a map at p, as the products take them;
//   stage4(dst, src, ok): four channels of a map into shared memory as
//                     floats (zero unless ok), by cp.async where it can.

constexpr int kBNC = 64;          // box pixels per chunk
constexpr int kBCC = 64;          // channels per chunk
constexpr int kLd = kBCC + 8;     // row stride of F1c, F2c, O (floats)
constexpr int kLdg = kBNC + 8;    // row stride of G
constexpr int kRowCopies = kQ * (kBCC / 4) / kThreads;  // 4-channel copies a thread a tile
static_assert(kBNC == kQ, "F1c, F2c and O share a shape");
static_assert(kRowCopies * kThreads == kQ * (kBCC / 4), "copies split evenly");

enum class Product { k3xTF32 };

struct LevelGrads {
  float* ptr[kMaxLevels];
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two floats as a packed bfloat16 pair (lo in the low half), each rounded to
// nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One k8 step of a warp's 16 x 32 block: big[nt] and small[nt] += A (rows
// m0.., K k0..) . B (K k0.., columns n0 + 8 nt..) in 3xTF32, A's element
// (m, k) at a[m * am + k * ak], B's (k, n) at b[k * bk + n * bn].
template <Product P>
__device__ __forceinline__ void product_step(float (*big)[4], float (*small)[4], const float* a,
                                             int am, int ak, const float* b, int bk, int bn,
                                             int m0, int n0, int k0) {
  uint32_t ah[4], al[4], bh[2], bl[2];
  load_a(a, am, ak, m0, k0, ah, al);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    load_b(b, bk, bn, k0, n0 + 8 * nt, bh, bl);
    mma_3xtf32(big[nt], small[nt], ah, al, bh, bl);
  }
}

__device__ __forceinline__ void fma_vec(float4& acc, const float s, const float4 v) {
  acc.x += s * v.x;
  acc.y += s * v.y;
  acc.z += s * v.z;
  acc.w += s * v.w;
}

__device__ __forceinline__ void fma_vec(float2& acc, const float s, const float2 v) {
  acc.x += s * v.x;
  acc.y += s * v.y;
}

__device__ __forceinline__ void fma_vec(float& acc, const float s, const float v) { acc += s * v; }

__device__ __forceinline__ float4 scaled(const float s, const float4 v) {
  return make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
}

__device__ __forceinline__ float2 scaled(const float s, const float2 v) {
  return make_float2(s * v.x, s * v.y);
}

__device__ __forceinline__ float scaled(const float s, const float v) { return s * v; }

// coef (kQ x D*D): the cotangent of every dot of the tile's queries at
// level l, from the float32 cotangent g; zero for a slot past the image or
// a centre that is not near. Window (a, b) = (x index, y index) reads
// neighbour (a, b) with weight w00, (a+1, b) with w10, (a, b+1) with w01 and
// (a+1, b+1) with w11.
template <int R>
__device__ void fold_cotangents(const TileQueries& t, const float* __restrict__ grad,
                                int num_levels, int l, float inv_scale, float* coef) {
  constexpr int D = 2 * R + 2;
  constexpr int WIN = 2 * R + 1;
  for (int idx = threadIdx.x; idx < kQ * D * D; idx += kThreads) {
    const int qi = idx / (D * D);
    const int n = idx % (D * D);
    float c = 0.f;
    if (t.q[qi] >= 0 && t.near[qi]) {
      const long long off = t.q[qi] * (num_levels * WIN * WIN) + l * WIN * WIN;
      const float dx = t.dx[qi], dy = t.dy[qi];
      const int j = n / D;  // y index of the neighbour
      const int i = n % D;  // x index
      auto gs = [&](int a, int b) { return grad[off + a * WIN + b]; };
      const float w00 = (1.f - dx) * (1.f - dy);
      const float w10 = dx * (1.f - dy);
      const float w01 = (1.f - dx) * dy;
      const float w11 = dx * dy;
      if (i < WIN && j < WIN) c += w00 * gs(i, j);
      if (i > 0 && j < WIN) c += w10 * gs(i - 1, j);
      if (i < WIN && j > 0) c += w01 * gs(i, j - 1);
      if (i > 0 && j > 0) c += w11 * gs(i - 1, j - 1);
      c *= inv_scale;
    }
    coef[idx] = c;
  }
  __syncthreads();
}

// The shared path at one level: df1 and df2 of the tile through the box.
template <int R, class Form>
__device__ void tile_grads(const TileQueries& t, const typename Form::T* __restrict__ fmap1,
                           const typename Form::T* __restrict__ f2, float* __restrict__ d2,
                           int w2, int C, int nb, int bw, const float* coef,
                           float* __restrict__ df1, float* smem) {
  constexpr int D = 2 * R + 2;
  constexpr int DD = D * D;
  constexpr Product P = Form::kProduct;
  constexpr int kK = 8;  // K of one product step
  float* G = smem;                  // (query, box pixel of the chunk)
  float* F1c = G + kQ * kLdg;       // (query, channel of the chunk)
  float* F2c = F1c + kQ * kLd;      // (box pixel, channel)
  float* O = F2c + kBNC * kLd;      // a finished (64 x kBCC) block on its way out
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = (warp >> 1) * 16;  // the warp's rows: queries (df1) or pixels (df2)
  const int wc = (warp & 1) * 32;   // and channels of the chunk
  const int c16 = tid & 15;         // this thread's 4-channel column of a copy
  const int r0 = tid >> 4;          // and its first row, then every 16th
  const int gp = tid & (kBNC - 1);  // this thread's pixel of G
  for (int c0 = 0; c0 < C; c0 += kBCC) {
#pragma unroll
    for (int i = 0; i < kRowCopies; ++i) {
      const int row = r0 + 16 * i;
      const bool ok = t.q[row] >= 0;
      Form::stage4(F1c + row * kLd + 4 * c16, fmap1 + (ok ? t.q[row] * C : 0) + c0 + 4 * c16, ok);
    }
    cp_async_commit();
    float d1[4][4], d1s[4][4];  // the big and small sums
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d1[nt][e] = d1s[nt][e] = 0.f;
    for (int n0 = 0; n0 < nb; n0 += kBNC) {
#pragma unroll
      for (int i = 0; i < kRowCopies; ++i) {
        const int row = r0 + 16 * i;
        const int pix = n0 + row;
        const bool ok = pix < nb;
        const long long off =
            ok ? ((long long)(t.box[1] + pix / bw) * w2 + t.box[0] + pix % bw) * C : 0;
        Form::stage4(F2c + row * kLd + 4 * c16, f2 + off + c0 + 4 * c16, ok);
      }
      cp_async_commit();
      {
        const int pix = n0 + gp;
        const bool in = pix < nb;
        const int px = in ? t.box[0] + pix % bw : 0;
        const int py = in ? t.box[1] + pix / bw : 0;
#pragma unroll 4
        for (int k = 0; k < kQ / (kThreads / kBNC); ++k) {
          const int qi = tid / kBNC + (kThreads / kBNC) * k;
          const int i = px - t.x0[qi];
          const int j = py - t.y0[qi];
          G[qi * kLdg + gp] = (in && t.near[qi] && (unsigned)i < D && (unsigned)j < D)
                                  ? coef[qi * DD + j * D + i]
                                  : 0.f;
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // G, F2c (and F1c) in place for every thread
      const int kmax = min(kBNC, nb - n0);  // pixels of the chunk in the box
      float d2c[4][4], d2s[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d2c[nt][e] = d2s[nt][e] = 0.f;
      if (wr < kmax) {  // warp-uniform: its 16 pixel rows are not all padding
        // df2 chunk (pixel, channel) = G^T (pixel, query) . F1c (query, channel)
#pragma unroll 2
        for (int k0 = 0; k0 < kQ; k0 += kK) {
          product_step<P>(d2c, d2s, G, 1, kLdg, F1c, kLd, 1, wr, wc, k0);
        }
      }
      // df1 (query, channel) += G (query, pixel) . F2c (pixel, channel); the
      // pixels past the box are zero in G and F2c
      for (int k0 = 0; k0 < kmax; k0 += kK) {
        product_step<P>(d1, d1s, G, kLdg, 1, F2c, kLd, 1, wr, wc, k0);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(O + (wr + g + 8 * h) * kLd + wc + 8 * nt + 2 * tq) =
              make_float2(d2c[nt][2 * h] + d2s[nt][2 * h], d2c[nt][2 * h + 1] + d2s[nt][2 * h + 1]);
        }
      __syncthreads();  // the df2 chunk is in O
#pragma unroll
      for (int i = 0; i < kRowCopies; ++i) {
        const int row = r0 + 16 * i;
        const int pix = n0 + row;
        if (pix < nb) {
          const long long off =
              ((long long)(t.box[1] + pix / bw) * w2 + t.box[0] + pix % bw) * C;
          atomicAdd(reinterpret_cast<float4*>(d2 + off + c0 + 4 * c16),
                    *reinterpret_cast<const float4*>(O + row * kLd + 4 * c16));
        }
      }
      __syncthreads();  // G, F2c and O are rewritten by the next chunk
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(O + (wr + g + 8 * h) * kLd + wc + 8 * nt + 2 * tq) =
            make_float2(d1[nt][2 * h] + d1s[nt][2 * h], d1[nt][2 * h + 1] + d1s[nt][2 * h + 1]);
      }
    __syncthreads();  // the tile's df1 block is in O
#pragma unroll
    for (int i = 0; i < kRowCopies; ++i) {
      const int row = r0 + 16 * i;
      if (t.q[row] >= 0 && t.near[row]) {
        atomicAdd(reinterpret_cast<float4*>(df1 + t.q[row] * C + c0 + 4 * c16),
                  *reinterpret_cast<const float4*>(O + row * kLd + 4 * c16));
      }
    }
    __syncthreads();  // F1c and O are rewritten by the next channel chunk
  }
}

// The warp path: warp w takes query slots w, w + kWarps, ...; lane l holds
// the Vecs l + 32 v, v < NV, of each row (kMasked: the lanes past C none).
template <int R, int NV, typename Vec, bool kMasked, class Form>
__device__ void warp_grads(const TileQueries& t, const typename Form::T* __restrict__ fmap1,
                           const typename Form::T* __restrict__ f2, float* __restrict__ d2,
                           int h2, int w2, int C, const float* coef_all,
                           float* __restrict__ df1) {
  constexpr int D = 2 * R + 2;
  constexpr int kLen = sizeof(Vec) / sizeof(float);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int qi = warp; qi < kQ; qi += kWarps) {
    const long long q = t.q[qi];
    if (q < 0 || !t.near[qi]) continue;  // warp-uniform
    const float* coef = coef_all + qi * D * D;
    Vec a[NV];
    Vec acc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int ch = kLen * (lane + 32 * v);
      a[v] = (!kMasked || ch < C) ? Form::template load<Vec>(fmap1 + q * C + ch) : Vec{};
      acc[v] = Vec{};
    }
    const int x0 = t.x0[qi];
    const int y0 = t.y0[qi];
    for (int j = 0; j < D; ++j) {
      const int yy = y0 + j;
      if (yy < 0 || yy >= h2) continue;  // uniform across the warp
      for (int i = 0; i < D; ++i) {
        const int xx = x0 + i;
        float c = coef[j * D + i];
        if (xx < 0 || xx >= w2 || c == 0.f) continue;
        c = Form::coef(c);
        const long long off = ((long long)yy * w2 + xx) * C;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int ch = kLen * (lane + 32 * v);
          if (!kMasked || ch < C) {
            fma_vec(acc[v], c, Form::template load<Vec>(f2 + off + ch));
            atomicAdd(reinterpret_cast<Vec*>(d2 + off + ch), scaled(c, a[v]));
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int ch = kLen * (lane + 32 * v);
      if (!kMasked || ch < C) atomicAdd(reinterpret_cast<Vec*>(df1 + q * C + ch), acc[v]);
    }
  }
}

// One block of the backward: the tile and its box at level blockIdx.y, the
// fold, and the path. The width is C = 32 NV floats of Vec, or `channels`
// (kMasked: under 128, warp path only).
template <int R, int NV, typename Vec, bool kMasked, class Form>
__global__ void __launch_bounds__(kThreads, 2)
corr_bwd_kernel(const typename Form::T* __restrict__ fmap1, const Levels lv,
                const int num_levels, const float* __restrict__ coords,
                const void* __restrict__ grad, const int grad_bf16, float* __restrict__ df1,
                const LevelGrads dlv, const int H, const int W, const int channels,
                const int rescale, const float inv_scale, const int budget,
                Count* __restrict__ path_counts) {
  using T = typename Form::T;
  constexpr int D = 2 * R + 2;
  extern __shared__ float4 smem4[];
  float* coef = reinterpret_cast<float*>(smem4);  // kQ x D*D
  __shared__ TileQueries t;
  const int C = kMasked ? channels : 32 * NV * (int)(sizeof(Vec) / sizeof(float));
  const int l = blockIdx.y;
  const int h2 = lv.h[l], w2 = lv.w[l];
  if (rescale) {
    load_tile<R, true>(t, coords, H, W, l, h2, w2);
  } else {
    load_tile<R, false>(t, coords, H, W, l, h2, w2);
  }
  int bw;
  const int nb = box_pixels(t, bw);
  const long long base = (long long)t.b * h2 * w2 * C;
  const T* f2 = reinterpret_cast<const T*>(lv.ptr[l]) + base;
  float* d2 = dlv.ptr[l] + base;
  const bool shared = choose_path(!kMasked, nb, budget, path_counts);
  if (nb == 0) return;  // no query of the tile has a neighbour on this level
  fold_cotangents<R>(t, static_cast<const float*>(grad), num_levels, l, inv_scale, coef);
  if (!shared) {
    warp_grads<R, NV, Vec, kMasked, Form>(t, fmap1, f2, d2, h2, w2, C, coef, df1);
    return;
  }
  if constexpr (!kMasked) {
    tile_grads<R, Form>(t, fmap1, f2, d2, w2, C, nb, bw, coef, df1, coef + kQ * D * D);
  }
}

// Dynamic shared memory: coef, then the shared path's G, F1c, F2c and O.
template <int R, bool kMasked>
constexpr int bwd_smem_bytes() {
  return (kQ * (2 * R + 2) * (2 * R + 2) +
          (kMasked ? 0 : kQ * kLdg + kQ * kLd + 2 * kBNC * kLd)) * 4;
}

// A backward launch's arguments, checked by bwd_entry.
struct BwdArgs {
  const void* fmap1;
  Levels lv;
  int num_levels;
  const float* coords;
  const void* grad;
  int grad_bf16;
  float* df1;
  LevelGrads dlv;
  int H, W, channels, rescale;
  float inv_scale;
  int budget;
  Count* path_counts;
  dim3 grid;
  cudaStream_t stream;
};

template <int R, int NV, typename Vec, bool kMasked, class Form>
cudaError_t launch_bwd(const BwdArgs& a) {
  using T = typename Form::T;
  auto kernel = corr_bwd_kernel<R, NV, Vec, kMasked, Form>;
  constexpr int bytes = bwd_smem_bytes<R, kMasked>();
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<a.grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.fmap1), a.lv, a.num_levels, a.coords, a.grad, a.grad_bf16, a.df1,
      a.dlv, a.H, a.W, a.channels, a.rescale, a.inv_scale, a.budget, a.path_counts);
  return cudaGetLastError();
}

// The widths, with the forward's lanes (corr_fwd.cu): C a multiple of 128:
// NV = C / 128 float4s a lane; C = 64 or 192: NV = C / 64 float2s a lane;
// another C under 128: NV = ceil(C / 32) masked floats a lane. A form
// without kAnyWidth takes 128 and 256 only.
template <int R, class Form>
cudaError_t launch_bwd_width(const BwdArgs& a) {
  switch (a.channels) {
    case 128: return launch_bwd<R, 1, float4, false, Form>(a);
    case 256: return launch_bwd<R, 2, float4, false, Form>(a);
    default: break;
  }
  if constexpr (Form::kAnyWidth) {
    switch (a.channels) {
      case 64: return launch_bwd<R, 1, float2, false, Form>(a);
      case 192: return launch_bwd<R, 3, float2, false, Form>(a);
      case 384: return launch_bwd<R, 3, float4, false, Form>(a);
      case 512: return launch_bwd<R, 4, float4, false, Form>(a);
      default: break;
    }
    if (a.channels < 1 || a.channels >= 128) return cudaErrorInvalidValue;
    switch ((a.channels + 31) / 32) {
      case 1: return launch_bwd<R, 1, float, true, Form>(a);
      case 2: return launch_bwd<R, 2, float, true, Form>(a);
      case 3: return launch_bwd<R, 3, float, true, Form>(a);
      default: return launch_bwd<R, 4, float, true, Form>(a);
    }
  }
  return cudaErrorInvalidValue;
}

// The backward entries' body: checks the arguments and runs
// Forms::launch<R>(args, maps_bf16, mxu_bf16), which picks the form, at
// radius 4 or 3. Returns a cudaError_t (0 on success).
template <class Forms>
int bwd_entry(const void* fmap1, const void* const* levels, const int* hs, const int* ws,
              int num_levels, const void* coords, const void* grad, void* df1,
              void* const* dlevels, int batch, int height, int width, int channels, int radius,
              int rescale, float inv_scale, int budget, int maps_bf16, int grad_bf16,
              int mxu_bf16, void* path_counts, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || channels < 1 || batch < 0 ||
      height < 0 || width < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)batch * height * width == 0) return 0;
  BwdArgs a;
  for (int l = 0; l < kMaxLevels; ++l) {
    a.lv.ptr[l] = static_cast<const float*>(levels[l]);
    a.lv.h[l] = hs[l];
    a.lv.w[l] = ws[l];
    a.dlv.ptr[l] = static_cast<float*>(dlevels[l]);
  }
  a.fmap1 = fmap1;
  a.num_levels = num_levels;
  a.coords = static_cast<const float*>(coords);
  a.grad = grad;
  a.grad_bf16 = grad_bf16;
  a.df1 = static_cast<float*>(df1);
  a.H = height;
  a.W = width;
  a.channels = channels;
  a.rescale = rescale;
  a.inv_scale = inv_scale;
  a.budget = budget;
  a.path_counts = static_cast<Count*>(path_counts);
  a.grid = dim3((unsigned)tiles_of(batch, height, width), (unsigned)num_levels);
  a.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (radius == 4) {
    err = Forms::template launch<4>(a, maps_bf16, mxu_bf16);
  } else if (radius == 3) {
    err = Forms::template launch<3>(a, maps_bf16, mxu_bf16);
  }
  return (int)err;
}

}  // namespace corr_tile
