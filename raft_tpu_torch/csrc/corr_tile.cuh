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
// The forward's kernel, corr_fwd_kernel below, is one shell over two forms
// of its paths: the float32 form (corr_fwd.cu) and the bf16 form
// (corr_fwd_bf16.cu), each its own translation unit so that both build at
// once.
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

// The forward's shared path (corr_fwd.cu, and its bf16 form in
// corr_fwd_bf16.cu): the box in chunks of kNC pixels, C in stages of kKC
// channels, a staged float row kLdk floats apart (conflict-free fragments).
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

}  // namespace corr_tile
