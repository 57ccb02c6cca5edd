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
// tile, box and path rule; the TPU kernel's two matmuls per chunk
// (df1 += g2^T f2, df2 += g2 f1) on the tensor cores. The block first folds
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

constexpr int kBNC = 64;          // box pixels per chunk
constexpr int kBCC = 64;          // channels per chunk
constexpr int kLd = kBCC + 8;     // row stride of F1c, F2c, O
constexpr int kLdg = kBNC + 8;    // row stride of G
constexpr int kRowCopies = kQ * (kBCC / 4) / kThreads;  // 16-byte copies a thread a tile
static_assert(kBNC == kQ, "F1c, F2c and O share a shape");
static_assert(kRowCopies * kThreads == kQ * (kBCC / 4), "copies split evenly");

struct LevelGrads {
  float* ptr[kMaxLevels];
};

__device__ __forceinline__ void fma(float4& acc, const float s, const float4 v) {
  acc.x += s * v.x;
  acc.y += s * v.y;
  acc.z += s * v.z;
  acc.w += s * v.w;
}

__device__ __forceinline__ void fma(float2& acc, const float s, const float2 v) {
  acc.x += s * v.x;
  acc.y += s * v.y;
}

__device__ __forceinline__ void fma(float& acc, const float s, const float v) { acc += s * v; }

__device__ __forceinline__ float4 scaled(const float s, const float4 v) {
  return make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
}

__device__ __forceinline__ float2 scaled(const float s, const float2 v) {
  return make_float2(s * v.x, s * v.y);
}

__device__ __forceinline__ float scaled(const float s, const float v) { return s * v; }

// coef (kQ x D*D): the cotangent of every dot of the tile's queries at level
// l; zero for a slot past the image or a centre that is not near.
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
      const float* g = grad + t.q[qi] * (num_levels * WIN * WIN) + l * WIN * WIN;
      const float dx = t.dx[qi], dy = t.dy[qi];
      // Window (i, j) reads neighbour (i, j) with weight w00, (i+1, j) with
      // w10, (i, j+1) with w01 and (i+1, j+1) with w11 (x index first).
      const float w00 = (1.f - dx) * (1.f - dy);
      const float w10 = dx * (1.f - dy);
      const float w01 = (1.f - dx) * dy;
      const float w11 = dx * dy;
      const int j = n / D;  // y index of the neighbour
      const int i = n % D;  // x index
      if (i < WIN && j < WIN) c += w00 * g[i * WIN + j];
      if (i > 0 && j < WIN) c += w10 * g[(i - 1) * WIN + j];
      if (i < WIN && j > 0) c += w01 * g[i * WIN + j - 1];
      if (i > 0 && j > 0) c += w11 * g[(i - 1) * WIN + j - 1];
      c *= inv_scale;
    }
    coef[idx] = c;
  }
  __syncthreads();
}

// The shared path at one level: df1 and df2 of the tile through the box.
template <int R>
__device__ void tile_grads(const TileQueries& t, const float* __restrict__ fmap1,
                           const float* __restrict__ f2, float* __restrict__ d2, int w2, int C,
                           int nb, int bw, const float* coef, float* __restrict__ df1,
                           float* smem) {
  constexpr int D = 2 * R + 2;
  constexpr int DD = D * D;
  float* G = smem;                  // (query, box pixel of the chunk)
  float* F1c = G + kQ * kLdg;       // (query, channel of the chunk)
  float* F2c = F1c + kQ * kLd;      // (box pixel, channel)
  float* O = F2c + kBNC * kLd;      // a finished (64 x kBCC) block on its way out
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = (warp >> 1) * 16;  // the warp's rows: queries (df1) or pixels (df2)
  const int wc = (warp & 1) * 32;   // and channels of the chunk
  const int c16 = tid & 15;         // this thread's 16-byte column of a copy
  const int r0 = tid >> 4;          // and its first row, then every 16th
  const int gp = tid & (kBNC - 1);  // this thread's pixel of G
  for (int c0 = 0; c0 < C; c0 += kBCC) {
#pragma unroll
    for (int i = 0; i < kRowCopies; ++i) {
      const int row = r0 + 16 * i;
      const bool ok = t.q[row] >= 0;
      cp_async16(F1c + row * kLd + 4 * c16, fmap1 + (ok ? t.q[row] * C : 0) + c0 + 4 * c16, ok);
    }
    cp_async_commit();
    float d1[4][4], d1s[4][4];  // mma_3xtf32's big and small sums
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
        cp_async16(F2c + row * kLd + 4 * c16, f2 + off + c0 + 4 * c16, ok);
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
        for (int k0 = 0; k0 < kQ; k0 += 8) {
          uint32_t ah[4], al[4], bh[2], bl[2];
          load_a(G, 1, kLdg, wr, k0, ah, al);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            load_b(F1c, kLd, 1, k0, wc + 8 * nt, bh, bl);
            mma_3xtf32(d2c[nt], d2s[nt], ah, al, bh, bl);
          }
        }
      }
      // df1 (query, channel) += G (query, pixel) . F2c (pixel, channel)
      for (int k0 = 0; k0 < kmax; k0 += 8) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        load_a(G, kLdg, 1, wr, k0, ah, al);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          load_b(F2c, kLd, 1, k0, wc + 8 * nt, bh, bl);
          mma_3xtf32(d1[nt], d1s[nt], ah, al, bh, bl);
        }
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

// The warp path: warp w takes query slots w, w + kWarps, ... Vec, NV,
// kMasked: the lanes' loads of fmap1[q].
template <int R, int NV, typename Vec, bool kMasked>
__device__ void warp_grads(const TileQueries& t, const float* __restrict__ fmap1,
                           const float* __restrict__ f2, float* __restrict__ d2, int h2, int w2,
                           int C, const float* coef_all, float* __restrict__ df1) {
  constexpr int D = 2 * R + 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int qi = warp; qi < kQ; qi += kWarps) {
    const long long q = t.q[qi];
    if (q < 0 || !t.near[qi]) continue;  // warp-uniform
    const float* coef = coef_all + qi * D * D;
    Vec a[NV];
    Vec acc[NV];
    const Vec* f1 = reinterpret_cast<const Vec*>(fmap1 + q * C);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      a[v] = (!kMasked || lane + 32 * v < C) ? __ldg(f1 + lane + 32 * v) : Vec{};
      acc[v] = Vec{};
    }
    const int x0 = t.x0[qi];
    const int y0 = t.y0[qi];
    for (int j = 0; j < D; ++j) {
      const int yy = y0 + j;
      if (yy < 0 || yy >= h2) continue;  // uniform across the warp
      for (int i = 0; i < D; ++i) {
        const int xx = x0 + i;
        const float c = coef[j * D + i];
        if (xx < 0 || xx >= w2 || c == 0.f) continue;
        const long long off = ((long long)yy * w2 + xx) * C;
        const Vec* p = reinterpret_cast<const Vec*>(f2 + off);
        Vec* o = reinterpret_cast<Vec*>(d2 + off);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          if (!kMasked || lane + 32 * v < C) {
            fma(acc[v], c, __ldg(p + lane + 32 * v));
            atomicAdd(o + lane + 32 * v, scaled(c, a[v]));
          }
        }
      }
    }
    Vec* out = reinterpret_cast<Vec*>(df1 + q * C);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!kMasked || lane + 32 * v < C) atomicAdd(out + lane + 32 * v, acc[v]);
    }
  }
}

template <int R, bool kRescale, int NV, typename Vec, bool kMasked>
__global__ void __launch_bounds__(kThreads, 2)
corr_bwd_kernel(const float* __restrict__ fmap1, const Levels lv, const int num_levels,
                const float* __restrict__ coords, const float* __restrict__ grad,
                float* __restrict__ df1, const LevelGrads dlv, const int H, const int W,
                const int channels, const float inv_scale, const int budget,
                Count* __restrict__ path_counts) {
  constexpr int D = 2 * R + 2;
  extern __shared__ float4 smem4[];
  float* coef = reinterpret_cast<float*>(smem4);  // kQ x D*D
  __shared__ TileQueries t;
  const int C = kMasked ? channels : 32 * NV * (int)(sizeof(Vec) / sizeof(float));
  const int l = blockIdx.y;
  const int h2 = lv.h[l], w2 = lv.w[l];
  load_tile<R, kRescale>(t, coords, H, W, l, h2, w2);
  int bw;
  const int nb = box_pixels(t, bw);
  const long long base = (long long)t.b * h2 * w2 * C;
  const float* f2 = lv.ptr[l] + base;
  float* d2 = dlv.ptr[l] + base;
  const bool shared = choose_path(!kMasked, nb, budget, path_counts);
  if (nb == 0) return;  // no query of the tile has a neighbour on this level
  fold_cotangents<R>(t, grad, num_levels, l, inv_scale, coef);
  if (!shared) {
    warp_grads<R, NV, Vec, kMasked>(t, fmap1, f2, d2, h2, w2, C, coef, df1);
    return;
  }
  if constexpr (!kMasked) tile_grads<R>(t, fmap1, f2, d2, w2, C, nb, bw, coef, df1,
                                        coef + kQ * D * D);
}

// Dynamic shared memory: coef, then the shared path's G, F1c, F2c and O.
template <int R, bool kMasked>
constexpr int smem_bytes() {
  return (kQ * (2 * R + 2) * (2 * R + 2) +
          (kMasked ? 0 : kQ * kLdg + kQ * kLd + 2 * kBNC * kLd)) * 4;
}

template <int R, bool kRescale, int NV, typename Vec, bool kMasked>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* fmap1, const Levels& lv,
                   int num_levels, const float* coords, const float* grad, float* df1,
                   const LevelGrads& dlv, int H, int W, int channels, float inv_scale,
                   int budget, Count* path_counts) {
  auto kernel = corr_bwd_kernel<R, kRescale, NV, Vec, kMasked>;
  constexpr int bytes = smem_bytes<R, kMasked>();
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, kThreads, bytes, stream>>>(fmap1, lv, num_levels, coords, grad, df1, dlv, H, W,
                                            channels, inv_scale, budget, path_counts);
  return cudaGetLastError();
}

// The forward's lanes (csrc/corr_fwd.cu): C a multiple of 128: NV = C / 128
// float4s a lane; C = 64 or 192: NV = C / 64 float2s a lane; another C under
// 128: NV = ceil(C / 32) masked floats a lane.
template <int R, bool kRescale>
cudaError_t launch_width(int channels, dim3 grid, cudaStream_t stream, const float* fmap1,
                         const Levels& lv, int num_levels, const float* coords,
                         const float* grad, float* df1, const LevelGrads& dlv, int H, int W,
                         float inv_scale, int budget, Count* path_counts) {
#define CORR_LAUNCH(NV, VEC, MASKED)                                                          \
  launch<R, kRescale, NV, VEC, MASKED>(grid, stream, fmap1, lv, num_levels, coords, grad, df1, \
                                       dlv, H, W, channels, inv_scale, budget, path_counts)
  switch (channels) {
    case 64: return CORR_LAUNCH(1, float2, false);
    case 128: return CORR_LAUNCH(1, float4, false);
    case 192: return CORR_LAUNCH(3, float2, false);
    case 256: return CORR_LAUNCH(2, float4, false);
    case 384: return CORR_LAUNCH(3, float4, false);
    case 512: return CORR_LAUNCH(4, float4, false);
    default: break;
  }
  if (channels < 1 || channels >= 128) return cudaErrorInvalidValue;
  switch ((channels + 31) / 32) {
    case 1: return CORR_LAUNCH(1, float, true);
    case 2: return CORR_LAUNCH(2, float, true);
    case 3: return CORR_LAUNCH(3, float, true);
    default: return CORR_LAUNCH(4, float, true);
  }
#undef CORR_LAUNCH
}

template <int R>
cudaError_t launch_radius(int rescale, int channels, dim3 grid, cudaStream_t stream,
                          const float* fmap1, const Levels& lv, int num_levels,
                          const float* coords, const float* grad, float* df1,
                          const LevelGrads& dlv, int H, int W, float inv_scale, int budget,
                          Count* path_counts) {
  return rescale ? launch_width<R, true>(channels, grid, stream, fmap1, lv, num_levels, coords,
                                         grad, df1, dlv, H, W, inv_scale, budget, path_counts)
                 : launch_width<R, false>(channels, grid, stream, fmap1, lv, num_levels,
                                          coords, grad, df1, dlv, H, W, inv_scale, budget,
                                          path_counts);
}

}  // namespace

// fmap1 (B, H, W, C), level l (B, h_l, w_l, C), coords (B, H, W, 2) at level-0
// scale, grad (B, H, W, L * (2r+1)^2), df1 (B, H, W, C) and dlevel l
// (B, h_l, w_l, C): all float32, contiguous, 16-byte aligned; df1 and each
// dlevel must hold zeros (the kernel adds into them). C is 64, 128, 192,
// 256, 384, 512 or under 128; radius is 3 or 4; 1 <= L <= 4; rescale 1
// samples level l around coords / 2^l, 0 around coords. inv_scale is
// 1/sqrt(C), or 1 without the scale. budget and path_counts as for
// raft_corr_fwd. Returns a cudaError_t (0 on success); launches on `stream`.
extern "C" int raft_corr_bwd(const void* fmap1, const void* level0, const void* level1,
                             const void* level2, const void* level3, int h0, int w0,
                             int h1, int w1, int h2, int w2, int h3, int w3,
                             int num_levels, const void* coords, const void* grad,
                             void* df1, void* dlevel0, void* dlevel1, void* dlevel2,
                             void* dlevel3, int batch, int height, int width, int channels,
                             int radius, int rescale, float inv_scale, int budget,
                             void* path_counts, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || channels < 1 || batch < 0 ||
      height < 0 || width < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)batch * height * width == 0) return 0;
  Levels lv;
  LevelGrads dlv;
  const void* ptrs[kMaxLevels] = {level0, level1, level2, level3};
  void* dptrs[kMaxLevels] = {dlevel0, dlevel1, dlevel2, dlevel3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.ptr[l] = static_cast<const float*>(ptrs[l]);
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
    dlv.ptr[l] = static_cast<float*>(dptrs[l]);
  }
  const dim3 grid((unsigned)tiles_of(batch, height, width), (unsigned)num_levels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f1 = static_cast<const float*>(fmap1);
  const float* c = static_cast<const float*>(coords);
  const float* g = static_cast<const float*>(grad);
  float* d1 = static_cast<float*>(df1);
  Count* counts = static_cast<Count*>(path_counts);
  cudaError_t err;
  if (radius == 4) {
    err = launch_radius<4>(rescale, channels, grid, s, f1, lv, num_levels, c, g, d1, dlv,
                           height, width, inv_scale, budget, counts);
  } else if (radius == 3) {
    err = launch_radius<3>(rescale, channels, grid, s, f1, lv, num_levels, c, g, d1, dlv,
                           height, width, inv_scale, budget, counts);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
