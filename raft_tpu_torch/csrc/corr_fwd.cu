// On-demand windowed correlation, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of raft_tpu/ops/corr_pallas.py
// (reached through `_pallas_fwd`, :373, from
// `windowed_correlation_pallas_fused`, :568): for every query pixel q and
// every pooled target level l, dot fmap1[q] with the bilinear samples (zero
// padding) of level l in a (2r+1)^2 window around coords[q] / 2^l, divided
// by sqrt(C). With rescale = 0 every level is sampled around coords[q]
// itself (the sparse family's lookup, the TPU kernel's `rescale=False`). All
// levels run in one launch; the output is level-major and window channel
// i*(2r+1)+j samples (x + i - r, y + j - r): the first window axis moves x.
//
// Both paths compute the dots d[n] = f1[q] . f2_l[n] over the (2r+2)^2
// integer neighbours n of (floor(cx) - r, floor(cy) - r), zero where n lies
// off the level, and then out[i, j] = (w00 d[i, j] + w10 d[i+1, j] +
// w01 d[i, j+1] + w11 d[i+1, j+1]) / sqrt(C) with the four bilinear corner
// weights: (2r+2)^2 dots per query and level instead of 4 (2r+1)^2 samples.
//
// Bound on an H100 SXM (Sintel, B=1, 55x128 queries, C=256, 4 levels, r=4):
// about 1.44 GFLOP of f32-grade products for the in-range neighbours, 21 us
// at 67 TFLOP/s (f32 SIMT), 9 us at 495 / 3 = 165 TFLOP/s (3xTF32 on the
// tensor cores), against about 26 MB of compulsory traffic, 8 us at 3.35
// TB/s: bound by operations. chip_smoke.py counts this run's in-range
// neighbours for the exact bounds.
//
// Design: one block per (tile of 8 x 8 queries, level), the scheme of the
// TPU kernel (a tile of queries times a band of f2 rows in one matmul) on
// the tensor cores; corr_tile.cuh has the tile, its box, the path rule and
// the kernel's shell (corr_fwd_kernel), which this file fills with the
// float32 form of the two paths.
//   Shared path (box <= budget pixels): S = F1_tile (64 x C) . F2_box^T
//   (C x box), the box in chunks of kNC = 128 pixels, C in stages of kKC =
//   32 channels through a double-buffered cp.async ring (both operands are
//   K-major in NHWC: a pixel's channels are contiguous), 3xTF32 mma.sync
//   m16n8k8, 8 warps as 2 x 4 tiles of 32 x 32. Each query keeps its
//   (2r+2)^2 entries of S in shared memory (the rest of its row, pixels
//   outside its window, is dropped), and the epilogue above runs from there.
//   Every f2 row of the box is read from L2 once per (tile, level) and
//   reused by all 64 queries; the warp path reads it once per query.
//   Warp path (a larger box, or a C with no tile form): one warp per query,
//   alt_cuda_corr's scheme. The warp keeps fmap1[q] in registers, walks the
//   in-level neighbours, dots each over C (float4 loads for C a multiple of
//   128, float2 for C = 64 and 192, masked floats for another C under 128;
//   a shuffle reduction) and parks the dots in shared memory.
//
// What was hard, and what the design does about it:
// - TF32 wgmma takes K-major operands only; mma.sync takes fragments loaded
//   in any order from shared memory. Here both operands are K-major, but the
//   backward's are not (corr_bwd.cu), and one code serves both: mma.sync.
// - Both operands are activations, so neither can be split ahead of time:
//   both are split hi/lo in registers after each fragment load.
// - The tensor cores round their sums toward zero, which drifts in a long
//   chain of products: each k8 step's large product is a fresh sum added in
//   f32 (corr_tile.cuh, mma_3xtf32, says what a partial sum per stage, the
//   conv tile's scheme, did to a train step).
// - A box is ragged (its size varies per tile and level): it is flattened
//   row-major and padded to the chunk with zero-filled copies (cp.async of
//   size 0), and a warp whose 32 columns lie past it skips its products.
//   The box never leaves the level, and a neighbour off the level keeps the
//   zero it was given: zero padding stays exact.
// - The box grows with the spread of the tile's flows, so scattered flows
//   would multiply far more pixels than the tile needs: such a (tile,
//   level) takes the warp path, whose cost does not grow with the box.
// - Sintel's 55 x 128 queries make only 112 tiles for 132 SMs: the level is
//   a grid dimension (448 blocks).
//
// The bf16 form (mxu_dtype = "bfloat16") is corr_fwd_bf16.cu, a kernel of
// its own on the same tile, box and path rule.

#include <cuda_runtime.h>

#include "corr_tile.cuh"

namespace {

using namespace corr_tile;

constexpr int kStageFloats = (kQ + kNC) * kLdk;
constexpr int kCopies = (kQ + kNC) * (kKC / 4) / kThreads;  // 16-byte copies a thread a stage
static_assert(kCopies * kThreads == (kQ + kNC) * (kKC / 4), "copies split evenly");
static_assert(kThreads / (kKC / 4) * kCopies == kQ + kNC,
              "a thread's rows are kThreads / 8 apart");

__device__ __forceinline__ float dot(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float dot(const float2 a, const float2 b) {
  return a.x * b.x + a.y * b.y;
}

__device__ __forceinline__ float dot(const float a, const float b) { return a * b; }

// The shared path: the dots of every query of the tile into S (kQ x D*D).
template <int R>
__device__ void tile_dots(const TileQueries& t, const float* __restrict__ fmap1,
                          const float* __restrict__ f2, int w2, int C, int nb, int bw, float* S,
                          float* stage) {
  constexpr int D = 2 * R + 2;
  constexpr int DD = D * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 2) * 32;  // the warp's 32 x 32 block of the chunk
  const int wn = (warp & 3) * 32;
  const int c4 = tid & 7;           // this thread's 16-byte column of a stage
  for (int i = tid; i < kQ * DD; i += kThreads) S[i] = 0.f;
  for (int n0 = 0; n0 < nb; n0 += kNC) {
    // Sources of this thread's rows of a stage: F1 rows (queries), then the
    // chunk's box pixels; a row past the image or the box is zero-filled.
    const float* src[kCopies];
    bool ok[kCopies];
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int row = (tid >> 3) + (kThreads / 8) * i;
      if (row < kQ) {
        ok[i] = t.q[row] >= 0;
        src[i] = fmap1 + (ok[i] ? t.q[row] * C : 0);
      } else {
        const int pix = n0 + row - kQ;
        ok[i] = pix < nb;
        src[i] = f2 + (ok[i] ? ((long long)(t.box[1] + pix / bw) * w2 + t.box[0] + pix % bw) * C
                             : 0);
      }
    }
    auto load = [&](int ks, float* buf) {
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int row = (tid >> 3) + (kThreads / 8) * i;
        cp_async16(buf + row * kLdk + 4 * c4, src[i] + ks * kKC + 4 * c4, ok[i]);
      }
      cp_async_commit();
    };
    const bool active = n0 + wn < nb;  // warp-uniform: its columns hold box pixels
    float acc[2][4][4], sml[2][4][4];  // mma_3xtf32's big and small sums
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = sml[mt][nt][e] = 0.f;
    const int nks = C / kKC;
    load(0, stage);
    for (int ks = 0; ks < nks; ++ks) {
      if (ks + 1 < nks) {
        load(ks + 1, stage + ((ks + 1) & 1) * kStageFloats);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // stage ks landed for every thread
      if (active) {
        const float* A = stage + (ks & 1) * kStageFloats;  // F1: (query, channel)
        const float* B = A + kQ * kLdk;                    // box: (pixel, channel)
#pragma unroll
        for (int k0 = 0; k0 < kKC; k0 += 8) {
          uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) load_a(A, kLdk, 1, wm + 16 * mt, k0, ah[mt], al[mt]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) load_b(B, 1, kLdk, k0, wn + 8 * nt, bh[nt], bl[nt]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_3xtf32(acc[mt][nt], sml[mt][nt], ah[mt], al[mt], bh[nt], bl[nt]);
        }
      }
      __syncthreads();  // every warp is done with stage ks before it is refilled
    }
    // Keep each query's window entries of the chunk: entry (q, pixel) is
    // the dot of neighbour (i, j) of q if the pixel is that neighbour.
    if (active) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = wm + 16 * mt + g + 8 * (e >> 1);
            const int pix = n0 + wn + 8 * nt + 2 * tq + (e & 1);
            if (pix >= nb || !t.near[qi]) continue;
            const int i = t.box[0] + pix % bw - t.x0[qi];
            const int j = t.box[1] + pix / bw - t.y0[qi];
            if ((unsigned)i < D && (unsigned)j < D) {
              S[qi * DD + j * D + i] = acc[mt][nt][e] + sml[mt][nt][e];
            }
          }
    }
  }
  __syncthreads();
}

// The warp path: warp w computes the dots of query slots w, w + kWarps, ...
// and writes their windows. Vec, NV, kMasked: the lanes' loads of fmap1[q].
template <int R, int NV, typename Vec, bool kMasked>
__device__ void warp_queries(const TileQueries& t, const float* __restrict__ fmap1,
                             const float* __restrict__ f2, int h2, int w2, int C,
                             float* dots_all, float* __restrict__ out, int out_stride,
                             int out_off, float scale_div) {
  constexpr int D = 2 * R + 2;
  constexpr int WIN = 2 * R + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* dots = dots_all + warp * D * D;
  for (int qi = warp; qi < kQ; qi += kWarps) {
    const long long q = t.q[qi];
    if (q < 0) continue;  // warp-uniform
    Vec a[NV];
    const Vec* f1 = reinterpret_cast<const Vec*>(fmap1 + q * C);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      a[v] = (!kMasked || lane + 32 * v < C) ? __ldg(f1 + lane + 32 * v) : Vec{};
    }
    const bool near = t.near[qi];
    const int x0 = t.x0[qi];
    const int y0 = t.y0[qi];
    for (int j = 0; j < D; ++j) {  // neighbour row: y moves
      const int yy = y0 + j;
      const bool row_in = near && yy >= 0 && yy < h2;
      float s[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {  // neighbour column: x moves
        const int xx = x0 + i;
        s[i] = 0.f;
        if (row_in && xx >= 0 && xx < w2) {  // uniform across the warp
          const Vec* p = reinterpret_cast<const Vec*>(f2 + ((long long)yy * w2 + xx) * C);
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            if (!kMasked || lane + 32 * v < C) s[i] += dot(a[v], __ldg(p + lane + 32 * v));
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < D; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < D; ++i) dots[j * D + i] = s[i];
      }
    }
    __syncwarp();
    for (int k = lane; k < WIN * WIN; k += 32) {
      out[q * out_stride + out_off + k] = window_value<R>(t, qi, dots, k) / scale_div;
    }
    __syncwarp();  // dots is rewritten by the next query
  }
}

// The float32 form at one width: NV loads of type Vec a lane on the warp
// path; kMasked, a C under 128 in masked floats, has no shared path.
template <int NV, typename Vec, bool kMasked>
struct Float32Form {
  using T = float;
  static constexpr bool kTileForm = !kMasked;
  __device__ __forceinline__ static int channels(int c) {
    return kMasked ? c : 32 * NV * (int)(sizeof(Vec) / sizeof(float));
  }
  template <int R>
  static constexpr int smem_bytes() {
    return kMasked ? kWarps * (2 * R + 2) * (2 * R + 2) * 4
                   : (kQ * (2 * R + 2) * (2 * R + 2) + 2 * kStageFloats) * 4;
  }
  template <int R>
  __device__ __forceinline__ static void shared_path(const TileQueries& t,
                                                     const float* __restrict__ fmap1,
                                                     const float* __restrict__ f2, int w2, int C,
                                                     int nb, int bw, float* S, float* stage) {
    tile_dots<R>(t, fmap1, f2, w2, C, nb, bw, S, stage);
  }
  template <int R>
  __device__ __forceinline__ static void warp_path(const TileQueries& t,
                                                   const float* __restrict__ fmap1,
                                                   const float* __restrict__ f2, int h2, int w2,
                                                   int C, float* dots, float* __restrict__ out,
                                                   int out_stride, int out_off, float scale_div) {
    warp_queries<R, NV, Vec, kMasked>(t, fmap1, f2, h2, w2, C, dots, out, out_stride, out_off,
                                      scale_div);
  }
};

// C a multiple of 128: NV = C / 128 float4s a lane; C = 64 or 192: NV = C / 64
// float2s a lane; another C under 128: NV = ceil(C / 32) masked floats a lane.
struct Float32Widths {
  template <int R, bool kRescale>
  static cudaError_t launch(const FwdArgs& a) {
    switch (a.channels) {
      case 64: return launch_fwd<R, kRescale, Float32Form<1, float2, false>>(a);
      case 128: return launch_fwd<R, kRescale, Float32Form<1, float4, false>>(a);
      case 192: return launch_fwd<R, kRescale, Float32Form<3, float2, false>>(a);
      case 256: return launch_fwd<R, kRescale, Float32Form<2, float4, false>>(a);
      case 384: return launch_fwd<R, kRescale, Float32Form<3, float4, false>>(a);
      case 512: return launch_fwd<R, kRescale, Float32Form<4, float4, false>>(a);
      default: break;
    }
    if (a.channels < 1 || a.channels >= 128) return cudaErrorInvalidValue;
    switch ((a.channels + 31) / 32) {
      case 1: return launch_fwd<R, kRescale, Float32Form<1, float, true>>(a);
      case 2: return launch_fwd<R, kRescale, Float32Form<2, float, true>>(a);
      case 3: return launch_fwd<R, kRescale, Float32Form<3, float, true>>(a);
      default: return launch_fwd<R, kRescale, Float32Form<4, float, true>>(a);
    }
  }
};

}  // namespace

// fmap1 (B, H, W, C), level l (B, h_l, w_l, C), coords (B, H, W, 2) at level-0
// scale, out (B, H, W, L * (2r+1)^2): all float32, contiguous, 16-byte
// aligned. C is 64, 128, 192, 256, 384, 512 or under 128; radius is 3 or 4;
// 1 <= L <= 4; rescale 1 samples level l around coords / 2^l, 0 around
// coords. A (tile, level) whose box holds at most `budget` pixels takes the
// shared path; path_counts (2 unsigned 64-bit counts on the device) gains
// one per block in [0] (shared path) or [1] (warp path). Returns a
// cudaError_t (0 on success); launches on `stream`.
extern "C" int raft_corr_fwd(const void* fmap1, const void* level0, const void* level1,
                             const void* level2, const void* level3, int h0, int w0,
                             int h1, int w1, int h2, int w2, int h3, int w3,
                             int num_levels, const void* coords, void* out, int batch,
                             int height, int width, int channels, int radius, int rescale,
                             float scale_div, int budget, void* path_counts, void* stream) {
  const void* levels[kMaxLevels] = {level0, level1, level2, level3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  return fwd_entry<Float32Widths>(fmap1, levels, hs, ws, num_levels, coords, out, batch, height,
                                  width, channels, radius, rescale, scale_div, budget,
                                  path_counts, stream);
}
