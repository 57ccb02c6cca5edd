// On-demand windowed correlation, forward, bf16 form, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of raft_tpu/ops/corr_pallas.py
// (:206, reached through `_pallas_fwd`, :373, from
// `windowed_correlation_pallas_fused`, :568) at mxu_dtype = "bfloat16": the
// function of corr_fwd.cu with both operands of every product rounded to
// bfloat16 (a float32 map in the kernel, to nearest even; a bfloat16 map as
// it is), float32 sums, the bilinear weights, the scale and the zero padding
// in float32 as in the float32 form, and the windows stored in the maps'
// type T from the float32 value (the port's lookup asks for its windows in
// the dtype of its maps). The tile, box, path rule and kernel shell are the
// float32 form's (corr_tile.cuh); this file fills the shell with the bf16
// form of the two paths.
//   Shared path: the same chunks of kNC box pixels and stages of kKC
//   channels, staged in T (a bfloat16 stage is half the copies), and one
//   mma.sync m16n8k16 bf16 product per 16 channels where the float32 form
//   runs six m16n8k8 TF32 ones (3xTF32 over two k8 steps).
//   Warp path: lane l holds channel pairs 2 (l + 32 v), v < C / 64, rounded
//   to bfloat16; each product of two bfloat16 values is exact in float32,
//   so the warp's float32 sums and the tensor cores' agree up to order.
// Bound on an H100 SXM (Sintel, B=1, 55x128 queries, C=256, 4 levels, r=4):
// the same 1.44 GFLOP at 989 TFLOP/s (bf16 tensor cores) is 1.5 us, against
// about 13 MB of compulsory bfloat16 traffic (fmap1, the four levels, the
// coordinates and the bfloat16 windows), 4 us at 3.35 TB/s: bound by bytes.
// C is 128 or 256: RAFT-small's and RAFT-large's feature widths (NV = C / 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "corr_tile.cuh"

namespace {

using namespace corr_tile;

using bf16 = __nv_bfloat16;

// A staged row's stride in elements: 16-byte aligned, and conflict-free for
// the m16n8k16 fragments' 32-bit loads from a bfloat16 stage.
template <typename T>
__host__ __device__ constexpr int stage_ld() {
  return sizeof(T) == 4 ? kLdk : kKC + 8;
}

// Two neighbouring channels as the packed bfloat16 pair of an MMA fragment
// (the lower k in the low half).
__device__ __forceinline__ uint32_t bf16_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bf16_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The same pair as two floats, each rounded to bfloat16 (exact for a
// bfloat16 map), for the warp path.
__device__ __forceinline__ float2 bf16_floats(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 bf16_floats(const float* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
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

// The shared path of the bf16 form: the dots of every query of the tile
// into S (kQ x D*D), as tile_dots.
template <int R, typename T>
__device__ void tile_dots_bf16(const TileQueries& t, const T* __restrict__ fmap1,
                               const T* __restrict__ f2, int w2, int C, int nb, int bw,
                               float* S, T* stage) {
  constexpr int D = 2 * R + 2;
  constexpr int DD = D * D;
  constexpr int kLd = stage_ld<T>();
  constexpr int kVec = 16 / (int)sizeof(T);        // elements a 16-byte copy
  constexpr int kPerRow = kKC / kVec;              // copies a row's stage
  constexpr int kRowsPer = kThreads / kPerRow;     // rows the block copies at once
  constexpr int kCp = (kQ + kNC) / kRowsPer;       // copies a thread a stage
  constexpr int kStage = (kQ + kNC) * kLd;
  static_assert(kCp * kRowsPer == kQ + kNC, "copies split evenly");
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 2) * 32;
  const int wn = (warp & 3) * 32;
  const int cv = tid % kPerRow;  // this thread's 16-byte column of a stage
  for (int i = tid; i < kQ * DD; i += kThreads) S[i] = 0.f;
  for (int n0 = 0; n0 < nb; n0 += kNC) {
    const T* src[kCp];
    bool ok[kCp];
#pragma unroll
    for (int i = 0; i < kCp; ++i) {
      const int row = tid / kPerRow + kRowsPer * i;
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
    auto load = [&](int ks, T* buf) {
#pragma unroll
      for (int i = 0; i < kCp; ++i) {
        const int row = tid / kPerRow + kRowsPer * i;
        cp_async16(buf + row * kLd + kVec * cv, src[i] + ks * kKC + kVec * cv, ok[i]);
      }
      cp_async_commit();
    };
    const bool active = n0 + wn < nb;
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    const int nks = C / kKC;
    load(0, stage);
    for (int ks = 0; ks < nks; ++ks) {
      if (ks + 1 < nks) {
        load(ks + 1, stage + ((ks + 1) & 1) * kStage);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const T* A = stage + (ks & 1) * kStage;  // F1: (query, channel)
        const T* B = A + kQ * kLd;               // box: (pixel, channel)
#pragma unroll
        for (int k0 = 0; k0 < kKC; k0 += 16) {
          uint32_t a[2][4], b[4][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const T* r0 = A + (wm + 16 * mt + g) * kLd + k0 + 2 * tq;
            a[mt][0] = bf16_pair(r0);
            a[mt][1] = bf16_pair(r0 + 8 * kLd);
            a[mt][2] = bf16_pair(r0 + 8);
            a[mt][3] = bf16_pair(r0 + 8 * kLd + 8);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const T* c0 = B + (wn + 8 * nt + g) * kLd + k0 + 2 * tq;
            b[nt][0] = bf16_pair(c0);
            b[nt][1] = bf16_pair(c0 + 8);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
        }
      }
      __syncthreads();
    }
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
            if ((unsigned)i < D && (unsigned)j < D) S[qi * DD + j * D + i] = acc[mt][nt][e];
          }
    }
  }
  __syncthreads();
}

// The warp path of the bf16 form: as warp_queries, on bfloat16-rounded
// channel pairs.
template <int R, int NV, typename T>
__device__ void warp_queries_bf16(const TileQueries& t, const T* __restrict__ fmap1,
                                  const T* __restrict__ f2, int h2, int w2, float* dots_all,
                                  T* __restrict__ out, int out_stride, int out_off,
                                  float scale_div) {
  constexpr int D = 2 * R + 2;
  constexpr int WIN = 2 * R + 1;
  constexpr int C = 64 * NV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* dots = dots_all + warp * D * D;
  for (int qi = warp; qi < kQ; qi += kWarps) {
    const long long q = t.q[qi];
    if (q < 0) continue;  // warp-uniform
    float2 a[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) a[v] = bf16_floats(fmap1 + q * C + 2 * (lane + 32 * v));
    const bool near = t.near[qi];
    const int x0 = t.x0[qi];
    const int y0 = t.y0[qi];
    for (int j = 0; j < D; ++j) {
      const int yy = y0 + j;
      const bool row_in = near && yy >= 0 && yy < h2;
      float s[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const int xx = x0 + i;
        s[i] = 0.f;
        if (row_in && xx >= 0 && xx < w2) {  // uniform across the warp
          const T* p = f2 + ((long long)yy * w2 + xx) * C;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const float2 b = bf16_floats(p + 2 * (lane + 32 * v));
            s[i] = fmaf(a[v].x, b.x, fmaf(a[v].y, b.y, s[i]));
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
      store_out(out + q * out_stride + out_off + k, window_value<R>(t, qi, dots, k) / scale_div);
    }
    __syncwarp();
  }
}

// The bf16 form at width C = 64 NV on maps (and windows) of type M.
template <typename M, int NV>
struct Bf16Form {
  using T = M;
  static constexpr bool kTileForm = true;
  __device__ __forceinline__ static int channels(int) { return 64 * NV; }
  template <int R>
  static constexpr int smem_bytes() {
    return kQ * (2 * R + 2) * (2 * R + 2) * 4 + 2 * (kQ + kNC) * stage_ld<M>() * (int)sizeof(M);
  }
  template <int R>
  __device__ __forceinline__ static void shared_path(const TileQueries& t,
                                                     const M* __restrict__ fmap1,
                                                     const M* __restrict__ f2, int w2, int C,
                                                     int nb, int bw, float* S, M* stage) {
    tile_dots_bf16<R, M>(t, fmap1, f2, w2, C, nb, bw, S, stage);
  }
  template <int R>
  __device__ __forceinline__ static void warp_path(const TileQueries& t,
                                                   const M* __restrict__ fmap1,
                                                   const M* __restrict__ f2, int h2, int w2,
                                                   int, float* dots, M* __restrict__ out,
                                                   int out_stride, int out_off, float scale_div) {
    warp_queries_bf16<R, NV, M>(t, fmap1, f2, h2, w2, dots, out, out_stride, out_off, scale_div);
  }
};

template <typename M>
struct Bf16Widths {
  template <int R, bool kRescale>
  static cudaError_t launch(const FwdArgs& a) {
    switch (a.channels) {
      case 128: return launch_fwd<R, kRescale, Bf16Form<M, 2>>(a);
      case 256: return launch_fwd<R, kRescale, Bf16Form<M, 4>>(a);
      default: return cudaErrorInvalidValue;
    }
  }
};

}  // namespace

// The bf16 form: the arguments of raft_corr_fwd, with fmap1, the levels and
// out bfloat16 when in_bf16 (else float32), C 128 or 256. Returns a
// cudaError_t (0 on success); launches on `stream`.
extern "C" int raft_corr_fwd_bf16(const void* fmap1, const void* level0, const void* level1,
                                  const void* level2, const void* level3, int h0, int w0,
                                  int h1, int w1, int h2, int w2, int h3, int w3,
                                  int num_levels, const void* coords, void* out, int batch,
                                  int height, int width, int channels, int radius, int rescale,
                                  float scale_div, int budget, int in_bf16, void* path_counts,
                                  void* stream) {
  const void* levels[kMaxLevels] = {level0, level1, level2, level3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  return in_bf16 ? fwd_entry<Bf16Widths<bf16>>(fmap1, levels, hs, ws, num_levels, coords, out,
                                               batch, height, width, channels, radius, rescale,
                                               scale_div, budget, path_counts, stream)
                 : fwd_entry<Bf16Widths<float>>(fmap1, levels, hs, ws, num_levels, coords, out,
                                                batch, height, width, channels, radius, rescale,
                                                scale_div, budget, path_counts, stream);
}
