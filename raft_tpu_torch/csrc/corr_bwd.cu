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
// forward's per-level centre rule exactly), the
// dots d[n] = f1[q] . f2_l[n] over the (2r+2)^2 integer neighbours n of
// (floor(cx) - r, floor(cy) - r), zero where n lies outside the level, and
// out[k = i*(2r+1) + j] = sum of the four bilinear corner weights times d
// around neighbour (i, j), divided by sqrt(C). So the backward first folds
// the window's cotangents into one coefficient per neighbour,
// coef[n] = dL/dd[n] = sum over the windows touching n of g * weight / sqrt(C),
// and then, for every in-range neighbour,
//   df1[q]    += coef[n] * f2_l[n]
//   df2_l[n]  += coef[n] * f1[q]
// Out-of-range neighbours contribute nothing (zero padding).
//
// Bound on an H100 SXM (chairs training, B=8, 46x62 queries, C=256, 4
// levels, r=4): about 7.4 GFLOP of f32 FMA for the two C-long updates per
// in-range neighbour, 0.11 ms at 67 TFLOP/s, against about 140 MB of
// compulsory traffic (f1, the pyramid, g, df1 and the df2 levels), 0.04 ms
// at 3.35 TB/s: bound by f32 operations. chip_smoke.py counts this run's
// in-range neighbours for the exact bound.
//
// Design, the simple correct one (alt_cuda_corr's scheme, SURVEY.md 2.4):
// one warp per query, lanes over C as in the forward. The warp keeps f1[q]
// and its df1 sum in registers (C/32 floats a lane each), computes the
// (2r+2)^2 coefficients of a level into shared memory, then walks the
// in-range neighbours: a vector load of f2_l[n] per lane feeds df1, and
// df2_l[n] takes the product by f32 atomic adds. Queries overlap in most of
// their neighbours, so df2 has no owner to sum it without atomics; their
// order varies from run to run, so df2 is not bit-reproducible. The TPU
// kernel instead revisits each df2 block across its sequential query grid,
// which has no counterpart on 132 SMs running blocks in no order. The
// atomics bound the kernel, so each lane adds a float4 with one 16-byte
// vector atomicAdd (sm_90) rather than four scalar ones: about four times
// faster on the card (PERF.md's kernel table). The lanes take every C the
// forward takes, in the forward's vectors: float4 for C a multiple of 128,
// float2 with 8-byte atomicAdd (sm_90) for C = 64 and 192 (the sparse
// family's middle level), and masked floats for another C under 128.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarps = 8;  // queries per block

struct Levels {
  const float* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

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

// R: window radius. Vec: float4, float2 or float, the load of one lane. NV:
// Vecs of fmap1 held by each lane (C = 32 * NV * floats in a Vec, or with
// kMasked the runtime `channels` < 32 * NV, the lanes past it idle).
template <int R, int NV, typename Vec, bool kMasked>
__global__ void __launch_bounds__(kWarps * 32)
corr_bwd_kernel(const float* __restrict__ fmap1, const Levels lv,
                const int num_levels, const float* __restrict__ coords,
                const float* __restrict__ grad, float* __restrict__ df1,
                const LevelGrads dlv, const int batch, const int queries,
                const int channels, const int rescale, const float inv_scale) {
  constexpr int D = 2 * R + 2;  // integer neighbours per axis
  constexpr int WIN = 2 * R + 1;
  const int C = kMasked ? channels : 32 * NV * (int)(sizeof(Vec) / sizeof(float));
  __shared__ float coef_all[kWarps][D * D];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * kWarps + warp;
  if (q >= (long long)batch * queries) return;  // warp-uniform
  const int b = (int)(q / queries);
  float* coef = coef_all[warp];

  Vec a[NV];
  Vec acc[NV];
  const Vec* f1 = reinterpret_cast<const Vec*>(fmap1 + q * C);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    a[v] = (!kMasked || lane + 32 * v < C) ? __ldg(f1 + lane + 32 * v) : Vec{};
    acc[v] = Vec{};
  }

  const float qx = coords[2 * q];
  const float qy = coords[2 * q + 1];
  const float* gq = grad + q * (long long)(num_levels * WIN * WIN);

  for (int l = 0; l < num_levels; ++l) {
    const float lvl_div = rescale ? (float)(1 << l) : 1.f;
    const float cx = qx / lvl_div;
    const float cy = qy / lvl_div;
    const float fx = floorf(cx);
    const float fy = floorf(cy);
    const float dx = cx - fx;
    const float dy = cy - fy;
    const int h2 = lv.h[l];
    const int w2 = lv.w[l];
    // As in the forward: a centre this far out (or NaN) has no neighbour
    // inside any level.
    const bool near = fabsf(fx) < 1.0e8f && fabsf(fy) < 1.0e8f;
    const int x0 = near ? (int)fx - R : 0;
    const int y0 = near ? (int)fy - R : 0;
    const long long base = (long long)b * h2 * w2 * C;
    const float* f2 = lv.ptr[l] + base;
    float* d2 = dlv.ptr[l] + base;

    // Window (i, j) reads neighbour (i, j) with weight w00, (i+1, j) with
    // w10, (i, j+1) with w01 and (i+1, j+1) with w11 (x index first).
    const float w00 = (1.f - dx) * (1.f - dy);
    const float w10 = dx * (1.f - dy);
    const float w01 = (1.f - dx) * dy;
    const float w11 = dx * dy;
    const float* g = gq + l * WIN * WIN;
    for (int n = lane; n < D * D; n += 32) {
      const int j = n / D;  // y index of the neighbour
      const int i = n % D;  // x index
      float c = 0.f;
      if (i < WIN && j < WIN) c += w00 * g[i * WIN + j];
      if (i > 0 && j < WIN) c += w10 * g[(i - 1) * WIN + j];
      if (i < WIN && j > 0) c += w01 * g[i * WIN + j - 1];
      if (i > 0 && j > 0) c += w11 * g[(i - 1) * WIN + j - 1];
      coef[n] = c * inv_scale;
    }
    __syncwarp();

    for (int j = 0; j < D; ++j) {
      const int yy = y0 + j;
      if (!near || yy < 0 || yy >= h2) continue;  // uniform across the warp
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
    __syncwarp();  // coef is rewritten by the next level
  }

  Vec* out = reinterpret_cast<Vec*>(df1 + q * C);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!kMasked || lane + 32 * v < C) out[lane + 32 * v] = acc[v];
  }
}

template <int R, int NV, typename Vec, bool kMasked>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* fmap1, const Levels& lv,
                   int num_levels, const float* coords, const float* grad, float* df1,
                   const LevelGrads& dlv, int batch, int queries, int channels,
                   int rescale, float inv_scale) {
  corr_bwd_kernel<R, NV, Vec, kMasked><<<grid, kWarps * 32, 0, stream>>>(
      fmap1, lv, num_levels, coords, grad, df1, dlv, batch, queries, channels, rescale,
      inv_scale);
  return cudaGetLastError();
}

// The forward's lanes (csrc/corr_fwd.cu): C a multiple of 128: NV = C / 128
// float4s a lane; C = 64 or 192: NV = C / 64 float2s a lane; another C under
// 128: NV = ceil(C / 32) masked floats a lane.
template <int R>
cudaError_t launch_radius(int channels, dim3 grid, cudaStream_t stream, const float* fmap1,
                          const Levels& lv, int num_levels, const float* coords,
                          const float* grad, float* df1, const LevelGrads& dlv, int batch,
                          int queries, int rescale, float inv_scale) {
#define CORR_LAUNCH(NV, VEC, MASKED)                                                   \
  launch<R, NV, VEC, MASKED>(grid, stream, fmap1, lv, num_levels, coords, grad, df1, dlv, \
                             batch, queries, channels, rescale, inv_scale)
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

}  // namespace

// fmap1 (B, H, W, C), level l (B, h_l, w_l, C), coords (B, H, W, 2) at level-0
// scale, grad (B, H, W, L * (2r+1)^2), df1 (B, H, W, C) and dlevel l
// (B, h_l, w_l, C): all float32, contiguous, 16-byte aligned; each dlevel
// must hold zeros (the kernel adds into it). C is 128, 192, 256, 384, 512 or
// under 128; radius is 3 or 4; 1 <= L <= 4; rescale 1 samples level l
// around coords / 2^l, 0 around coords. inv_scale is 1/sqrt(C), or 1
// without the scale. Returns a cudaError_t (0 on success); launches on
// `stream`.
extern "C" int raft_corr_bwd(const void* fmap1, const void* level0, const void* level1,
                             const void* level2, const void* level3, int h0, int w0,
                             int h1, int w1, int h2, int w2, int h3, int w3,
                             int num_levels, const void* coords, const void* grad,
                             void* df1, void* dlevel0, void* dlevel1, void* dlevel2,
                             void* dlevel3, int batch, int queries, int channels,
                             int radius, int rescale, float inv_scale, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || channels < 1 || batch < 0 ||
      queries < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)batch * queries == 0) return 0;
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
  const long long total = (long long)batch * queries;
  const dim3 grid((unsigned)((total + kWarps - 1) / kWarps));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f1 = static_cast<const float*>(fmap1);
  const float* c = static_cast<const float*>(coords);
  const float* g = static_cast<const float*>(grad);
  float* d1 = static_cast<float*>(df1);
  cudaError_t err;
  if (radius == 4) {
    err = launch_radius<4>(channels, grid, s, f1, lv, num_levels, c, g, d1, dlv, batch,
                           queries, rescale, inv_scale);
  } else if (radius == 3) {
    err = launch_radius<3>(channels, grid, s, f1, lv, num_levels, c, g, d1, dlv, batch,
                           queries, rescale, inv_scale);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
