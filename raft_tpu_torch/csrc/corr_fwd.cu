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
// Bound on an H100 SXM (Sintel, B=1, 55x128 queries, C=256, 4 levels, r=4):
// about 1.44 GFLOP of f32 FMA for the (2r+2)^2 neighbour dot products, which
// is 21 us at 67 TFLOP/s, against about 26 MB of compulsory traffic (fmap1,
// the pooled pyramid, the 324-channel output), 8 us at 3.35 TB/s. So the
// kernel is bound by f32 operations; the bytes an exact roofline counts come
// from this run's inputs in chip_smoke.py.
//
// Design (the reference's alt_cuda_corr scheme, not the TPU's hat-weight
// matmuls): one warp per query. The warp keeps fmap1[q] in registers
// (C/32 floats a lane), walks the (2r+2)^2 integer neighbours of
// floor(c / 2^l) that lie inside the level, dots each with fmap1[q] over C
// (float4 loads when C is a multiple of 128, float2 loads for C = 64 and
// 192, the sparse family's middle level, and masked float loads for another
// C under 128; a warp shuffle reduction),
// parks the dots in shared memory
// and scatters them into the (2r+1)^2 window with the four bilinear corner
// weights. That is (2r+2)^2 dots per query and level instead of 4 (2r+1)^2
// samples of C channels; neighbouring queries share most neighbours, so the
// pyramid rows are served by L1/L2, and no out-of-range neighbour is read.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarps = 8;  // queries per block

struct Levels {
  const float* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ float dot(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float dot(const float2 a, const float2 b) {
  return a.x * b.x + a.y * b.y;
}

__device__ __forceinline__ float dot(const float a, const float b) { return a * b; }

// Vec: float4, float2 or float, the load of one lane. NV: Vecs of fmap1
// held by each lane (C = 32 * NV * floats in a Vec, or with kMasked the
// runtime `channels` < 32 * NV, the lanes past it idle). R: window radius.
template <int R, int NV, typename Vec, bool kMasked>
__global__ void __launch_bounds__(kWarps * 32)
corr_fwd_kernel(const float* __restrict__ fmap1, const Levels lv,
                const int num_levels, const float* __restrict__ coords,
                float* __restrict__ out, const int batch, const int queries,
                const int channels, const int rescale, const float scale_div) {
  constexpr int D = 2 * R + 2;  // integer neighbours per axis
  constexpr int WIN = 2 * R + 1;
  const int C = kMasked ? channels : 32 * NV * (int)(sizeof(Vec) / sizeof(float));
  __shared__ float dots_all[kWarps][D * D];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * kWarps + warp;
  if (q >= (long long)batch * queries) return;  // warp-uniform
  const int b = (int)(q / queries);
  float* dots = dots_all[warp];

  Vec a[NV];
  const Vec* f1 = reinterpret_cast<const Vec*>(fmap1 + q * C);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    a[v] = (!kMasked || lane + 32 * v < C) ? __ldg(f1 + lane + 32 * v) : Vec{};
  }

  const float qx = coords[2 * q];
  const float qy = coords[2 * q + 1];
  float* outq = out + q * (long long)(num_levels * WIN * WIN);

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
    // A centre this far out has no neighbour inside any level (and a NaN
    // fails the test too); it also keeps the int conversion defined.
    const bool near = fabsf(fx) < 1.0e8f && fabsf(fy) < 1.0e8f;
    const int x0 = near ? (int)fx - R : 0;
    const int y0 = near ? (int)fy - R : 0;
    const float* f2 = lv.ptr[l] + (long long)b * h2 * w2 * C;

    for (int j = 0; j < D; ++j) {  // neighbour row: y moves
      const int yy = y0 + j;
      const bool row_in = near && yy >= 0 && yy < h2;
      float s[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {  // neighbour column: x moves
        const int xx = x0 + i;
        s[i] = 0.f;
        if (row_in && xx >= 0 && xx < w2) {  // uniform across the warp
          const Vec* p = reinterpret_cast<const Vec*>(
              f2 + ((long long)yy * w2 + xx) * C);
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

    const float w00 = (1.f - dx) * (1.f - dy);
    const float w10 = dx * (1.f - dy);
    const float w01 = (1.f - dx) * dy;
    const float w11 = dx * dy;
    for (int k = lane; k < WIN * WIN; k += 32) {
      const int i = k / WIN;  // x offset index
      const int j = k % WIN;  // y offset index
      const float v = w00 * dots[j * D + i] + w10 * dots[j * D + i + 1] +
                      w01 * dots[(j + 1) * D + i] + w11 * dots[(j + 1) * D + i + 1];
      outq[l * WIN * WIN + k] = v / scale_div;
    }
    __syncwarp();  // dots is rewritten by the next level
  }
}

template <int R, int NV, typename Vec, bool kMasked>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* fmap1, const Levels& lv,
                   int num_levels, const float* coords, float* out, int batch, int queries,
                   int channels, int rescale, float scale_div) {
  corr_fwd_kernel<R, NV, Vec, kMasked><<<grid, kWarps * 32, 0, stream>>>(
      fmap1, lv, num_levels, coords, out, batch, queries, channels, rescale, scale_div);
  return cudaGetLastError();
}

// C a multiple of 128: NV = C / 128 float4s a lane; C = 64 or 192: NV = C / 64
// float2s a lane; another C under 128: NV = ceil(C / 32) masked floats a lane.
template <int R>
cudaError_t launch_radius(int channels, dim3 grid, cudaStream_t stream, const float* fmap1,
                          const Levels& lv, int num_levels, const float* coords,
                          float* out, int batch, int queries, int rescale,
                          float scale_div) {
#define CORR_LAUNCH(NV, VEC, MASKED)                                                  \
  launch<R, NV, VEC, MASKED>(grid, stream, fmap1, lv, num_levels, coords, out, batch, \
                             queries, channels, rescale, scale_div)
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
// scale, out (B, H, W, L * (2r+1)^2): all float32, contiguous, 16-byte
// aligned. C is 128, 192, 256, 384, 512 or under 128; radius is 3 or 4;
// 1 <= L <= 4; rescale 1 samples level l around coords / 2^l, 0 around coords.
// Returns a cudaError_t (0 on success); launches on `stream`.
extern "C" int raft_corr_fwd(const void* fmap1, const void* level0, const void* level1,
                             const void* level2, const void* level3, int h0, int w0,
                             int h1, int w1, int h2, int w2, int h3, int w3,
                             int num_levels, const void* coords, void* out, int batch,
                             int queries, int channels, int radius, int rescale,
                             float scale_div, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || channels < 1 || batch < 0 ||
      queries < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)batch * queries == 0) return 0;
  Levels lv;
  const void* ptrs[kMaxLevels] = {level0, level1, level2, level3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.ptr[l] = static_cast<const float*>(ptrs[l]);
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
  }
  const long long total = (long long)batch * queries;
  const dim3 grid((unsigned)((total + kWarps - 1) / kWarps));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f1 = static_cast<const float*>(fmap1);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (radius == 4) {
    err = launch_radius<4>(channels, grid, s, f1, lv, num_levels, c, o, batch, queries,
                           rescale, scale_div);
  } else if (radius == 3) {
    err = launch_radius<3>(channels, grid, s, f1, lv, num_levels, c, o, batch, queries,
                           rescale, scale_div);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
