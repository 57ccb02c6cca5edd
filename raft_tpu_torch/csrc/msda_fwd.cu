// Multi-scale deformable attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of raft_tpu/ops/msda_pallas.py
// (reached through `_level_fwd`, :182, from `ms_deform_attn_pallas`, :282):
// for every batch b, query q and head m,
//   out[b, q, m*D + d] = sum over levels l and points p of
//     aw[b, q, m, l, p] * bilinear(value_l[b, :, :, m, d],
//                                  u * W_l - 0.5, v * H_l - 0.5)
// where (u, v) = loc[b, q, m, l, p] is a normalised location, the sample
// has zero padding outside the level (grid_sample, align_corners=False) and
// everything accumulates in f32. value is (B, S, M, D) with the levels
// flattened one after the other along S; the output is (B, Lq, M*D).
//
// Bound on an H100 SXM: bytes. At the sparse family's dense-query encoder
// (B=4, Lq=6930, M=8, D=8, L=6, P=4) one call reads about 64 MB of
// locations and weights and about 7 MB each of value and output, 0.023 ms
// at 3.35 TB/s, against about 0.34 GFLOP (5 us at 67 TFLOP/s); the decoder
// (B=8, Lq=100, D=16) moves under 2 MB, so it is bound by the launch. The
// exact bound comes from each run's inputs in chip_smoke.py.
//
// Design (the reference extension's gather scheme,
// ms_deform_im2col_cuda.cuh:238, not the TPU's hat-weight matmuls, which do
// O(W) work per sample where a gather needs four corners): G = D/4 lanes
// serve one (b, q, m) group, each lane 4 channels, so a corner is one
// 16-byte load a lane and the group's D contiguous floats of a corner are
// one coalesced read. A block of 256 threads serves 256/G groups. The
// groups' locations and weights are contiguous in memory; the block reads
// them once, coalesced, one thread per sample, and turns each sample into
// its base pixel index and four corner weights (the attention weight
// folded in, zero for a corner outside the level) in shared memory. The
// G lanes of a group then read those shared values instead of each
// deriving them, gather the corners and accumulate in registers. Samples
// go through shared memory in chunks of 4G per group (1024 a block).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEntries = 1024;  // samples staged in shared memory a pass
constexpr int kMaxLevels = 16;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// G: lanes per (b, q, m) group, D = 4 G channels.
template <int G>
__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, float* __restrict__ out, const Levels lv,
                const long long groups, const int lq_heads, const int heads,
                const int spatial, const int levels, const int points) {
  constexpr int kGroups = kThreads / G;   // groups a block
  constexpr int kChunk = kEntries / kGroups;  // samples a group a pass
  __shared__ int s_base[kEntries];
  __shared__ float4 s_w[kEntries];

  const int lp = levels * points;
  const long long g0 = (long long)blockIdx.x * kGroups;
  const int t = threadIdx.x / G;  // this lane's group in the block
  const int j = threadIdx.x % G;  // its channels: 4j .. 4j + 3
  const long long g = g0 + t;
  const int D = 4 * G;
  const long long b = g / lq_heads;
  const int m = (int)(g % heads);
  const float4* vb = reinterpret_cast<const float4*>(
      value + (b * spatial * heads + m) * (long long)D) + j;
  const long long pix_stride = (long long)heads * G;  // float4s a pixel
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int c0 = 0; c0 < lp; c0 += kChunk) {
    const int n = min(kChunk, lp - c0);
    // Stage: one thread per (group, sample) of this chunk.
    for (int i = threadIdx.x; i < kGroups * n; i += kThreads) {
      const int tt = i / n;
      const int s = c0 + i % n;
      const long long gg = g0 + tt;
      int base = 0;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gg < groups) {
        const int l = s / points;
        const int h = lv.h[l];
        const int wd = lv.w[l];
        const long long k = gg * lp + s;
        const float2 uv = reinterpret_cast<const float2*>(loc)[k];
        const float a = aw[k];
        const float px = uv.x * wd - 0.5f;
        const float py = uv.y * h - 0.5f;
        const float fx = floorf(px);
        const float fy = floorf(py);
        // a centre this far out has no corner inside (a NaN fails too);
        // the test also keeps the int conversion defined
        if (fabsf(fx) < 1.0e8f && fabsf(fy) < 1.0e8f) {
          const int x0 = (int)fx;
          const int y0 = (int)fy;
          const float dx = px - fx;
          const float dy = py - fy;
          const bool x0in = x0 >= 0 && x0 < wd;
          const bool x1in = x0 + 1 >= 0 && x0 + 1 < wd;
          const bool y0in = y0 >= 0 && y0 < h;
          const bool y1in = y0 + 1 >= 0 && y0 + 1 < h;
          w.x = (y0in && x0in) ? a * (1.f - dx) * (1.f - dy) : 0.f;
          w.y = (y0in && x1in) ? a * dx * (1.f - dy) : 0.f;
          w.z = (y1in && x0in) ? a * (1.f - dx) * dy : 0.f;
          w.w = (y1in && x1in) ? a * dx * dy : 0.f;
          // in range only where a corner is: no overflow
          if ((x0in || x1in) && (y0in || y1in)) base = lv.start[l] + y0 * wd + x0;
        }
        s_base[tt * kChunk + (s - c0)] = base;
        s_w[tt * kChunk + (s - c0)] = w;
      }
    }
    __syncthreads();
    if (g < groups) {
      for (int e = 0; e < n; ++e) {
        const int base = s_base[t * kChunk + e];
        const float4 w = s_w[t * kChunk + e];
        if (w.x == 0.f && w.y == 0.f && w.z == 0.f && w.w == 0.f) continue;
        const int l = (c0 + e) / points;
        const int wd = lv.w[l];
        const float ws[4] = {w.x, w.y, w.z, w.w};
        const int offs[4] = {base, base + 1, base + wd, base + wd + 1};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (ws[k] != 0.f) {
            const float4 v = __ldg(vb + offs[k] * pix_stride);
            acc.x += ws[k] * v.x;
            acc.y += ws[k] * v.y;
            acc.z += ws[k] * v.z;
            acc.w += ws[k] * v.w;
          }
        }
      }
    }
    __syncthreads();  // the next chunk rewrites the staged samples
  }
  if (g < groups) reinterpret_cast<float4*>(out)[g * G + j] = acc;
}

template <int G>
cudaError_t launch(const float* value, const float* loc, const float* aw, float* out,
                   const Levels& lv, long long groups, int lq_heads, int heads, int spatial,
                   int levels, int points, cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const dim3 grid((unsigned)((groups + kGroups - 1) / kGroups));
  msda_fwd_kernel<G><<<grid, kThreads, 0, stream>>>(value, loc, aw, out, lv, groups,
                                                   lq_heads, heads, spatial, levels, points);
  return cudaGetLastError();
}

}  // namespace

// value (B, S, M, D), loc (B, Lq, M, L, P, 2), aw (B, Lq, M, L, P), out
// (B, Lq, M*D): float32, contiguous, 16-byte aligned. Level l is h[l] x w[l]
// starting at row start[l] of S; 1 <= L <= 16; D is 4, 8 or 16.
// Returns a cudaError_t (0 on success); launches on `stream`.
extern "C" int raft_msda_fwd(const void* value, const void* loc, const void* aw, void* out,
                             const int* h, const int* w, const int* start, int num_levels,
                             int batch, int spatial, int queries, int heads, int channels,
                             int points, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || batch < 0 || queries < 0 ||
      heads < 1 || points < 1 || spatial < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.h[l] = l < num_levels ? h[l] : 0;
    lv.w[l] = l < num_levels ? w[l] : 0;
    lv.start[l] = l < num_levels ? start[l] : 0;
  }
  const long long groups = (long long)batch * queries * heads;
  if (groups == 0) return 0;
  const float* v = static_cast<const float*>(value);
  const float* l = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lq_heads = queries * heads;
#define MSDA_LAUNCH(G) launch<G>(v, l, a, o, lv, groups, lq_heads, heads, spatial, \
                                 num_levels, points, s)
  cudaError_t err;
  switch (channels) {
    case 4: err = MSDA_LAUNCH(1); break;
    case 8: err = MSDA_LAUNCH(2); break;
    case 16: err = MSDA_LAUNCH(4); break;
    default: err = cudaErrorInvalidValue;
  }
#undef MSDA_LAUNCH
  return (int)err;
}
