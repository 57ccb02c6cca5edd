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
// Design: a group of `slots` slots of G = D/4 lanes serves one (b, q, m),
// each lane 4 channels, so a corner is one 16-byte load a lane and the
// group's D contiguous floats of a corner one coalesced read. The slots take
// the group's L*P samples in turn (neighbouring slots read neighbouring
// locations and weights), issue the four corner loads before using them,
// and are summed by a shuffle tree at the end. Corners are gathered from L2
// where they fall. The wrapper sets `slots` (msda_cuda.FWD_SLOTS: 4, at most
// a warp a group), measured at the decoder's and the encoder's shapes on
// incoherent and coherent samples. A form that staged each level's value
// slice in shared memory was slower on the encoder's own (coherent) samples
// (PERF.md section 6).
//
// Locations are rounded as the plain version rounds them (msda_tile.cuh,
// `locate`), so both kernels pick its corners at whole pixels.

#include <cuda_runtime.h>

#include "msda_tile.cuh"

namespace {

using namespace msda_tile;

constexpr int kThreads = 256;

__device__ __forceinline__ void fma4(float4& acc, const float c, const float4 v) {
  acc.x += c * v.x;
  acc.y += c * v.y;
  acc.z += c * v.z;
  acc.w += c * v.w;
}

// G: lanes a slot, D = 4 G channels; a group of `slots` slots (a power of
// two, slots * G <= 32) per (b, q, m).
template <int G>
__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, float* __restrict__ out, const Levels lv,
                const long long groups, const int lq_heads, const int heads,
                const int spatial, const int num_levels, const int points, const int slots) {
  const int width = slots * G;  // lanes a group, a power of two up to 32
  const long long g = ((long long)blockIdx.x * kThreads + threadIdx.x) / width;
  if (g >= groups) return;  // the whole group
  const int lane = threadIdx.x % width;
  const int slot = lane / G, j = lane % G;
  // the group's lanes of the warp, for the shuffles
  const unsigned mask = width == 32 ? 0xffffffffu
                                    : ((1u << width) - 1) << (threadIdx.x % 32 - lane);
  const long long b = g / lq_heads;
  const int m = (int)(g % heads);
  const long long pix_stride = (long long)heads * G;  // float4s a pixel
  const float4* vb = reinterpret_cast<const float4*>(value) + (b * spatial * heads + m) * G + j;
  const int lp = num_levels * points;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = slot; e < lp; e += slots) {
    const int l = e / points;
    const int w = lv.w[l];
    const long long k = g * lp + e;
    const Sample s = locate(reinterpret_cast<const float2*>(loc)[k], lv.h[l], w);
    if (!s.mask) continue;
    const float a = aw[k];
    const int base = lv.start[l] + s.y0 * w + s.x0;
    const int offs[4] = {base, base + 1, base + w, base + w + 1};
    float4 v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = (s.mask >> c & 1) ? __ldg(vb + offs[c] * pix_stride)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float wk[4];
    corner_weights(s, wk);
#pragma unroll
    for (int c = 0; c < 4; ++c) fma4(acc, a * wk[c], v[c]);
  }
  for (int off = G; off < width; off <<= 1) {
    acc.x += __shfl_xor_sync(mask, acc.x, off);
    acc.y += __shfl_xor_sync(mask, acc.y, off);
    acc.z += __shfl_xor_sync(mask, acc.z, off);
    acc.w += __shfl_xor_sync(mask, acc.w, off);
  }
  if (slot == 0) reinterpret_cast<float4*>(out)[g * G + j] = acc;
}

template <int G>
cudaError_t launch(const float* value, const float* loc, const float* aw, float* out,
                   const Levels& lv, int num_levels, int batch, int spatial, int queries,
                   int heads, int points, int slots, cudaStream_t stream) {
  if (slots < 1 || slots * G > 32 || (slots & (slots - 1))) return cudaErrorInvalidValue;
  const long long groups = (long long)batch * queries * heads;
  const long long blocks = (groups * slots * G + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  msda_fwd_kernel<G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      value, loc, aw, out, lv, groups, queries * heads, heads, spatial, num_levels, points,
      slots);
  return cudaGetLastError();
}

}  // namespace

// value (B, S, M, D), loc (B, Lq, M, L, P, 2), aw (B, Lq, M, L, P), out
// (B, Lq, M*D): float32, contiguous, 16-byte aligned. Level l is h[l] x w[l]
// starting at row start[l] of S; 1 <= L <= 16; D is 4, 8 or 16; slots (a
// power of two, slots * D / 4 <= 32) slots of D / 4 lanes serve each
// (b, q, m). Returns a cudaError_t (0 on success); launches on `stream`.
extern "C" int raft_msda_fwd(const void* value, const void* loc, const void* aw, void* out,
                             const int* h, const int* w, const int* start, int num_levels,
                             int batch, int spatial, int queries, int heads, int channels,
                             int points, int slots, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || batch < 0 || queries < 0 ||
      heads < 1 || points < 1 || spatial < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Levels lv = make_levels(h, w, start, num_levels);
  if ((long long)batch * queries == 0) return 0;
  const float* v = static_cast<const float*>(value);
  const float* l = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSDA_LAUNCH(G) launch<G>(v, l, a, o, lv, num_levels, batch, spatial, queries, heads, \
                                 points, slots, s)
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
