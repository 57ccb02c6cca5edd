// What the multi-scale deformable attention kernels (msda_fwd.cu,
// msda_bwd.cu) share, NVIDIA Hopper (sm_90a): the levels, a sample's
// corners, and the cp.async staging of a run of samples into shared memory
// (msda_bwd.cu's chunks).
//
// value is (B, S, M, D) with the levels flattened one after the other along
// S; level l is h[l] x w[l] pixels starting at row start[l] of S. A
// location (u, v) in [0, 1] maps to the pixel (u * w - 0.5, v * h - 0.5)
// (grid_sample, align_corners=False), with zero padding outside the level.
// The forward gathers the corners from L2 where they fall; the backward
// owns d_value in shared memory (msda_bwd.cu).

#pragma once

#include <cuda_runtime.h>

#include "conv_phase.cuh"

namespace msda_tile {

using conv_phase::cp_async16;
using conv_phase::cp_async_commit;
using conv_phase::cp_async_wait;

// 8 and 4 bytes, cached in L1: a sample's location and weight.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  conv_phase::cp_async8_readonly(dst, src, true);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(conv_phase::smem_addr(dst)),
               "l"(src)
               : "memory");
}

constexpr int kMaxLevels = 16;
// The dynamic shared memory a block may hold on an H100: 227 KB less 1 KB
// for the static shared memory of msda_bwd.cu's block scan. The wrapper's
// rule (msda_cuda.SMEM_BYTES) plans within it.
constexpr int kMaxSmem = 232448 - 1024;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__host__ inline Levels make_levels(const int* h, const int* w, const int* start,
                                   int num_levels) {
  Levels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.h[l] = l < num_levels ? h[l] : 0;
    lv.w[l] = l < num_levels ? w[l] : 0;
    lv.start[l] = l < num_levels ? start[l] : 0;
  }
  return lv;
}

// One sample at one level: its top-left corner (x0, y0), the bilinear
// fractions (fx, fy) and the corners inside the level, bits 0-3 for (y0,
// x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1). A centre far out (or
// NaN) has no corner and `valid` false.
struct Sample {
  int x0, y0, mask;
  float fx, fy;
  bool valid;
};

__device__ __forceinline__ Sample locate(const float2 uv, const int h, const int w) {
  Sample s;
  s.x0 = s.y0 = s.mask = 0;
  s.fx = s.fy = 0.f;
  // Rounded like the plain version's separate multiply and subtract (no FMA
  // contraction): where px lands on a whole pixel (the decoder's initial
  // reference grid does, on some levels) floor(px), and so the corners and
  // the corner pair of the location's subgradient, are the plain version's.
  const float px = __fsub_rn(__fmul_rn(uv.x, (float)w), 0.5f);
  const float py = __fsub_rn(__fmul_rn(uv.y, (float)h), 0.5f);
  const float fx = floorf(px);
  const float fy = floorf(py);
  // a centre this far out has no corner inside (a NaN fails too); the test
  // also keeps the int conversion defined
  s.valid = fabsf(fx) < 1.0e8f && fabsf(fy) < 1.0e8f;
  if (s.valid) {
    s.x0 = (int)fx;
    s.y0 = (int)fy;
    s.fx = px - fx;
    s.fy = py - fy;
    const bool x0in = s.x0 >= 0 && s.x0 < w;
    const bool x1in = s.x0 + 1 >= 0 && s.x0 + 1 < w;
    const bool y0in = s.y0 >= 0 && s.y0 < h;
    const bool y1in = s.y0 + 1 >= 0 && s.y0 + 1 < h;
    s.mask = (y0in && x0in) | (y0in && x1in) << 1 | (y1in && x0in) << 2 | (y1in && x1in) << 3;
  }
  return s;
}

// The four corners' bilinear weights, in mask order.
__device__ __forceinline__ void corner_weights(const Sample& s, float* wk) {
  wk[0] = (1.f - s.fx) * (1.f - s.fy);
  wk[1] = s.fx * (1.f - s.fy);
  wk[2] = (1.f - s.fx) * s.fy;
  wk[3] = s.fx * s.fy;
}

// Queue the copy of the locations and weights of samples [0, ns) into
// s_loc and s_aw: sample i is point i % points of query q_first + i /
// points, of (b, m) at level l.
__device__ __forceinline__ void stage_samples(float2* s_loc, float* s_aw,
                                              const float* __restrict__ loc,
                                              const float* __restrict__ aw, int ns,
                                              long long b, int q_first, int m, int l,
                                              int queries, int heads, int num_levels,
                                              int points) {
  const float2* loc2 = reinterpret_cast<const float2*>(loc);
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const int q = i / points;
    const long long k = ((b * queries + q_first + q) * heads + m) * num_levels * points +
                        (long long)l * points + (i - q * points);
    cp_async8(s_loc + i, loc2 + k);
    cp_async4(s_aw + i, aw + k);
  }
}

}  // namespace msda_tile
