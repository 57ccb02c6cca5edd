// Multi-scale deformable attention, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of raft_tpu/ops/msda_pallas.py:124
// (reached through `_level_bwd`, :206, from the custom VJP
// `_msda_level_bwd`, :253): given the cotangent g (B, Lq, M*D) of the
// forward of csrc/msda_fwd.cu, it returns the gradients to all three
// inputs, for all levels in one launch. For each (b, q, m) and sample
// (l, p), with px = u * W_l - 0.5, py = v * H_l - 0.5, x0 = floor(px),
// fx = px - x0 (likewise y) and the four corners v00 (y0, x0), v01
// (y0, x0+1), v10 (y0+1, x0), v11 (y0+1, x0+1), zero outside the level:
//   d_aw[b, q, m, l, p]      = sum_d g_d * sample_d
//   d_loc[..., 0] = W_l * aw * sum_d g_d ((1-fy)(v01-v00) + fy (v11-v10))_d
//   d_loc[..., 1] = H_l * aw * sum_d g_d ((1-fx)(v10-v00) + fx (v11-v01))_d
//   d_value[corner, m, :]   += aw * w_corner * g   (every in-range corner)
// The floor-based corner difference at fx = 0 is the right-open window of
// the TPU kernel's `_corner` (:79) and of grid_sample; a corner outside the
// level gives zero value and zero derivative. Everything accumulates in f32.
// At a whole pixel that subgradient hangs on the rounding of px, so px is
// rounded as the plain version rounds it (below).
//
// Bound on an H100 SXM: bytes. At the sparse family's dense-query encoder
// (B=4, Lq=6930, M=8, D=8, L=6, P=4) one call reads about 64 MB of
// locations and weights, 7 MB of cotangent and the value rows its samples
// touch, and writes about 48 MB of location and weight gradients and the
// 7 MB d_value (zeroed by the wrapper), about 0.04 ms at 3.35 TB/s; the
// f32 work is about 1 GFLOP (15 us at 67 TFLOP/s). The decoder (B=8,
// Lq=100, D=16) moves under 3 MB: it is bound by its latency. chip_smoke.py
// computes the exact bound from each run's inputs.
//
// Design (the reference extension's gather-scatter scheme,
// ms_deform_im2col_cuda.cuh's col2im backward, not the TPU's hat-weight
// matmuls): the forward's layout. G = D/4 lanes serve one (b, q, m) group,
// each lane 4 channels of the cotangent in a float4. The block stages each
// sample of its groups once in shared memory (base pixel, fractional
// parts, attention weight, in-range corners), one thread per sample,
// coalesced. Each lane then gathers the four corners' float4s, forms its
// partial sums of d_aw, d_px and d_py, the G lanes reduce them with
// __shfl_xor_sync (every lane reaches every shuffle, also for a sample with
// no corner in range, whose sums are zero) and the group's first lane parks
// them in shared memory; the staging threads write them out coalesced.
// d_value has no owner: many (query, head, sample)s land on one pixel, so
// each lane adds aw * w_corner * g with one 16-byte vector atomicAdd
// (sm_90) per in-range corner, the scheme of csrc/corr_bwd.cu. Their order
// varies from run to run, so d_value is not bit-reproducible. A sample with
// a zero attention weight adds nothing and gets d_loc = 0 (but still its
// d_aw); queries are not padded, so nothing is read past Lq.

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

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// G: lanes per (b, q, m) group, D = 4 G channels.
template <int G>
__global__ void __launch_bounds__(kThreads)
msda_bwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, const float* __restrict__ grad,
                float* __restrict__ d_value, float* __restrict__ d_loc,
                float* __restrict__ d_aw, const Levels lv, const long long groups,
                const int lq_heads, const int heads, const int spatial,
                const int levels, const int points) {
  constexpr int kGroups = kThreads / G;       // groups a block
  constexpr int kChunk = kEntries / kGroups;  // samples a group a pass
  __shared__ int s_base[kEntries];
  __shared__ int s_mask[kEntries];            // in-range corners, bits 0-3
  __shared__ float4 s_f[kEntries];            // fx, fy, aw, unused
  __shared__ float4 s_out[kEntries];          // d_aw, d_px, d_py, unused

  const int lp = levels * points;
  const long long g0 = (long long)blockIdx.x * kGroups;
  const int t = threadIdx.x / G;  // this lane's group in the block
  const int j = threadIdx.x % G;  // its channels: 4j .. 4j + 3
  const long long g = g0 + t;
  const bool live = g < groups;
  const long long b = live ? g / lq_heads : 0;
  const int m = (int)(g % heads);
  const long long row0 = (b * spatial * heads + m) * (long long)G + j;  // float4 index
  const float4* vb = reinterpret_cast<const float4*>(value) + row0;
  float4* dvb = reinterpret_cast<float4*>(d_value) + row0;
  const long long pix_stride = (long long)heads * G;  // float4s a pixel
  const float4 gv = live ? __ldg(reinterpret_cast<const float4*>(grad) + g * G + j)
                         : make_float4(0.f, 0.f, 0.f, 0.f);

  for (int c0 = 0; c0 < lp; c0 += kChunk) {
    const int n = min(kChunk, lp - c0);
    // Stage: one thread per (group, sample) of this chunk.
    for (int i = threadIdx.x; i < kGroups * n; i += kThreads) {
      const int tt = i / n;
      const int s = c0 + i % n;
      const long long gg = g0 + tt;
      int base = 0, mask = 0;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gg < groups) {
        const int l = s / points;
        const int h = lv.h[l];
        const int wd = lv.w[l];
        const long long k = gg * lp + s;
        const float2 uv = reinterpret_cast<const float2*>(loc)[k];
        // Rounded like the plain version's separate multiply and subtract
        // (no FMA contraction): where px lands on a whole pixel (the
        // decoder's initial reference grid does, on some levels) floor(px),
        // and so the corner pair of the location's subgradient, is the
        // plain version's.
        const float px = __fsub_rn(__fmul_rn(uv.x, (float)wd), 0.5f);
        const float py = __fsub_rn(__fmul_rn(uv.y, (float)h), 0.5f);
        const float fx = floorf(px);
        const float fy = floorf(py);
        f.z = aw[k];
        // a centre this far out has no corner inside (a NaN fails too);
        // the test also keeps the int conversion defined
        if (fabsf(fx) < 1.0e8f && fabsf(fy) < 1.0e8f) {
          const int x0 = (int)fx;
          const int y0 = (int)fy;
          const bool x0in = x0 >= 0 && x0 < wd;
          const bool x1in = x0 + 1 >= 0 && x0 + 1 < wd;
          const bool y0in = y0 >= 0 && y0 < h;
          const bool y1in = y0 + 1 >= 0 && y0 + 1 < h;
          mask = (y0in && x0in) | (y0in && x1in) << 1 | (y1in && x0in) << 2 |
                 (y1in && x1in) << 3;
          f.x = px - fx;
          f.y = py - fy;
          // in range only where a corner is: no overflow
          if (mask) base = lv.start[l] + y0 * wd + x0;
        }
      }
      s_base[i] = base;
      s_mask[i] = mask;
      s_f[i] = f;
    }
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      const int idx = t * n + e;
      const int mask = live ? s_mask[idx] : 0;  // uniform across the group
      float daw = 0.f, dpx = 0.f, dpy = 0.f;
      if (mask) {
        const int base = s_base[idx];
        const float4 f = s_f[idx];
        const int wd = lv.w[(c0 + e) / points];
        const int offs[4] = {base, base + 1, base + wd, base + wd + 1};
        float4 v[4];
        float gd[4];  // g . corner, this lane's 4 channels
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[k] = (mask >> k & 1) ? __ldg(vb + offs[k] * pix_stride)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
          gd[k] = dot4(gv, v[k]);
        }
        const float fx = f.x, fy = f.y, a = f.z;
        const float w[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy), (1.f - fx) * fy,
                            fx * fy};
        daw = w[0] * gd[0] + w[1] * gd[1] + w[2] * gd[2] + w[3] * gd[3];
        dpx = (1.f - fy) * (gd[1] - gd[0]) + fy * (gd[3] - gd[2]);
        dpy = (1.f - fx) * (gd[2] - gd[0]) + fx * (gd[3] - gd[1]);
        if (a != 0.f) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float c = a * w[k];
            if ((mask >> k & 1) && c != 0.f) {
              atomicAdd(dvb + offs[k] * pix_stride,
                        make_float4(c * gv.x, c * gv.y, c * gv.z, c * gv.w));
            }
          }
        }
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        daw += __shfl_xor_sync(0xffffffffu, daw, off);
        dpx += __shfl_xor_sync(0xffffffffu, dpx, off);
        dpy += __shfl_xor_sync(0xffffffffu, dpy, off);
      }
      if (j == 0) s_out[idx] = make_float4(daw, dpx, dpy, 0.f);
    }
    __syncthreads();
    // Write back in the staging threads' order: coalesced along the samples.
    for (int i = threadIdx.x; i < kGroups * n; i += kThreads) {
      const int tt = i / n;
      const int s = c0 + i % n;
      const long long gg = g0 + tt;
      if (gg < groups) {
        const int l = s / points;
        const long long k = gg * lp + s;
        const float4 r = s_out[i];
        const float a = s_f[i].z;
        d_aw[k] = r.x;
        reinterpret_cast<float2*>(d_loc)[k] =
            make_float2(a * r.y * lv.w[l], a * r.z * lv.h[l]);
      }
    }
    __syncthreads();  // the next chunk rewrites the staged samples
  }
}

template <int G>
cudaError_t launch(const float* value, const float* loc, const float* aw, const float* grad,
                   float* d_value, float* d_loc, float* d_aw, const Levels& lv,
                   long long groups, int lq_heads, int heads, int spatial, int levels,
                   int points, cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const dim3 grid((unsigned)((groups + kGroups - 1) / kGroups));
  msda_bwd_kernel<G><<<grid, kThreads, 0, stream>>>(value, loc, aw, grad, d_value, d_loc,
                                                   d_aw, lv, groups, lq_heads, heads,
                                                   spatial, levels, points);
  return cudaGetLastError();
}

}  // namespace

// value (B, S, M, D), loc (B, Lq, M, L, P, 2), aw (B, Lq, M, L, P), grad
// (B, Lq, M*D); d_value as value and holding zeros (the kernel adds into
// it), d_loc as loc, d_aw as aw: float32, contiguous, 16-byte aligned.
// Level l is h[l] x w[l] starting at row start[l] of S; 1 <= L <= 16; D is
// 4, 8 or 16. Returns a cudaError_t (0 on success); launches on `stream`.
extern "C" int raft_msda_bwd(const void* value, const void* loc, const void* aw,
                             const void* grad, void* d_value, void* d_loc, void* d_aw,
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
  const float* g = static_cast<const float*>(grad);
  float* dv = static_cast<float*>(d_value);
  float* dl = static_cast<float*>(d_loc);
  float* da = static_cast<float*>(d_aw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lq_heads = queries * heads;
#define MSDA_LAUNCH(G) launch<G>(v, l, a, g, dv, dl, da, lv, groups, lq_heads, heads, \
                                 spatial, num_levels, points, s)
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
