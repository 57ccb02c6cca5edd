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
// rounded as the plain version rounds it (msda_tile.cuh, `locate`).
//
// Bound on an H100 SXM: bytes. At the sparse family's dense-query encoder
// (B=4, Lq=6930, M=8, D=8, L=6, P=4) one call reads about 64 MB of
// locations and weights, 7 MB of cotangent and the value rows its samples
// touch, and writes about 48 MB of location and weight gradients and the
// 7 MB d_value, about 0.04 ms at 3.35 TB/s; the f32 work is about 1 GFLOP
// (15 us at 67 TFLOP/s). The decoder (B=8, Lq=100, D=16) writes its 28 MB
// d_value whole, 8 us. chip_smoke.py computes the exact bound from each
// run's inputs.
//
// Design: d_value has an owner. Like the TPU kernel, which sums d_value over
// the query tiles in its output block (msda_pallas.py:40-41, 172-179), one
// block of 512 threads owns the slice d_value[b, level, :, m, :], or a band
// of its rows where the slice outgrows shared memory (the wrapper's `plan`
// sets the rows a band), in shared memory: it zeroes it, takes every sample
// of its (b, m, level) in chunks of queries, one thread a sample, and writes
// the band out once with plain coalesced stores. Every sample belongs to one
// (b, m, level), so there is no float atomic into global memory and no
// zero-fill before the launch. The band that holds a sample's clamped top
// row (band 0 for a sample far off the level) owns its d_aw and d_loc and
// writes them once, from corners gathered from L2. A chunk's locations,
// weights and cotangent rows are copied into shared memory with cp.async
// while the chunk before is summed (two buffers: a block fills an SM's
// shared memory, so a load that waited at a barrier would stall the SM).
// The blocks of the largest levels are launched first, so that the small
// ones fill the last wave. Where the launch has too few bands for two waves
// of SMs (the encoder's 192 on 132) and each has 4 chunks or more, each
// band is split over a cluster of two blocks, each taking half of the
// chunks into a partial band; the pair then sums the partials over
// distributed shared memory, in rank order, each block writing half of the
// band (at the encoder shape 0.88x the time of one block a band; four
// blocks a band took 1.19x). A sample with a zero
// attention weight adds nothing and gets d_loc = 0 (but still its d_aw).
//
// Hopper has no shared-memory f32 atomic add: atomicAdd compiles to a 4-byte
// compare-and-swap loop (a first form of this kernel with it took 3x the
// time of the global atomics it replaced at the encoder shape, and one
// 16-byte compare-and-swap a corner, atom.shared.cas.b128, 3.5x on
// incoherent and 5.5x on coherent samples). So a chunk's d_value shares are
// summed by a counting sort, with integer shared atomics (native):
//
//   1. one thread per sample locates it, writes d_aw and d_loc if its band
//      owns them, and gives every in-band corner with a non-zero share the
//      next slot of its pixel's count; the first one lists the pixel as
//      touched;
//   2. a block scan over the touched pixels' counts gives each its slice of
//      an entry list;
//   3. each (sample, corner) entry goes to its slot of its pixel's slice;
//   4. one thread per (touched pixel, 4 channels) sums its slice's shares
//      aw * w_corner * g into the band, which it alone writes, and zeroes
//      the pixel's count for the next chunk.
//
// Each step costs what the chunk's entries cost, not the band's pixels, and
// a chunk is as large as shared memory allows beside the band (2048
// samples at the encoder: 256 chunks of 512 samples took 1.4x the time, and
// staging the value rows too, which halves the chunk, 1.1x). The slots and
// the touched pixels' order come from the atomics, so d_value is not
// bit-reproducible; d_aw and d_loc are. (Putting each slice in entry order
// first, by an insertion sort a pixel, made d_value reproducible at 1.4x the
// time on incoherent samples and 4.5x on the encoder's coherent ones, whose
// chunks put over a hundred entries on a pixel of a coarse level.)

#include <cuda_runtime.h>

#include "msda_tile.cuh"

namespace {

using namespace msda_tile;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Samples a chunk takes at most: queries a chunk = max(1, kChunk / points).
constexpr int kChunk = 2048;

// Level l is cut into bands of rows[l] rows (the last may be shorter), band
// ranks first[l] .. first[l] + count[l] - 1, the largest bands first; the
// block of band rank r and (image, head) bm is r * batch * heads + bm.
struct Bands {
  int rows[kMaxLevels];
  int first[kMaxLevels];
  int count[kMaxLevels];
};

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// a[0..n) to its exclusive prefix sums, by the whole block.
__device__ void block_exclusive_scan(int* a, const int n) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int x = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  int base = x - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int t = a[i];
    a[i] = base;
    base += t;
  }
}

// The shared-memory layout of a block whose band holds npx pixels, for
// chunks of qc queries of `points` samples, in floats; each region starts
// 16-byte aligned. A chunk buffer holds the cotangent rows (qc x D), the
// locations (qc * points float2) and the weights; there are two. A chunk
// has at most 4 entries a sample, and touches at most min(npx, entries)
// pixels; the touched pixels, the slots and the list hold 16-bit indices (a
// band holds at most 14,528 pixels, a chunk 4 * kChunk entries).
struct Layout {
  int dv, chunk, sg, sl, sa, cnt, base, touched, slot, list, total;
};

__host__ __device__ inline int align4(int x) { return (x + 3) / 4 * 4; }

__host__ __device__ inline Layout layout(int npx, int qc, int points, int D) {
  const int entries = 4 * qc * points;
  const int touched = npx < entries ? npx : entries;
  Layout o;
  o.dv = 0;                                  // the band's d_value, npx x D
  o.sg = o.dv + npx * D;                     // chunk buffer 0
  o.sl = o.sg + qc * D;
  o.sa = o.sl + align4(2 * qc * points);
  o.chunk = o.sa + align4(qc * points) - o.sg;  // floats a chunk buffer
  o.cnt = o.sg + 2 * o.chunk;                // each pixel's count, then its slice start
  o.base = o.cnt + align4(npx);              // touched pixels' counts, then slice starts
  o.touched = o.base + align4(touched);      // touched pixels, 16-bit
  o.slot = o.touched + align4(touched / 2 + 1);  // each entry's slot, 16-bit
  o.list = o.slot + align4(entries / 2);     // the entries, 16-bit (sample * 4 + corner)
  o.total = o.list + align4(entries / 2);
  return o;
}

// G: float4s a pixel, D = 4 G channels.
template <int G>
__global__ void __launch_bounds__(kThreads)
msda_bwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, const float* __restrict__ grad,
                float* __restrict__ d_value, float* __restrict__ d_loc,
                float* __restrict__ d_aw, const Levels lv, const Bands bands,
                const int num_levels, const int spatial, const int queries, const int heads,
                const int points, const int qc, const int total_bands) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int D = 4 * G;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int split = (int)cluster.num_blocks();  // blocks a band
  const int rank = (int)cluster.block_rank();
  const int unit = blockIdx.x / split;
  const int bh = gridDim.x / split / total_bands;  // images x heads
  const int band_id = unit / bh;
  const int bm = unit % bh;
  const int m = bm % heads;
  const long long b = bm / heads;
  int l = 0;
  while (band_id < bands.first[l] || band_id >= bands.first[l] + bands.count[l]) ++l;
  const int band = band_id - bands.first[l];
  const int h = lv.h[l], w = lv.w[l];
  const int rows = bands.rows[l];
  const int y_lo = band * rows;
  const int y_hi = min(y_lo + rows, h);
  const int npx = (y_hi - y_lo) * w;
  const Layout o = layout(npx, qc, points, D);
  float4* dv = reinterpret_cast<float4*>(smem + o.dv);
  int* cnt = reinterpret_cast<int*>(smem + o.cnt);
  int* base = reinterpret_cast<int*>(smem + o.base);
  unsigned short* touched = reinterpret_cast<unsigned short*>(smem + o.touched);
  unsigned short* slot = reinterpret_cast<unsigned short*>(smem + o.slot);
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + o.list);
  __shared__ int n_touched, last_count;
  const long long pix_stride = (long long)heads * G;  // float4s a pixel of value
  const float4* vb = reinterpret_cast<const float4*>(value) +
                     ((b * spatial + lv.start[l]) * heads + m) * G;
  const float4* g4 = reinterpret_cast<const float4*>(grad);
  const int lp = num_levels * points;
  // chunk c's buffer
  auto chunk_g = [&](int c) { return reinterpret_cast<float4*>(smem + o.sg + (c & 1) * o.chunk); };
  auto chunk_l = [&](int c) { return reinterpret_cast<float2*>(smem + o.sl + (c & 1) * o.chunk); };
  auto chunk_a = [&](int c) { return smem + o.sa + (c & 1) * o.chunk; };
  auto stage = [&](int c) {
    const int q0 = c * qc, nq = min(qc, queries - q0);
    stage_samples(chunk_l(c), chunk_a(c), loc, aw, nq * points, b, q0, m, l, queries, heads,
                  num_levels, points);
    float4* sg = chunk_g(c);
    for (int i = threadIdx.x; i < nq * G; i += kThreads) {
      cp_async16(sg + i, g4 + ((b * queries + q0 + i / G) * heads + m) * G + i % G, true);
    }
    cp_async_commit();
  };

  const int chunks = (queries + qc - 1) / qc;
  const int c_lo = rank * chunks / split, c_hi = (rank + 1) * chunks / split;  // this block's
  if (c_lo < c_hi) stage(c_lo);
  for (int i = threadIdx.x; i < npx * G; i += kThreads) dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < npx; i += kThreads) cnt[i] = 0;
  if (threadIdx.x == 0) n_touched = 0;
  for (int ci = c_lo; ci < c_hi; ++ci) {
    const int ns = min(qc, queries - ci * qc) * points;
    const float4* sg = chunk_g(ci);
    const float2* sl = chunk_l(ci);
    const float* sa = chunk_a(ci);
    if (ci + 1 < c_hi) {
      stage(ci + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // 1. owners' d_aw and d_loc; the band's corners' slots
    for (int i = threadIdx.x; i < ns; i += kThreads) {
      const Sample s = locate(sl[i], h, w);
      const float a = sa[i];
      const int q = i / points;
      const int oy = s.valid && h > 0 ? min(max(s.y0, 0), h - 1) : 0;
      float wk[4];
      corner_weights(s, wk);
      if (oy / rows == band) {
        float4 v[4][G];  // the corners, all loads issued before their use
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int y = s.y0 + (c >> 1), x = s.x0 + (c & 1);
#pragma unroll
          for (int j = 0; j < G; ++j) {
            v[c][j] = (s.mask >> c & 1) ? __ldg(vb + (y * w + x) * pix_stride + j)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
        float gd[4] = {0.f, 0.f, 0.f, 0.f};  // g . corner
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int j = 0; j < G; ++j) gd[c] += dot4(sg[q * G + j], v[c][j]);
        }
        const long long k = ((b * queries + ci * qc + q) * heads + m) * lp +
                            (long long)l * points + (i - q * points);
        d_aw[k] = wk[0] * gd[0] + wk[1] * gd[1] + wk[2] * gd[2] + wk[3] * gd[3];
        const float dpx = (1.f - s.fy) * (gd[1] - gd[0]) + s.fy * (gd[3] - gd[2]);
        const float dpy = (1.f - s.fx) * (gd[2] - gd[0]) + s.fx * (gd[3] - gd[1]);
        reinterpret_cast<float2*>(d_loc)[k] = make_float2(a * dpx * w, a * dpy * h);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int y = s.y0 + (c >> 1);
        if ((s.mask >> c & 1) && y >= y_lo && y < y_hi && a * wk[c] != 0.f) {
          const int p = (y - y_lo) * w + s.x0 + (c & 1);
          const int k = atomicAdd(cnt + p, 1);
          slot[i * 4 + c] = (unsigned short)k;
          if (k == 0) touched[atomicAdd(&n_touched, 1)] = (unsigned short)p;
        }
      }
    }
    __syncthreads();
    // 2. the touched pixels' slices: base[k] = the start of touched[k]'s
    const int nt = n_touched;
    for (int k = threadIdx.x; k < nt; k += kThreads) base[k] = cnt[touched[k]];
    if (threadIdx.x == 0 && nt > 0) last_count = cnt[touched[nt - 1]];
    __syncthreads();
    block_exclusive_scan(base, nt);
    __syncthreads();
    if (threadIdx.x == 0) n_touched = 0;  // every thread has read it
    for (int k = threadIdx.x; k < nt; k += kThreads) cnt[touched[k]] = base[k];
    __syncthreads();
    // 3. the entries, each at its pixel's start plus its slot
    for (int i = threadIdx.x; i < ns; i += kThreads) {
      const Sample s = locate(sl[i], h, w);
      float wk[4];
      corner_weights(s, wk);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int y = s.y0 + (c >> 1);
        if ((s.mask >> c & 1) && y >= y_lo && y < y_hi && sa[i] * wk[c] != 0.f) {
          list[cnt[(y - y_lo) * w + s.x0 + (c & 1)] + slot[i * 4 + c]] =
              (unsigned short)(i * 4 + c);
        }
      }
    }
    __syncthreads();
    // 4. each (touched pixel, 4 channels) sums its slice
    for (int t = threadIdx.x; t < nt * G; t += kThreads) {
      const int k = t / G, j = t % G;
      const int p = touched[k];
      const int end = k + 1 < nt ? base[k + 1] : base[k] + last_count;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = base[k]; r < end; ++r) {
        const int e = list[r];
        const int i = e >> 2, c = e & 3;
        const Sample s = locate(sl[i], h, w);
        float wk[4];
        corner_weights(s, wk);
        const float coef = sa[i] * wk[c];
        const float4 g = sg[(i / points) * G + j];
        acc.x += coef * g.x;
        acc.y += coef * g.y;
        acc.z += coef * g.z;
        acc.w += coef * g.w;
      }
      float4 d = dv[p * G + j];
      d.x += acc.x;
      d.y += acc.y;
      d.z += acc.z;
      d.w += acc.w;
      dv[p * G + j] = d;
      if (j == 0) cnt[p] = 0;  // for the next chunk
    }
    __syncthreads();  // the next chunk's copies overwrite the buffer before this one
  }
  // The band out, once: pixel-major, each pixel's D floats coalesced; with
  // a split, each block writes its share of the band, the partials summed in
  // rank order.
  if (split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  float4* out = reinterpret_cast<float4*>(d_value) +
                ((b * spatial + lv.start[l] + (long long)y_lo * w) * heads + m) * G;
  const int share = (npx * G + split - 1) / split;
  const int i_hi = min(npx * G, (rank + 1) * share);
  for (int i = rank * share + threadIdx.x; i < i_hi; i += kThreads) {
    float4 d = dv[i];
    if (split > 1) {
      d = cluster.map_shared_rank(dv, 0)[i];
      for (int r = 1; r < split; ++r) {
        const float4 e = cluster.map_shared_rank(dv, r)[i];
        d.x += e.x;
        d.y += e.y;
        d.z += e.z;
        d.w += e.w;
      }
    }
    out[(long long)(i / G) * pix_stride + i % G] = d;
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads its shared memory
}

template <int G>
cudaError_t launch(const float* value, const float* loc, const float* aw, const float* grad,
                   float* d_value, float* d_loc, float* d_aw, const Levels& lv,
                   const Bands& bands, int total_bands, size_t bytes, int num_levels,
                   int batch, int spatial, int queries, int heads, int points, int qc,
                   int split, cudaStream_t stream) {
  const long long blocks = (long long)batch * heads * total_bands * split;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = msda_bwd_kernel<G>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  if (split == 1) {
    kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(
        value, loc, aw, grad, d_value, d_loc, d_aw, lv, bands, num_levels, spatial, queries,
        heads, points, qc, total_bands);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, value, loc, aw, grad, d_value, d_loc, d_aw, lv,
                            bands, num_levels, spatial, queries, heads, points, qc,
                            total_bands);
}

}  // namespace

// value (B, S, M, D), loc (B, Lq, M, L, P, 2), aw (B, Lq, M, L, P), grad
// (B, Lq, M*D); d_value as value, d_loc as loc, d_aw as aw, each written
// whole by the kernel (no zero-fill needed): float32, contiguous, 16-byte
// aligned. Level l is h[l] x w[l] starting at row start[l] of S; 1 <= L <=
// 16; D is 4, 8 or 16. band_rows[l] >= 1 rows of level l a block owns;
// split (1 or 2) blocks take a band's samples together. Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue where a band outgrows
// shared memory); launches on `stream`.
extern "C" int raft_msda_bwd(const void* value, const void* loc, const void* aw,
                             const void* grad, void* d_value, void* d_loc, void* d_aw,
                             const int* h, const int* w, const int* start,
                             const int* band_rows, int num_levels, int batch, int spatial,
                             int queries, int heads, int channels, int points, int split,
                             void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || batch < 0 || queries < 0 ||
      heads < 1 || points < 1 || spatial < 0 || split < 1 || split > 2 ||
      (channels != 4 && channels != 8 && channels != 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const Levels lv = make_levels(h, w, start, num_levels);
  const int qc = queries < kChunk / points ? (queries > 0 ? queries : 1)
                                           : (kChunk / points > 0 ? kChunk / points : 1);
  Bands bands;
  long long floats = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    bands.rows[l] = 1;
    bands.count[l] = 0;
    bands.first[l] = 0;
    if (l >= num_levels) continue;
    if (band_rows[l] < 1) return (int)cudaErrorInvalidValue;
    const int rows = band_rows[l] < lv.h[l] ? band_rows[l] : (lv.h[l] > 0 ? lv.h[l] : 1);
    bands.rows[l] = rows;
    bands.count[l] = lv.h[l] > 0 ? (lv.h[l] + rows - 1) / rows : 1;
    // the first band is the largest
    const long long need = layout(rows * lv.w[l], qc, points, channels).total;
    floats = need > floats ? need : floats;
  }
  if (floats * (long long)sizeof(float) > kMaxSmem) return (int)cudaErrorInvalidValue;
  // band ranks: the levels with the largest bands first (stable)
  int total = 0;
  bool placed[kMaxLevels] = {};
  for (int n = 0; n < num_levels; ++n) {
    int best = -1;
    for (int l = 0; l < num_levels; ++l) {
      if (placed[l]) continue;
      if (best < 0 || bands.rows[l] * lv.w[l] > bands.rows[best] * lv.w[best]) best = l;
    }
    placed[best] = true;
    bands.first[best] = total;
    total += bands.count[best];
  }
  const size_t bytes = (size_t)floats * sizeof(float);
  if ((long long)batch * spatial == 0) return 0;
  const float* v = static_cast<const float*>(value);
  const float* l = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  const float* g = static_cast<const float*>(grad);
  float* dv = static_cast<float*>(d_value);
  float* dl = static_cast<float*>(d_loc);
  float* da = static_cast<float*>(d_aw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSDA_LAUNCH(G) launch<G>(v, l, a, g, dv, dl, da, lv, bands, total, bytes, num_levels, \
                                 batch, spatial, queries, heads, points, qc, split, s)
  cudaError_t err;
  switch (channels) {
    case 4: err = MSDA_LAUNCH(1); break;
    case 8: err = MSDA_LAUNCH(2); break;
    default: err = MSDA_LAUNCH(4); break;
  }
#undef MSDA_LAUNCH
  return (int)err;
}
