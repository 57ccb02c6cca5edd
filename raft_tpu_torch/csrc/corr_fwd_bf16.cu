// On-demand windowed correlation, forward, bf16 form, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of raft_tpu/ops/corr_pallas.py
// (:206, reached through `_pallas_fwd`, :373, from
// `windowed_correlation_pallas_fused`, :568) at mxu_dtype = "bfloat16": the
// function of corr_fwd.cu with both operands of every product rounded to
// bfloat16 (a float32 map in the kernel, to nearest even; a bfloat16 map as
// it is), float32 sums, the bilinear weights and 1/sqrt(C) in float32 (the
// TPU kernel's product by 1/sqrt(C)), zero padding, and the windows stored
// in the maps' type M from the float32 value (the port's lookup asks for
// its windows in the dtype of its maps).
//
// A kernel of its own on corr_tile.cuh's 8 x 8 query tile, box, near test
// and path rule (TILE_BUDGET; path_counts one a (tile, level)). A block
// takes a tile at kLevelsPerBlock levels (one, by default):
//   - F1 (64 queries x C) is staged once a block in bfloat16, in the
//     ring's last stage (rows padded by 16 bytes: ldmatrix without bank
//     conflicts), copied from the block index behind the centres' loads;
//     each warp then holds its 16 queries' fragments in registers (64 at
//     C=256) for every chunk of the block's levels, and the stage rejoins
//     the ring;
//   - box chunks of kChunk = 64 pixels over the whole C are the only loop:
//     a stage holds a chunk's map rows in bfloat16 (a float32 map's loaded,
//     rounded to nearest even and stored four rows a thread at a time), on
//     a ring of kStages stages (2 at C=256, 4 at C=128) by 16-byte
//     cp.async, the next chunk's copies, across levels too, in flight while
//     one multiplies (cp.async.wait_group kStages - 2), one barrier a
//     chunk; a box pixel's row and column from a float estimate of the row
//     (box_at), no integer division;
//   - the map's fragments by ldmatrix (corr_tile_bf16.cuh's ldsm_x4),
//     m16n8k16 bf16 mma.sync with float32 sums, 8 warps as 4 x 2 blocks of
//     16 queries x 32 pixels; each sum that is one of its query's (2r+2)^2
//     neighbours' dots goes from the accumulators into S (64 x (2r+2)^2
//     floats);
//   - after a level's last chunk a thread takes a (query, column i) of the
//     level's windows: its 2 (2r+2) dots from S (a neighbour off the level,
//     whose stale entry is never read, is zero), the four bilinear weights
//     and 1/sqrt(C) in float32, (2r+1) windows into O;
//   - a level whose box exceeds `budget` takes the warp path after the
//     chunks: a warp a query, 8 lanes a neighbour (4 a warp load, C / 8
//     channels a lane in 16-byte pieces, 3 shuffles a dot), F1 from L2; the
//     query's windows by the warp's lanes into O;
//   - O holds the block's windows at the output's alignment modulo 16 bytes
//     (RowStage), so that each query's run of (2r+1)^2 windows (a tile
//     row's whole rows, where a block takes every level) goes out in
//     16-byte stores, single elements at each end.
// Grid, kept by measurement (scripts/corr_tile_bench.py fwd_bf16: the
// default against variants levels2 and levels4; PERF.md section 6):
// one block a (tile, level), 448 at Sintel B=1, level 0's first, two an
// SM (93 KB of shared memory with O over the idle ring, at most 128
// registers a thread), so that one block's set-up, barriers and epilogue
// overlap the other's copies and products. A block a tile over all four
// levels (112 at Sintel, one an SM, O apart) stages F1 a quarter as often
// but leaves 20 SMs idle and runs a tile's levels, its warp-path levels on
// incoherent flows too, one after another on one SM: slower on every input
// measured, as is a block over two levels.
// Bound on an H100 SXM (Sintel, B=1, 55x128 queries, C=256, 4 levels, r=4):
// the same 1.44 GFLOP at 989 TFLOP/s (bf16 tensor cores) is 1.5 us, against
// about 13 MB of compulsory bfloat16 traffic (fmap1, the four levels, the
// coordinates and the bfloat16 windows), 4 us at 3.35 TB/s: bound by bytes.
// What paces the kernel instead is each block's latency (about 28k cycles
// a block at Sintel coherent, two blocks an SM): its set-up, each chunk's
// barrier, copies, products and dots into S in turn, then the windows and
// the stores (the `stamps` variant's breakdown).
// C is 128 or 256: RAFT-small's and RAFT-large's feature widths.

#include <atomic>
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "corr_tile_bf16.cuh"

namespace {

using namespace corr_tile;
using corr_tile_bf16::ldsm_x4;
using corr_tile_bf16::Piece;
using corr_tile_bf16::Rows;
using corr_tile_bf16::tile_origin;
using corr_tile_bf16::tile_query;
using corr_tile_bf16::TileOrigin;
using bf16 = __nv_bfloat16;

// The grid: one block a tile over kLevelsPerBlock levels. A block over one
// level runs two to an SM, O over its idle ring; one over several runs
// alone on its SM, O apart.
constexpr int kLevelsPerBlock = 1;
constexpr int kBlocksPerSM = kLevelsPerBlock == 1 ? 2 : 1;
constexpr bool kOverRing = kLevelsPerBlock == 1;      // O lies over the ring
constexpr bool kStamps = false;                       // clock64() phase stamps (the bench's)
constexpr int kChunk = 64;                            // box pixels a chunk stage
// The products' warps: 4 across the tile's queries (16 each, their F1
// fragments in registers), 2 across a chunk's pixels (32 each, NT n8
// blocks).
constexpr int kWM = 16;
constexpr int kWN = 32;
constexpr int NT = kWN / 8;
static_assert((kQ / kWM) * (kChunk / kWN) == kWarps, "the warps cover a chunk");
// Dynamic shared memory a block may take beside its static TileQueries
// (an SM's 228 KB less 1 KB a block; 227 KB at most).
constexpr int kDynMax = (kBlocksPerSM == 1 ? 232448 : 233472 / 2 - 1024) -
                        kLevelsPerBlock * (int)sizeof(TileQueries);

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }

// The most ring stages, 2 to n, that fit beside `fixed` bytes (at least
// `floor` bytes of ring: O over it).
__host__ __device__ constexpr int ring_stages(int fixed, int stage, int floor, int n) {
  return n > 2 && fixed + max_of(n * stage, floor) > kDynMax ? ring_stages(fixed, stage, floor, n - 1)
                                                             : n;
}

// The dynamic shared memory of the <R, C, M> kernel: S, the ring (F1 staged
// in its last stage first), O. O is in units: a tile row of whole rows (8
// queries' L (2r+1)^2 windows) when the block takes every level, else a
// query's windows of the block's levels; each unit 16 bytes longer than its
// windows, for its shift.
template <int R, int C, typename M>
struct Layout {
  static constexpr int D = 2 * R + 2;
  static constexpr int WW = (2 * R + 1) * (2 * R + 1);
  static constexpr int LD = C + 8;              // a staged row, bfloat16 elements
  static constexpr int kStage = kChunk * LD * 2;
  static constexpr int kS = kQ * D * D * 4;
  static constexpr int kRowUnit = round16(kTile * kLevelsPerBlock * WW * (int)sizeof(M)) + 16;
  static constexpr int kQueryUnit = round16(kLevelsPerBlock * WW * (int)sizeof(M)) + 16;
  static constexpr int kO = max_of(kTile * kRowUnit, kQ * kQueryUnit);
  static constexpr int kFixed = kS + (kOverRing ? 0 : kO);
  static constexpr int kStages = ring_stages(kFixed, kStage, kOverRing ? kO : 0, 4);
  static constexpr int kBytes = kFixed + max_of(kStages * kStage, kOverRing ? kO : 0);
  static_assert(kBytes <= kDynMax, "the blocks fit the SM's shared memory");
  static_assert(kS >= kWarps * D * D * 4, "the warp path's dots fit in S");
  static_assert(kChunk == kQ, "F1 fits a stage");
};

// One phase's cycles (thread 0's clock, barriers included) added to
// path_counts[4 + slot] when kStamps: the bench's breakdown.
__device__ __forceinline__ void stamp(long long& st, Count* path_counts, int slot) {
  if constexpr (kStamps) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      atomicAdd(path_counts + 4 + slot, (Count)(now - st));
      st = now;
    }
  }
}

// The tile's queries at levels l_lo .. l_lo + nl - 1 (load_tile's rule per
// level, each warp's box reduced before its atomics), from thread tid < kQ's
// query q of slot tid (-1 past the image) and its level-0 centre (cx0,
// cy0): t[li] for level l_lo + li. Ends in a barrier.
template <int R>
__device__ void load_levels(TileQueries* t, long long q, float cx0, float cy0, int H, int W,
                            const Levels& lv, int l_lo, int nl, bool rescale) {
  constexpr int D = 2 * R + 2;
  const int tid = threadIdx.x;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int b = blockIdx.x / (tiles_x * ((H + kTile - 1) / kTile));
  if (tid < nl) {
    t[tid].box[0] = t[tid].box[1] = INT_MAX;
    t[tid].box[2] = t[tid].box[3] = INT_MIN;
    t[tid].b = b;
  }
  __syncthreads();
  if (tid < kQ) {  // warps 0 and 1, whole
    for (int li = 0; li < nl; ++li) {
      const int l = l_lo + li;
      const int h2 = lv.h[l], w2 = lv.w[l];
      float dx = 0.f, dy = 0.f;
      int x0 = 0, y0 = 0, near = 0;
      int xl = INT_MAX, yl = INT_MAX, xh = INT_MIN, yh = INT_MIN;
      if (q >= 0) {
        const float lvl_div = rescale ? (float)(1 << l) : 1.f;
        const float cx = cx0 / lvl_div;
        const float cy = cy0 / lvl_div;
        const float fx = floorf(cx);
        const float fy = floorf(cy);
        dx = cx - fx;
        dy = cy - fy;
        near = fabsf(fx) < 1.0e8f && fabsf(fy) < 1.0e8f;
        if (near) {
          x0 = (int)fx - R;
          y0 = (int)fy - R;
          const int cxl = max(x0, 0), cxh = min(x0 + D - 1, w2 - 1);
          const int cyl = max(y0, 0), cyh = min(y0 + D - 1, h2 - 1);
          if (cxl <= cxh && cyl <= cyh) {
            xl = cxl, xh = cxh, yl = cyl, yh = cyh;
          }
        }
      }
      xl = __reduce_min_sync(0xffffffffu, xl);
      yl = __reduce_min_sync(0xffffffffu, yl);
      xh = __reduce_max_sync(0xffffffffu, xh);
      yh = __reduce_max_sync(0xffffffffu, yh);
      if ((tid & 31) == 0 && xl <= xh) {
        atomicMin(&t[li].box[0], xl);
        atomicMin(&t[li].box[1], yl);
        atomicMax(&t[li].box[2], xh);
        atomicMax(&t[li].box[3], yh);
      }
      t[li].q[tid] = q;
      t[li].x0[tid] = x0;
      t[li].y0[tid] = y0;
      t[li].dx[tid] = dx;
      t[li].dy[tid] = dy;
      t[li].near[tid] = near;
    }
  }
  __syncthreads();
}

// The tile's windows in shared memory, in units (Layout): unit u at
// base + u * unit_bytes + its shift, the output address of the unit's first
// element modulo 16 bytes, so that a unit and the output's run for it share
// their 16-byte words. A unit is a tile row (whole) or a query.
template <typename M>
struct RowStage {
  char* base;
  int unit_bytes;
  int row_elems;     // a query's output row: L (2r+1)^2
  int e_lo;          // the block's first element of a row
  bool whole;        // units are tile rows of whole rows
  long long first;   // query slot 0's global index
  int W;
  const int* shift;  // each unit's shift, set by set_shifts
  // the output index of unit u's first element
  __device__ __forceinline__ long long out_first(int u) const {
    const int qi = whole ? u * kTile : u;
    return (first + (long long)(qi / kTile) * W + qi % kTile) * row_elems + e_lo;
  }
  // the units' shifts into s (kQ ints), by the block's first kQ threads
  __device__ __forceinline__ void set_shifts(int* s) const {
    if (threadIdx.x < (whole ? kTile : kQ)) {
      s[threadIdx.x] = (int)(out_first(threadIdx.x) * (long long)sizeof(M) & 15);
    }
  }
  // element e_lo + e of query slot qi's row
  __device__ __forceinline__ M* at(int qi, int e) const {
    const int u = whole ? qi / kTile : qi;
    return reinterpret_cast<M*>(base + u * unit_bytes + shift[u]) +
           (whole ? (qi % kTile) * row_elems : 0) + e;
  }
};

// Column i of query slot qi's windows (i * WIN + j, j < WIN) from its dots
// (row-major, D a row) into O: the float32 form's window_value (the four
// bilinear weights in its order), times 1/sqrt(C) as the TPU kernel, a
// neighbour off the level (whose dot the kernel never writes) read as
// zero; zeros for a centre that is not near.
template <int R, typename M>
__device__ __forceinline__ void window_column(const TileQueries& t, int qi, int i,
                                              const float* dots, int h2, int w2,
                                              float inv_scale, M* o) {
  constexpr int D = 2 * R + 2;
  constexpr int WIN = 2 * R + 1;
  if (!t.near[qi]) {
#pragma unroll
    for (int j = 0; j < WIN; ++j) store_out(o + j, 0.f);
    return;
  }
  const float dx = t.dx[qi], dy = t.dy[qi];
  const float w00 = (1.f - dx) * (1.f - dy);
  const float w10 = dx * (1.f - dy);
  const float w01 = (1.f - dx) * dy;
  const float w11 = dx * dy;
  const int x = t.x0[qi] + i, y0 = t.y0[qi];
  const bool xa = (unsigned)x < (unsigned)w2, xb = (unsigned)(x + 1) < (unsigned)w2;
  float a[D], b[D];  // neighbours (i, j) and (i + 1, j)
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const bool yj = (unsigned)(y0 + j) < (unsigned)h2;
    a[j] = xa && yj ? dots[j * D + i] : 0.f;
    b[j] = xb && yj ? dots[j * D + i + 1] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < WIN; ++j) {
    store_out(o + j, (w00 * a[j] + w10 * b[j] + w01 * a[j + 1] + w11 * b[j + 1]) * inv_scale);
  }
}

// Row and column of box pixel p in a box of width bw, inv_bw = 1 / bw: a
// float estimate of the row, off by at most one, corrected.
__device__ __forceinline__ void box_at(int p, int bw, float inv_bw, int& y, int& x) {
  y = __float2int_rz(((float)p + 0.5f) * inv_bw);
  x = p - y * bw;
  if (x < 0) {
    --y;
    x += bw;
  } else if (x >= bw) {
    ++y;
    x -= bw;
  }
}

// Eight channels of a map as loaded (16 bytes of bfloat16, 32 of
// float32), and their dot with eight floats, each channel rounded to
// bfloat16 (exact for a bfloat16 map): acc + sum a[k] v[k], in k's order.
template <typename M>
struct Eight;

template <>
struct Eight<bf16> {
  uint4 u;
  __device__ __forceinline__ void floats(float* a) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      a[2 * k] = f.x;
      a[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ void load(const bf16* p, bool ok) {
    u = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ float dot(const float* a, float acc) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      acc = fmaf(a[2 * k], f.x, acc);
      acc = fmaf(a[2 * k + 1], f.y, acc);
    }
    return acc;
  }
};

template <>
struct Eight<float> {
  float4 x, y;
  __device__ __forceinline__ void floats(float* a) const {
    const float v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = round_bf16(v[k]);
  }
  __device__ __forceinline__ void load(const float* p, bool ok) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    x = ok ? __ldg(reinterpret_cast<const float4*>(p)) : zero;
    y = ok ? __ldg(reinterpret_cast<const float4*>(p) + 1) : zero;
  }
  __device__ __forceinline__ float dot(const float* a, float acc) const {
    const float v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(a[k], round_bf16(v[k]), acc);
    return acc;
  }
};

// Window k (i * WIN + j) of query slot qi, as window_column computes it.
template <int R>
__device__ __forceinline__ float window_at(const TileQueries& t, int qi, int k,
                                           const float* dots, int h2, int w2, float inv_scale) {
  constexpr int D = 2 * R + 2;
  constexpr int WIN = 2 * R + 1;
  if (!t.near[qi]) return 0.f;
  const float dx = t.dx[qi], dy = t.dy[qi];
  const int i = k / WIN, j = k % WIN;
  const int x = t.x0[qi] + i, y = t.y0[qi] + j;
  const bool xa = (unsigned)x < (unsigned)w2, xb = (unsigned)(x + 1) < (unsigned)w2;
  const bool ya = (unsigned)y < (unsigned)h2, yb = (unsigned)(y + 1) < (unsigned)h2;
  const float* p = dots + j * D + i;
  return ((1.f - dx) * (1.f - dy) * (xa && ya ? p[0] : 0.f) +
          dx * (1.f - dy) * (xb && ya ? p[1] : 0.f) + (1.f - dx) * dy * (xa && yb ? p[D] : 0.f) +
          dx * dy * (xb && yb ? p[D + 1] : 0.f)) *
         inv_scale;
}

// The warp path at one level: warp w takes query slots w, w + kWarps, ...
// A neighbour's dot is kGroup = 8 lanes', C / 8 channels a lane in 16-byte
// pieces (the group's pieces side by side: 128 bytes a load), 4 neighbours
// a warp load, summed over the group by 3 shuffles; a query's (2r+2)^2
// neighbours in row-major batches of kPer a group, their loads issued
// together (32 registers); F1 from L2. The dots go to the warp's D x D
// scratch, then each lane writes windows of the query into O.
template <int R, int C, typename M>
__device__ void warp_level(const TileQueries& t, const M* __restrict__ fmap1,
                           const M* __restrict__ f2, int h2, int w2, float* scratch,
                           const RowStage<M>& O, int e0, float inv_scale) {
  constexpr int D = 2 * R + 2;
  constexpr int WW = (2 * R + 1) * (2 * R + 1);
  constexpr int kGroup = 8;                            // lanes a neighbour
  constexpr int kSlots = 32 / kGroup;                  // neighbours a warp load
  constexpr int kPieces = C / (8 * kGroup);            // 16-byte pieces a lane a neighbour
  constexpr int kPer = max_of(1, (sizeof(M) == 2 ? 8 : 4) / kPieces);  // a group's a batch
  constexpr int kStep = kSlots * kPer;                 // neighbours a batch
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cb = lane % kGroup;                        // piece pp: channels 8 (cb + 8 pp)
  const int slot = lane / kGroup;
  float* dots = scratch + warp * D * D;
  for (int qi = warp; qi < kQ; qi += kWarps) {
    if (t.q[qi] < 0) continue;  // warp-uniform
    const bool near = t.near[qi];
    const int x0 = t.x0[qi], y0 = t.y0[qi];
    float a[8 * kPieces];
#pragma unroll
    for (int pp = 0; pp < kPieces; ++pp) {
      Eight<M> f;
      f.load(fmap1 + t.q[qi] * C + 8 * (cb + kGroup * pp), true);
      f.floats(a + 8 * pp);
    }
    for (int n0 = 0; n0 < D * D; n0 += kStep) {
      Eight<M> v[kPer][kPieces];
      bool ok[kPer];
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int n = n0 + kSlots * p + slot;
        const int yy = y0 + n / D, xx = x0 + n % D;
        ok[p] = near && n < D * D && (unsigned)yy < (unsigned)h2 && (unsigned)xx < (unsigned)w2;
        const M* src = f2 + (ok[p] ? ((long long)yy * w2 + xx) * C : 0);
#pragma unroll
        for (int pp = 0; pp < kPieces; ++pp) v[p][pp].load(src + 8 * (cb + kGroup * pp), ok[p]);
      }
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        float acc = 0.f;
#pragma unroll
        for (int pp = 0; pp < kPieces; ++pp) acc = v[p][pp].dot(a + 8 * pp, acc);
#pragma unroll
        for (int off = kGroup / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        const int n = n0 + kSlots * p + slot;
        if (cb == 0 && n < D * D) dots[n] = acc;  // zero off the level
      }
    }
    __syncwarp();
    for (int k = lane; k < WW; k += 32) {
      store_out(O.at(qi, e0 + k), window_at<R>(t, qi, k, dots, h2, w2, inv_scale));
    }
    __syncwarp();
  }
}

// One block of the bf16 forward: tile blockIdx.x at levels blockIdx.y *
// kLevelsPerBlock.., as the header says.
template <int R, int C, typename M>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
corr_fwd_bf16_kernel(const M* __restrict__ fmap1, const __grid_constant__ Levels lv,
                     const int num_levels, const float* __restrict__ coords,
                     M* __restrict__ out, const int H, const int W, const int rescale,
                     const float scale_div, const int budget, Count* __restrict__ path_counts) {
  using Lay = Layout<R, C, M>;
  using Rows64 = Rows<C>;   // a thread's pieces of F1's 64 rows, or a chunk's
  constexpr int D = 2 * R + 2;
  constexpr int DD = D * D;
  constexpr int WIN = 2 * R + 1;
  constexpr int WW = Lay::WW;
  constexpr int LD = Lay::LD;
  constexpr int NS = Lay::kStages;
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  bf16* ring = reinterpret_cast<bf16*>(S + kQ * DD);
  bf16* F1 = ring + (NS - 1) * kChunk * LD;  // F1 in the last stage, until chunk NS - 1
  __shared__ TileQueries t[kLevelsPerBlock];
  __shared__ int shifts[kQ];
  long long st = kStamps ? clock64() : 0;
  const float inv_scale = 1.f / scale_div;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int l_lo = blockIdx.y * kLevelsPerBlock;
  const int nl = min(kLevelsPerBlock, num_levels - l_lo);
  const TileOrigin origin = tile_origin(H, W);
  // the centres first, then F1, the latency of each behind the other
  const long long q0 = tid < kQ ? tile_query(origin, tid, H, W) : -1;
  float cx0 = 0.f, cy0 = 0.f;
  if (q0 >= 0) {
    cx0 = coords[2 * q0];
    cy0 = coords[2 * q0 + 1];
  }
  const int row0 = Rows64::first_row(), col = 8 * Rows64::piece();
  // F1 from the block index: a bfloat16 map's by cp.async (its own group),
  // a float32 map's into registers, stored once the centres are in
  {
    Piece<M> pieces[Rows64::kCopies];
#pragma unroll
    for (int i = 0; i < Rows64::kCopies; ++i) {
      const int row = row0 + Rows64::kRowStep * i;
      const long long q = tile_query(origin, row, H, W);
      pieces[i].fetch(F1 + row * LD + col, fmap1 + (q >= 0 ? q * C : 0) + col, q >= 0);
    }
    cp_async_commit();
    load_levels<R>(t, q0, cx0, cy0, H, W, lv, l_lo, nl, rescale);
#pragma unroll
    for (int i = 0; i < Rows64::kCopies; ++i) {
      pieces[i].land(F1 + (row0 + Rows64::kRowStep * i) * LD + col);
    }
  }
  if constexpr (kStamps) {
    if (tid == 0) atomicAdd(path_counts + 15, 1ULL);  // the blocks
  }
  // level li's box (pixels, width), path, and map of the tile's image
  const int max_box = budget;
  auto pixels = [&](int li, int& bw) { return box_pixels(t[li], bw); };
  auto shared_level = [&](int li) {
    int bw;
    return pixels(li, bw) <= max_box;
  };
  auto level_map = [&](int li) {
    const int l = l_lo + li;
    return reinterpret_cast<const M*>(lv.ptr[l]) + (long long)t[0].b * lv.h[l] * lv.w[l] * C;
  };
  if (tid == 0) {  // one count a (tile, level)
    for (int li = 0; li < nl; ++li) atomicAdd(path_counts + (shared_level(li) ? 0 : 1), 1ULL);
  }
  const bool whole = nl == num_levels;
  const RowStage<M> O{reinterpret_cast<char*>(kOverRing ? ring : ring + NS * kChunk * LD),
                      whole ? Lay::kRowUnit : Lay::kQueryUnit,
                      num_levels * WW,
                      l_lo * WW,
                      whole,
                      origin.first,
                      W,
                      shifts};
  O.set_shifts(shifts);  // read after the next barrier
  // level li's windows from the dots in S into O, a thread a (query,
  // column); O lies over the ring only where the ring is idle
  auto level_windows = [&](int li) {
    const int h2 = lv.h[l_lo + li], w2 = lv.w[l_lo + li];
    for (int it = tid; it < kQ * WIN; it += kThreads) {
      const int qi = it / WIN, i = it % WIN;
      if (t[li].q[qi] >= 0) {
        window_column<R>(t[li], qi, i, S + qi * DD, h2, w2, inv_scale,
                         O.at(qi, li * WW + i * WIN));
      }
    }
  };
  stamp(st, path_counts, 0);
  // the copy cursor: the next chunk to stage, level c_li from pixel c_n0
  int c_li = 0, c_n0 = 0;
  auto skip_done = [&]() {
    int bw;
    while (c_li < nl && (!shared_level(c_li) || c_n0 >= pixels(c_li, bw))) {
      ++c_li;
      c_n0 = 0;
    }
  };
  skip_done();
  // the cursor's chunk into ring slot `slot`, the cursor advanced, one
  // group committed: a bfloat16 map's rows by cp.async, a float32 map's
  // loaded and stored in batches of kBatch rows (its rows are not held in
  // registers beside the products' F1 fragments)
  auto issue = [&](int slot) {
    if (c_li < nl) {
      constexpr int kBatch = sizeof(M) == 2 ? Rows64::kCopies : 4;
      const TileQueries& tl = t[c_li];
      int bw;
      const int nb = pixels(c_li, bw);
      const int w2 = lv.w[l_lo + c_li];
      const M* f2 = level_map(c_li) + ((long long)tl.box[1] * w2 + tl.box[0]) * C + col;
      bf16* dst = ring + slot * kChunk * LD;
      const float inv_bw = 1.f / bw;
#pragma unroll
      for (int i0 = 0; i0 < Rows64::kCopies; i0 += kBatch) {
        Piece<M> pieces[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int row = row0 + Rows64::kRowStep * (i0 + i);
          int y, x;
          box_at(c_n0 + row, bw, inv_bw, y, x);
          const bool ok = c_n0 + row < nb;
          pieces[i].fetch(dst + row * LD + col, f2 + (ok ? ((long long)y * w2 + x) * C : 0), ok);
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) pieces[i].land(dst + (row0 + Rows64::kRowStep * (i0 + i)) * LD + col);
      }
      c_n0 += kChunk;
      skip_done();
    }
    cp_async_commit();
  };
  for (int s = 0; s < NS - 1; ++s) issue(s);  // the first NS - 1 chunks
  stamp(st, path_counts, 1);
  // ldmatrix rows: A blocks (queries x 8 channels), B blocks (pixels x 8
  // channels), as mma_bf16 takes them
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp / (kChunk / kWN) * kWM;  // the warp's queries
  const int wn = warp % (kChunk / kWN) * kWN;  // and pixels of a chunk
  // the warp's F1 fragments, from the last stage into registers; the loop's
  // first barrier comes before the stage is refilled
  uint32_t a[C / 16][4];
  cp_async_wait<NS - 1>();  // F1's group (the first chunks may fly)
  __syncthreads();
#pragma unroll
  for (int s = 0; s < C / 16; ++s) ldsm_x4(a[s], F1 + (wm + a_row) * LD + 16 * s + a_col);
  int k = 0;                            // chunks taken
  for (int li = 0; li < nl; ++li) {
    if (!shared_level(li)) continue;
    const TileQueries& tl = t[li];
    int bw;
    const int nb = pixels(li, bw);
    const float inv_bw = 1.f / bw;
    // this thread's query slots of the accumulators, wm + g + 8 e2: a slot
    // that is not near takes no dot (its neighbours lie far off)
    int qx0[2], qy0[2];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int qi = wm + g + 8 * e2;
      qx0[e2] = tl.near[qi] ? tl.x0[qi] : INT_MIN / 2;
      qy0[e2] = tl.y0[qi];
    }
    for (int n0 = 0; n0 < nb; n0 += kChunk, ++k) {
      cp_async_wait<NS - 2>();
      __syncthreads();  // chunk k in place; chunk k - 1's slot free
      stamp(st, path_counts, 2);
      issue((k + NS - 1) % NS);
      stamp(st, path_counts, 3);
      const bf16* B = ring + (k % NS) * kChunk * LD;
      if (wn < nb - n0) {  // warp-uniform: its 32 pixels are not all past the box
        float acc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
        for (int s = 0; s < C / 16; ++s) {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t b[4];
            ldsm_x4(b, B + (wn + 16 * np + b_row) * LD + 16 * s + b_col);
            mma_bf16(acc[2 * np], a[s], b);
            mma_bf16(acc[2 * np + 1], a[s], b + 2);
          }
        }
        stamp(st, path_counts, 4);
        // each dot into S where its pixel (n0 + wn + 8 nt + 2 tq + {0, 1})
        // is one of its query's neighbours
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int pix = n0 + wn + 8 * nt + 2 * tq + e1;
            if (pix >= nb) continue;
            int y, x;
            box_at(pix, bw, inv_bw, y, x);
            const int bx = tl.box[0] + x, by = tl.box[1] + y;
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int i = bx - qx0[e2];
              const int j = by - qy0[e2];
              if ((unsigned)i < D && (unsigned)j < D) {
                S[(wm + g + 8 * e2) * DD + j * D + i] = acc[nt][2 * e2 + e1];
              }
            }
          }
      }
      stamp(st, path_counts, 5);
    }
    __syncthreads();  // the level's dots are in S (and the ring is idle)
    level_windows(li);
    stamp(st, path_counts, 6);
    // the next level's first dots go into S after the next chunk's barrier
  }
  cp_async_wait<0>();
  __syncthreads();  // S and the ring free for the warp path's dots and O
  for (int li = 0; li < nl; ++li) {
    if (shared_level(li)) continue;
    const int l = l_lo + li;
    warp_level<R, C, M>(t[li], fmap1, level_map(li), lv.h[l], lv.w[l], S, O, li * WW, inv_scale);
  }
  __syncthreads();  // the tile's windows are in O
  stamp(st, path_counts, 7);
  // each unit's run (a tile row of whole rows, or a query's levels) in
  // slots of the block's threads: slot 0 its single elements at each end
  // (fewer than a word each), slot 1 + v its 16-byte word v
  auto store_runs = [&](int units, int most) {  // `most`: a unit's elements
    constexpr int kVec = 16 / (int)sizeof(M);
    const int slots = most / kVec + 2;
    for (int it = tid; it < units * slots; it += kThreads) {
      const int u = it / slots, sl = it % slots;
      const int qi = whole ? u * kTile : u;
      if (tile_query(origin, qi, H, W) < 0) continue;
      const int n = whole ? min(kTile, W - origin.x) * O.row_elems : most;
      M* g = out + O.out_first(u);
      const M* s = O.at(qi, 0);
      const int head = min(n, (int)(((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) / sizeof(M)));
      const int nv = (n - head) / kVec;
      if (sl == 0) {
        const int tail = head + nv * kVec;
#pragma unroll
        for (int i = 0; i < kVec - 1; ++i) {
          if (i < head) g[i] = s[i];
          if (tail + i < n) g[tail + i] = s[tail + i];
        }
      } else if (sl <= nv) {
        reinterpret_cast<uint4*>(g + head)[sl - 1] = reinterpret_cast<const uint4*>(s + head)[sl - 1];
      }
    }
  };
  if (whole) {
    store_runs(kTile, kTile * O.row_elems);
  } else if (nl == kLevelsPerBlock) {  // a constant count: no division at run time
    store_runs(kQ, kLevelsPerBlock * WW);
  } else {
    store_runs(kQ, nl * WW);
  }
  stamp(st, path_counts, 8);
}

template <int R, int C, typename M>
cudaError_t launch_bf16(const FwdArgs& a, int rescale) {
  auto kernel = corr_fwd_bf16_kernel<R, C, M>;
  constexpr int bytes = Layout<R, C, M>::kBytes;
  // the shared-memory limit, raised once a device
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid(a.grid.x, (a.num_levels + kLevelsPerBlock - 1) / kLevelsPerBlock);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const M*>(a.fmap1), a.lv, a.num_levels, a.coords, static_cast<M*>(a.out), a.H,
      a.W, rescale, a.scale_div, a.budget, a.path_counts);
  return cudaGetLastError();
}

// fwd_entry's Widths: the maps' type M, C 128 or 256, rescale a runtime
// flag of one kernel.
template <typename M>
struct Bf16Widths {
  template <int R, bool kRescale>
  static cudaError_t launch(const FwdArgs& a) {
    switch (a.channels) {
      case 128: return launch_bf16<R, 128, M>(a, kRescale);
      case 256: return launch_bf16<R, 256, M>(a, kRescale);
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
