// The bf16 backward's own shared path (csrc/corr_bwd_bf16.cu), NVIDIA
// Hopper (sm_90a), beside the float32 form's tile_grads of corr_tile.cuh,
// which it leaves as it is.
//
// A block is corr_tile.cuh's (tile of 64 queries, level), with its box, path
// rule and warp path, and the fold in the TPU kernel's order. Its shared
// path differs from the float32 form's:
//   - box chunks of kChunk = 64 pixels are the only loop, and each block
//     covers the whole C (128 or 256). The tile's F1 (64 x C) is staged once
//     per block, G (64 queries x 64 pixels of the chunk) is built once per
//     chunk, and df1 (64 x C) stays in registers over the chunks;
//   - every operand is staged in bfloat16. A chunk's bfloat16 maps come by
//     16-byte cp.async into a ring of two chunk stages (64 x C each): the
//     next chunk's copies are in flight while the current chunk is built
//     and multiplied (cp.async.wait_group 1). Float32 maps (mxu "bfloat16"
//     only) are loaded into registers, then rounded to bfloat16 (to nearest
//     even) and stored after the chunk's df2 products;
//   - the tile's cotangents and F1 rows are copied (cp.async) from the
//     block index before the tile's centres are known, and chunk 0 before
//     the fold, so that their latency overlaps the tile's set-up;
//   - fragments come by ldmatrix (.trans where K runs along the staged rows:
//     F1 and the maps, and G^T), conflict-free on rows padded by 16 bytes;
//   - products are m16n8k16 bf16 mma.sync with float32 sums. mxu
//     "bfloat16": G holds the folded coefficient rounded to bfloat16, one
//     pass. mxu "float32" (bfloat16 maps, exact in bfloat16): G holds three
//     planes, the coefficient split c = hi + mid + lo into bfloat16 parts
//     (24 significant bits, against two TF32 parts' 22), three passes into
//     the float32 sums, smallest part first;
//   - df2 of a chunk is complete after its one product (K = the 64 queries).
//     At C=256 each warp stages its 32 x 64 block of it in shared memory (O)
//     and each lane adds one pixel row of the block to df2_l by a TMA bulk
//     reduction (cp.reduce.async.bulk ... add.f32), with no block barrier,
//     as df1 goes at the end; at C=128 the lanes pair up by one shuffle into
//     16-byte (float4) atomics straight from the accumulators, one per pixel
//     and channel quad (kBulkSums).
//
// The tensor cores round their sums toward zero, which drifts in a long
// chain (corr_tile.cuh, mma_3xtf32). At mxu "float32" df1's sums over a
// chunk (4 k16 steps of three passes) are a fresh sum, added to df1 in
// float32 once per chunk; df2's chains are one chunk long anyway.
//
// Shared memory and occupancy, kept by measurement
// (scripts/corr_tile_bench.py bwd_bf16, variants split_c and red_sums):
// at C=256 coef (64 x (2r+2)^2 floats), F1, the two stages, the G planes
// and O take 217 KB at r=4 with three planes: one block an SM, whose df1
// and a chunk's df2 are 64 floats a thread each. Two blocks an SM at C=256
// need half the registers and at most 113 KB each, which blocks over 128
// channels each (kMaxBlockC 128: 103 KB) have; they were slower: each
// repeats the tile's set-up, fold and G, and adds its sums by atomics. At
// C=128 a block takes 103 KB (r=4) and two share an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "corr_tile.cuh"

namespace corr_tile_bf16 {

using namespace corr_tile;
using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;          // box pixels per chunk
constexpr int kLdG = kChunk + 8;    // row stride of a G plane (bf16 elements)
static_assert(kChunk == kQ, "G is square: queries x pixels of a chunk");

// The row stride of F1 and of a chunk stage, in bfloat16 elements: 16 bytes
// past C, so that the eight rows of an ldmatrix 8 x 8 block fall in eight
// 16-byte bank groups.
template <int C>
__host__ __device__ constexpr int ld_maps() {
  return C + 8;
}

// The channels one block covers: C up to kMaxBlockC, else kMaxBlockC, the
// other blocks of the (tile, level) taking the rest (block_c).
constexpr int kMaxBlockC = 256;
template <int C>
constexpr int block_c = C < kMaxBlockC ? C : kMaxBlockC;

// Whether the sums go out by TMA bulk reductions of rows staged in shared
// memory (O, kQ x ld_sums floats), or by the threads' own float4 atomics
// from their accumulators: bulk for a block over 256 channels (one block an
// SM either way, and the copy engine adds while the warps multiply),
// atomics over 128, where O would cost the second block an SM. CB is the
// block's channels.
template <int CB>
constexpr bool kBulkSums = CB == 256;

// The row stride of O in floats: 32 bytes past C, so that a warp's float2
// stores of an accumulator block take two wavefronts.
template <int C>
__host__ __device__ constexpr int ld_sums() {
  return C + 8;
}

// Dynamic shared memory: coef (floats), then F1, the two stages and the G
// planes (bfloat16), then O.
template <int R, int CB, int kPlanes>
__host__ __device__ constexpr int smem_bytes() {
  return kQ * (2 * R + 2) * (2 * R + 2) * 4 +
         (kQ * ld_maps<CB>() + 2 * kChunk * ld_maps<CB>() + kPlanes * kQ * kLdG) * 2 +
         (kBulkSums<CB> ? kQ * ld_sums<CB>() * 4 : 0);
}

// The fold's staged cotangents (kQ x (2r+1)^2 floats) lie over the second
// stage and the G planes, which the fold precedes.
static_assert(kQ * 81 * 4 <= (kChunk * ld_maps<128>() + kQ * kLdG) * 2,
              "the staged cotangents fit over a stage and one G plane");

// Four 8 x 8 bfloat16 blocks from shared memory, lane l giving the address of
// row l % 8 of block l / 8: fragment registers as mma_bf16 takes them.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(conv_phase::smem_addr(p)));
}

// The same, each block transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(conv_phase::smem_addr(p)));
}

// c as the bfloat16 parts the products take: one plane (rounded to nearest
// even) or three, hi + mid + lo, each the remainder's rounding.
template <int kPlanes>
__device__ __forceinline__ void split_coef(float c, bf16* parts) {
  parts[0] = __float2bfloat16_rn(c);
  if constexpr (kPlanes == 3) {
    const float r1 = c - __bfloat162float(parts[0]);
    parts[1] = __float2bfloat16_rn(r1);
    parts[2] = __float2bfloat16_rn(r1 - __bfloat162float(parts[1]));
  }
}

// 16 bytes (8 channels) of a map on their way into shared memory as
// bfloat16, zeros unless ok: a bfloat16 map's by cp.async straight to their
// place (fetch), a float32 map's loaded into registers by fetch, then
// rounded to nearest even and stored by land, so that the loads fly while
// other work runs.
template <typename M>
struct Piece;

template <>
struct Piece<bf16> {
  __device__ __forceinline__ void fetch(bf16* dst, const bf16* src, bool ok) {
    cp_async16(dst, src, ok);
  }
  __device__ __forceinline__ void land(bf16*) const {}
};

template <>
struct Piece<float> {
  float4 a, b;
  __device__ __forceinline__ void fetch(bf16*, const float* src, bool ok) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    a = ok ? __ldg(reinterpret_cast<const float4*>(src)) : zero;
    b = ok ? __ldg(reinterpret_cast<const float4*>(src) + 1) : zero;
  }
  __device__ __forceinline__ void land(bf16* dst) const {
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                                                pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }
};

// A thread's pieces of a staged block of kQ rows of C channels: rows
// first_row() + kRowStep * i, i < kCopies, at channel 8 * piece().
template <int C>
struct Rows {
  static constexpr int kPieces = C / 8;  // 16-byte pieces a row
  static constexpr int kRowStep = kThreads / kPieces;
  static constexpr int kCopies = kQ / kRowStep;
  static_assert(kThreads % kPieces == 0 && kQ % kRowStep == 0, "copies split evenly");
  __device__ __forceinline__ static int first_row() { return threadIdx.x / kPieces; }
  __device__ __forceinline__ static int piece() { return threadIdx.x % kPieces; }
};

// The row of an m16n8 accumulator block that lane adds by atomic_quad:
// row g for an even lane, g + 8 for an odd one.
__device__ __forceinline__ int quad_row() {
  const int lane = threadIdx.x & 31;
  return (lane >> 2) + 8 * (lane & 1);
}

// One accumulator block's sums (m16n8 layout: (g, 2t..2t+1) and
// (g + 8, 2t..2t+1)) added to a float32 matrix at columns col0 + 2t..:
// lanes t and t ^ 1 swap halves so that each adds one float4, an even lane
// to row g at columns col0 + 4(t / 2), an odd one to row g + 8. `row` is
// this lane's row (quad_row) in the matrix, or nullptr to add nothing; every
// lane of the warp must call it.
__device__ __forceinline__ void atomic_quad(const float* d, float* row, int col0) {
  const int lane = threadIdx.x & 31;
  const bool odd = lane & 1;
  const float r0 = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
  if (row != nullptr) {
    const float4 v = odd ? make_float4(r0, r1, d[2], d[3]) : make_float4(d[0], d[1], r0, r1);
    atomicAdd(reinterpret_cast<float4*>(row + col0 + 4 * ((lane & 3) >> 1)), v);
  }
}

// The block's tile blockIdx.x (load_tile's rule): the global index of its
// query slot 0, and that slot's row and column.
struct TileOrigin {
  long long first;
  int y, x;
};

__device__ __forceinline__ TileOrigin tile_origin(int H, int W) {
  const int tiles_x = (W + kTile - 1) / kTile;
  const int per_image = tiles_x * ((H + kTile - 1) / kTile);
  const int b = blockIdx.x / per_image;
  const int y = (blockIdx.x % per_image) / tiles_x * kTile;
  const int x = blockIdx.x % tiles_x * kTile;
  return {((long long)b * H + y) * W + x, y, x};
}

// Query slot qi's global index, -1 past the image.
__device__ __forceinline__ long long tile_query(const TileOrigin& o, int qi, int H, int W) {
  const int dy = qi / kTile, dx = qi % kTile;
  return o.y + dy < H && o.x + dx < W ? o.first + (long long)dy * W + dx : -1;
}

// The tile's cotangents at level l, staged in shared memory by 4-byte
// cp.async from the block index alone, before the tile's centres are
// loaded: loads into registers, one dependent chain a thread or an unrolled
// batch, held a block that is alone on its SM for microseconds. A query's
// row of (2r+1)^2 cotangents takes a slot of kSlot<R, G> words: float32
// rows as they are; bfloat16 rows from the 4-byte word that holds their
// first element (one element before it when that element is odd) to the
// word that holds their last, no byte past the row read.
template <int R, typename G>
constexpr int kSlot = sizeof(G) == 4 ? (2 * R + 1) * (2 * R + 1)
                                     : ((2 * R + 1) * (2 * R + 1) + 3) / 2;

// 4 bytes into shared memory, of which the first `bytes` come from src (the
// rest zero); src 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(conv_phase::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

template <int R, typename G>
__device__ __forceinline__ void stage_cotangents(const G* __restrict__ grad, int num_levels,
                                                 const TileOrigin& o, int l, int H, int W,
                                                 uint32_t* gs) {
  constexpr int WW = (2 * R + 1) * (2 * R + 1);
  constexpr int kSlotW = kSlot<R, G>;
  for (int idx = threadIdx.x; idx < kQ * kSlotW; idx += kThreads) {
    const int qi = idx / kSlotW, w = idx % kSlotW;
    const long long q = tile_query(o, qi, H, W);
    if (q < 0) continue;
    // the row's bytes [first, end) of grad
    const long long first = (q * num_levels * WW + l * WW) * (long long)sizeof(G);
    const long long end = first + WW * (long long)sizeof(G);
    const long long at = (first & ~3LL) + 4LL * w;
    if (at < end) {
      cp_async4(gs + idx, reinterpret_cast<const char*>(grad) + at, (int)min(4LL, end - at));
    }
  }
}

// Element k of query slot qi's staged row (the row starting at element
// `first` of grad), as a float.
template <int R>
__device__ __forceinline__ float staged(const uint32_t* gs, const float*, int qi, long long,
                                        int k) {
  return __uint_as_float(gs[qi * kSlot<R, float> + k]);
}

template <int R>
__device__ __forceinline__ float staged(const uint32_t* gs, const __nv_bfloat16*, int qi,
                                        long long first, int k) {
  const auto* row = reinterpret_cast<const __nv_bfloat16*>(gs + qi * kSlot<R, __nv_bfloat16>);
  return __bfloat162float(row[(first & 1) + k]);
}

// coef (kQ x D*D) as corr_tile.cuh's fold of the float32 form would in the
// TPU kernel's order (the cotangent scaled by inv_scale first, then the
// x-side adjoint, then the y side), from the staged cotangents gs of
// stage_cotangents: zero for a slot past the image or a centre that is not
// near. Ends in a barrier.
template <int R, typename G>
__device__ void fold(const TileQueries& t, const G* grad, int num_levels, int l,
                     float inv_scale, const uint32_t* gs, float* coef) {
  constexpr int D = 2 * R + 2;
  constexpr int WIN = 2 * R + 1;
  // a thread a row j of a query's neighbours, i = 0..D-1 along it
  for (int r = threadIdx.x; r < kQ * D; r += kThreads) {
    const int qi = r / D;
    const int j = r % D;  // y index of the neighbours
    float* c_row = coef + qi * D * D + j * D;
    if (t.q[qi] < 0 || !t.near[qi]) {
#pragma unroll
      for (int i = 0; i < D; ++i) c_row[i] = 0.f;
      continue;
    }
    const long long first = t.q[qi] * (num_levels * WIN * WIN) + l * WIN * WIN;
    // window (a, b)'s cotangent, scaled
    auto g = [&](int a, int b) {
      return __fmul_rn(staged<R>(gs, grad, qi, first, a * WIN + b), inv_scale);
    };
    const float dx = t.dx[qi], dy = t.dy[qi];
    // U_b at neighbour i's x: window i - 1 with weight dx, window i with
    // 1 - dx, for the window rows b = j - 1 and j; then g2 = U_{j-1} dy +
    // U_j (1 - dy). Each step's rounding is pinned (no contraction the
    // compiler might choose otherwise), so that the plain version
    // (_BilinearWindows in ops/corr_cuda.py) folds the same coefficients
    // bit for bit before both round them to bfloat16; a window past the
    // (2r+1)^2 reads as 0.
    float lo_prev = 0.f, hi_prev = 0.f;  // windows (i - 1, j - 1) and (i - 1, j)
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float lo = j > 0 && i < WIN ? g(i, j - 1) : 0.f;
      const float hi = j < WIN && i < WIN ? g(i, j) : 0.f;
      const float u_prev = __fmaf_rn(lo, 1.f - dx, __fmul_rn(lo_prev, dx));
      const float u_here = __fmaf_rn(hi, 1.f - dx, __fmul_rn(hi_prev, dx));
      const float c = __fmaf_rn(u_here, 1.f - dy, __fmul_rn(u_prev, dy));
      c_row[i] = c;
      lo_prev = lo;
      hi_prev = hi;
    }
  }
  __syncthreads();
}

// dst[0 .. bytes/4) += src[...] (float32), by the TMA unit: src in shared
// memory, both 16-byte aligned; one bulk group a commit.
__device__ __forceinline__ void bulk_add(float* dst, const float* src, int bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               ::"l"(dst), "r"(conv_phase::smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until this thread's bulk reductions have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A warp's accumulator blocks (2 x NT of m16n8, rows wm.., columns wn..)
// into O (row stride ldo floats).
template <int NT>
__device__ __forceinline__ void stage_sums(float (*acc)[NT][4], float* O, int ldo, int wm,
                                           int wn) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* p = O + (wm + 16 * mt + g) * ldo + wn + 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * ldo) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// The shared path at one level: df1 and df2 of the tile through the box.
// F1 and chunk 0 are staged (one cp.async group committed for bfloat16
// maps) before the fold; M is the maps' type, kPlanes the parts of G (1:
// mxu "bfloat16", 3: mxu "float32" on bfloat16 maps).
template <int R, int C, int CB, int kPlanes, typename M>
__device__ void shared_grads(const TileQueries& t, const M* __restrict__ f2,
                             float* __restrict__ d2, int w2, int nb, int bw, const float* coef,
                             float* __restrict__ df1, bf16* F1) {
  using Rw = Rows<CB>;
  constexpr int D = 2 * R + 2;
  constexpr int DD = D * D;
  constexpr int LD = ld_maps<CB>();
  constexpr int WN = CB / 4;         // a warp's channels: warps are 2 (rows) x 4 (channels)
  constexpr int NT = WN / 8;         // its n8 blocks
  bf16* F2 = F1 + kQ * LD;               // two stages of kChunk x LD
  bf16* G = F2 + 2 * kChunk * LD;        // kPlanes planes of kQ x kLdG
  float* O = reinterpret_cast<float*>(G + kPlanes * kQ * kLdG);  // sums on their way out
  constexpr int LDO = ld_sums<CB>();
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 32;   // the warp's rows: queries (df1) or pixels (df2)
  const int wn = (warp & 3) * WN;    // and channels
  // ldmatrix row addresses: A blocks (rows m, 8 columns k) and their
  // transposes, B blocks (rows k, 8 columns n) transposed
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int t_row = (lane & 7) + 8 * (lane >> 4), t_col = 8 * ((lane >> 3) & 1);
  const int b_row = a_row, b_col = a_col;
  // the pixels of a chunk whose G columns this thread builds, and its queries
  const int gp = 2 * (tid & 31);
  const int gq = tid >> 5;
  auto pixel = [&](int pix) {  // offset of box pixel pix in the level
    return ((long long)(t.box[1] + pix / bw) * w2 + t.box[0] + pix % bw) * C;
  };
  // this thread's pieces of a chunk stage: rows, and their place there
  const int row0 = Rw::first_row(), col = 8 * Rw::piece();
  float acc1[2][NT][4];  // df1 of the warp's 32 queries x WN channels
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[mt][nt][e] = 0.f;
  const int chunks = (nb + kChunk - 1) / kChunk;
  for (int n = 0; n < chunks; ++n) {
    const int n0 = n * kChunk;
    const bf16* S = F2 + (n & 1) * kChunk * LD;
    bf16* next = F2 + ((n + 1) & 1) * kChunk * LD;
    // the next chunk's copies fly while this one is built and multiplied
    Piece<M> pieces[Rw::kCopies];
    if (n + 1 < chunks) {
#pragma unroll
      for (int i = 0; i < Rw::kCopies; ++i) {
        const int row = row0 + Rw::kRowStep * i;
        const int pix = n0 + kChunk + row;
        const bool ok = pix < nb;
        pieces[i].fetch(next + row * LD + col, f2 + (ok ? pixel(pix) : 0) + col, ok);
      }
    }
    cp_async_commit();
    // G: the coefficient of query q at pixel p of the chunk, zero where p is
    // not one of q's neighbours or lies past the box
    {
      int px[2], py[2];
      bool in[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pix = n0 + gp + e;
        in[e] = pix < nb;
        px[e] = in[e] ? t.box[0] + pix % bw : INT_MIN / 2;
        py[e] = in[e] ? t.box[1] + pix / bw : INT_MIN / 2;
      }
#pragma unroll 2
      for (int k = 0; k < kQ / 8; ++k) {
        const int qi = gq + 8 * k;
        bf16 parts[2][3];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = px[e] - t.x0[qi];
          const int j = py[e] - t.y0[qi];
          const float c = ((unsigned)i < D && (unsigned)j < D) ? coef[qi * DD + j * D + i] : 0.f;
          split_coef<kPlanes>(c, parts[e]);
        }
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) {
          *reinterpret_cast<__nv_bfloat162*>(G + pl * kQ * kLdG + qi * kLdG + gp) =
              __halves2bfloat162(parts[0][pl], parts[1][pl]);
        }
      }
    }
    cp_async_wait<1>();
    __syncthreads();  // G and this chunk's stage (and F1) in place for every thread
    const int kmax = min(kChunk, nb - n0);  // pixels of the chunk in the box
    // df2 chunk (pixel, channel) = G^T (pixel, query) . F1 (query, channel)
    {
      float acc2[2][NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[mt][nt][e] = 0.f;
      if (wm < kmax) {  // warp-uniform: its 32 pixel rows are not all padding
        // one k step's fragments at a time: unrolled, the three-plane kernel
        // ran out of registers
#pragma unroll 1
        for (int k0 = 0; k0 < kQ; k0 += 16) {
          uint32_t b[NT][2];
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t r[4];
            ldsm_x4_t(r, F1 + (k0 + b_row) * LD + wn + 16 * np + b_col);
            b[2 * np][0] = r[0];
            b[2 * np][1] = r[1];
            b[2 * np + 1][0] = r[2];
            b[2 * np + 1][1] = r[3];
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int pl = kPlanes - 1; pl >= 0; --pl) {  // the smallest part first
              uint32_t a[4];
              ldsm_x4_t(a, G + pl * kQ * kLdG + (k0 + t_row) * kLdG + wm + 16 * mt + t_col);
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) mma_bf16(acc2[mt][nt], a, b[nt]);
            }
          }
        }
        if constexpr (kBulkSums<CB>) {
          // the warp's 32 x WN block of O: its lanes' last reductions have
          // read it; then each lane adds one pixel row of it
          bulk_wait_read();
          __syncwarp();
          stage_sums<NT>(acc2, O, LDO, wm, wn);
          conv_phase::fence_async_shared();
          __syncwarp();
          if (wm + lane < kmax) {
            bulk_add(d2 + pixel(n0 + wm + lane) + wn, O + (wm + lane) * LDO + wn, WN * 4);
          }
          bulk_commit();
        } else {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int pix = n0 + wm + 16 * mt + quad_row();
            float* row = pix < nb ? d2 + pixel(pix) : nullptr;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) atomic_quad(acc2[mt][nt], row, wn + 8 * nt);
          }
        }
      }
    }
    if (n + 1 < chunks) {  // a float32 map's next chunk, stored in bfloat16
#pragma unroll
      for (int i = 0; i < Rw::kCopies; ++i) {
        pieces[i].land(next + (row0 + Rw::kRowStep * i) * LD + col);
      }
    }
    // df1 (query, channel) += G (query, pixel) . chunk (pixel, channel); the
    // pixels past the box are zero in G and in the stage
    {
      float fresh[2][NT][4];  // mxu "float32": this chunk's sums, added in float32
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) fresh[mt][nt][e] = 0.f;
#pragma unroll 1
      for (int k0 = 0; k0 < kmax; k0 += 16) {
        uint32_t b[NT][2];
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldsm_x4_t(r, S + (k0 + b_row) * LD + wn + 16 * np + b_col);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int pl = kPlanes - 1; pl >= 0; --pl) {
            uint32_t a[4];
            ldsm_x4(a, G + pl * kQ * kLdG + (wm + 16 * mt + a_row) * kLdG + k0 + a_col);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              if constexpr (kPlanes == 3) {
                mma_bf16(fresh[mt][nt], a, b[nt]);
              } else {
                mma_bf16(acc1[mt][nt], a, b[nt]);
              }
            }
          }
        }
      }
      if constexpr (kPlanes == 3) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc1[mt][nt][e] += fresh[mt][nt][e];
      }
    }
    __syncthreads();  // G and this stage are rewritten by the next chunks
  }
  // df1 of the tile at this level, summed over the levels by the atomics
  if constexpr (kBulkSums<CB>) {  // as df2's, a query row a lane
    bulk_wait_read();
    __syncwarp();
    stage_sums<NT>(acc1, O, LDO, wm, wn);
    conv_phase::fence_async_shared();
    __syncwarp();
    const int qi = wm + lane;
    if (t.q[qi] >= 0 && t.near[qi]) bulk_add(df1 + t.q[qi] * C + wn, O + qi * LDO + wn, WN * 4);
    bulk_commit();
    bulk_wait_read();  // O is read before the block leaves
  } else {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int qi = wm + 16 * mt + quad_row();
      float* row = t.q[qi] >= 0 && t.near[qi] ? df1 + t.q[qi] * C : nullptr;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) atomic_quad(acc1[mt][nt], row, wn + 8 * nt);
    }
  }
}

// One block of the bf16 backward: corr_tile.cuh's tile, box, path and fold.
// The tile's F1 rows and cotangents are fetched from the block index before
// the tile's centres are loaded, and chunk 0 before the fold, so that each
// load's latency overlaps other work. A Form (corr_bwd_bf16.cu) supplies T
// (the maps' type), kPlanes, and the warp path's coef and load.
template <int R, int C, class Form>
__global__ void __launch_bounds__(kThreads, block_c<C> == 128 ? 2 : 1)
corr_bwd_bf16_kernel(const typename Form::T* __restrict__ fmap1, const Levels lv,
                     const int num_levels, const float* __restrict__ coords,
                     const void* __restrict__ grad, const int grad_bf16, float* __restrict__ df1,
                     const LevelGrads dlv, const int H, const int W, const int rescale,
                     const float inv_scale, const int budget, Count* __restrict__ path_counts) {
  using T = typename Form::T;
  constexpr int CB = block_c<C>;
  using Rw = Rows<CB>;
  constexpr int D = 2 * R + 2;
  constexpr int LD = ld_maps<CB>();
  extern __shared__ float4 smem4[];
  float* coef = reinterpret_cast<float*>(smem4);  // kQ x D*D
  bf16* F1 = reinterpret_cast<bf16*>(coef + kQ * D * D);
  bf16* S0 = F1 + kQ * LD;  // chunk 0's stage
  __shared__ TileQueries t;
  // blockIdx.y: the level, and which CB channels of it the block covers
  const int l = blockIdx.y / (C / CB);
  const int c0 = blockIdx.y % (C / CB) * CB;
  const int h2 = lv.h[l], w2 = lv.w[l];
  const int row0 = Rw::first_row(), col = 8 * Rw::piece();
  const TileOrigin origin = tile_origin(H, W);
  // the cotangents (one cp.async group), staged where chunk 1 and G go later
  uint32_t* gs = reinterpret_cast<uint32_t*>(S0 + kChunk * LD);
  if (grad_bf16) {
    stage_cotangents<R>(static_cast<const __nv_bfloat16*>(grad), num_levels, origin, l, H, W,
                        gs);
  } else {
    stage_cotangents<R>(static_cast<const float*>(grad), num_levels, origin, l, H, W, gs);
  }
  cp_async_commit();
  Piece<T> pieces[Rw::kCopies];
#pragma unroll
  for (int i = 0; i < Rw::kCopies; ++i) {
    const int row = row0 + Rw::kRowStep * i;
    const long long q = tile_query(origin, row, H, W);
    pieces[i].fetch(F1 + row * LD + col, fmap1 + (q >= 0 ? q * C : 0) + c0 + col, q >= 0);
  }
  if (rescale) {
    load_tile<R, true>(t, coords, H, W, l, h2, w2);
  } else {
    load_tile<R, false>(t, coords, H, W, l, h2, w2);
  }
  int bw;
  const int nb = box_pixels(t, bw);
  const long long base = (long long)t.b * h2 * w2 * C;
  const T* f2 = reinterpret_cast<const T*>(lv.ptr[l]) + base;
  float* d2 = dlv.ptr[l] + base;
  // a (tile, level) counts once, in the block over its first channels
  const bool shared = nb <= budget;
  if (c0 == 0 && threadIdx.x == 0) atomicAdd(path_counts + (shared ? 0 : 1), 1ULL);
  if (!shared || nb == 0) {  // F1's copies land before the block leaves
    cp_async_commit();
    cp_async_wait<0>();
  }
  if (nb == 0) return;  // no query of the tile has a neighbour on this level
  if (shared) {
#pragma unroll
    for (int i = 0; i < Rw::kCopies; ++i) {
      const int row = row0 + Rw::kRowStep * i;
      pieces[i].land(F1 + row * LD + col);
      const bool ok = row < nb;
      const long long off =
          ok ? ((long long)(t.box[1] + row / bw) * w2 + t.box[0] + row % bw) * C : 0;
      pieces[i].fetch(S0 + row * LD + col, f2 + off + c0 + col, ok);
    }
    cp_async_commit();  // F1 and chunk 0
  }
  cp_async_wait<1>();  // the cotangents (F1 and chunk 0 may still fly)
  __syncthreads();
  if (grad_bf16) {
    fold<R>(t, static_cast<const __nv_bfloat16*>(grad), num_levels, l, inv_scale, gs, coef);
  } else {
    fold<R>(t, static_cast<const float*>(grad), num_levels, l, inv_scale, gs, coef);
  }
  if (!shared) {  // one block takes the whole C
    if (c0 == 0) {
      warp_grads<R, C / 128, float4, false, Form>(t, fmap1, f2, d2, h2, w2, C, coef, df1);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < Rw::kCopies; ++i) pieces[i].land(S0 + (row0 + Rw::kRowStep * i) * LD + col);
  shared_grads<R, C, CB, Form::kPlanes>(t, f2 + c0, d2 + c0, w2, nb, bw, coef, df1 + c0, F1);
}

template <int R, int C, class Form>
cudaError_t launch(const BwdArgs& a) {
  using T = typename Form::T;
  auto kernel = corr_bwd_bf16_kernel<R, C, Form>;
  constexpr int bytes = smem_bytes<R, block_c<C>, Form::kPlanes>();
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.grid.x, a.grid.y * (C / block_c<C>));
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.fmap1), a.lv, a.num_levels, a.coords, a.grad, a.grad_bf16, a.df1,
      a.dlv, a.H, a.W, a.rescale, a.inv_scale, a.budget, a.path_counts);
  return cudaGetLastError();
}

// C is 128 or 256 (RAFT-small's and RAFT-large's feature widths).
template <int R, class Form>
cudaError_t launch_width(const BwdArgs& a) {
  switch (a.channels) {
    case 128: return launch<R, 128, Form>(a);
    case 256: return launch<R, 256, Form>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace corr_tile_bf16
