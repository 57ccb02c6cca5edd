// The shared convolution tile and phase runner of the port's update-block
// kernels (sepconv_gru.cu, motion_fwd.cu, update_step.cu), NVIDIA Hopper
// (sm_90a): an implicit GEMM on the tensor cores in 3xTF32, which gives
// float32-grade products, with float32 accumulation. Each of the three also
// has a bf16 form (bfloat16 activations and weights, one bf16 product pass;
// "the bf16 form" below), for the mixed-precision policy, on a
// warp-specialised tile of its own (a producer warpgroup feeding two
// consumer warpgroups through an mbarrier ring, TMA for the weights).
//
// A convolution over NHWC float32 tensors is an implicit GEMM: M = pixels,
// N = output channels, K = taps x input channels. The A operand is read
// straight from up to three NHWC input *parts*, so the reference's
// concatenation [part0 | part1 | part2] never exists. A tap (dy, dx) is
// valid only where both row + dy and col + dx lie in the image (the convs'
// zero padding); rows are taken as (m / W) % H, so they never bleed across
// the images of a batch.
//
// Weights arrive packed by raft_tpu_torch/ops/conv_pack.py: rows tap-major
// (tap = (dy + ky/2) * kx + (dx + kx/2)), within a tap each part's channels
// followed by zero rows up to a multiple of KC; a 2-channel input (the
// flow, whose 8-byte pixels allow no 16-byte copy) packs taps x 2 channels
// densely instead, zero rows up to a multiple of KC; columns padded with
// zeros to a multiple of BN, and the bias likewise. The K x ldw matrix is
// stored transposed (ldw x K, K contiguous, as the B operand of an MMA
// wants it) and twice: its TF32 high part and the TF32 rounding of the
// remainder (hi, then lo), split once when the weights are packed.
//
// Arithmetic. A TF32 operand keeps 11 significant bits: one TF32 product
// pass would miss the port's float32 policy (the goldens hold RAFT to 2e-3
// px after 32 iterations, kernel against plain 1e-4). Each operand x is
// split as hi = tf32_rna(x) and lo = x - hi; a product is then
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (CUTLASS's "fast f32" order, the small
// terms first), each a TF32 tensor-core product with float32 accumulation;
// a_lo*b_lo (2^-22 relative) is dropped. The weights are split when they
// are packed, lo rounded to TF32 too. The activations are split in
// registers after the shared-memory load, in three integer and float
// operations (no cvt): their lo is passed unrounded and the tensor core
// keeps its top 11 bits, 2^-21 of x. The tensor cores round their sums
// toward zero, so a long chain of products into one accumulator drifts
// (5.9e-5 on the motion encoder's K = 2,304 at Sintel size, against the
// 1e-4 bar, when every product of a tile went into one accumulator): each
// stage's products go into fresh partial sums, which are added to the
// tile's sum with ordinary f32 adds (1e-6 then).
//
// Bound. Three TF32 passes per product: the tile's peak is 495 / 3 = 165
// TFLOP/s of f32-grade work (the f32 SIMT peak is 67), far above the
// update block's bytes (tens of MB against tens of GFLOP): every kernel on
// this tile is bound by tensor-core operations.
//
// Tile. A block is one warpgroup (128 threads) and computes a BM x BN = 64 x
// 64 output tile with wgmma m64n64k8 TF32 products: A (the activations) from
// registers, B (the weights' hi and lo) from shared memory. mma.sync
// m16n8k8, measured first on the same pipeline, was slower (the GRU cell at
// Sintel size 0.60 ms against 0.42 here, NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py's kernel timer). K advances in stages of BK = 32 (two KC =
// 16 chunks, each inside one tap and one part), through a kStages-deep ring
// in dynamic shared memory filled by cp.async: the A gather as 16-byte
// copies, zero-filled through src-size 0 where a tap falls in the padding, a
// channel is padding or the pixel lies past M (no branch around the copy);
// the flow's 8-byte pixels by 8-byte copies; the weights' hi and lo as
// 16-byte copies. Eight neighbouring threads copy the 128 bytes of one row
// (pixel or output channel) of a stage. Both tiles are in the MMA's K-major
// layout with the 128-byte swizzle, which keeps those copies and the A
// fragment loads free of bank conflicts (with the unswizzled layout, whose
// core matrices are 8 rows x 16 bytes, the GRU cell took 1.1 ms). Stage kt's
// 12 products run on the tensor cores while the block waits for stage kt + 1
// and issues the copies of stage kt + 3. The cp.async copies are
// generic-proxy writes: a proxy fence after each stage lands makes them
// visible to the tensor cores. The epilogue works in the accumulator's
// fragment layout: a thread holds pairs of neighbouring columns and stores
// them as float2 (bias + ReLU into a channel slice of a wider buffer, with
// an optional flow passthrough whose two channels land in one pair; the GRU
// gates; the GRU blend). An N = 2 convolution (the flow head's last) runs
// one warp per pixel in f32 SIMT instead of a 64-wide tile.
//
// A *program* is a list of phases, each of one or two convolutions whose
// tiles the blocks of one persistent cooperative grid share out; a
// grid-wide barrier separates two phases, so a whole chain of convolutions
// is one launch. The grid is sized by the occupancy calculator, given the
// dynamic shared memory, so that every block is co-resident; a launch the
// card refuses returns its error, and nothing falls back. Every activation
// (a buffer one phase writes and a later one reads may be stale in another
// SM's L1) is read through L2 only: cp.async.cg, __ldcg. The 8-byte cp.async
// of the flow caches in L1 (.ca), which is safe because the flow is an
// input of the launch, never written by it.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_phase {

constexpr int BM = 64;      // pixels per tile
constexpr int BN = 64;      // output channels per tile
constexpr int BK = 32;      // reduction depth of one pipeline stage
constexpr int KC = 16;      // a chunk of K that lies inside one tap and part
constexpr int kStages = 4;  // depth of the cp.async ring
constexpr int kThreads = 128;  // one warpgroup
constexpr int kWarps = kThreads / 32;
constexpr int kNt = BN / 8;    // a thread's accumulator: 8-column blocks
// Shared-memory tiles are in the MMA's canonical K-major layout with the
// 128-byte swizzle: a row's BK = 32 K entries are 128 bytes, 8 rows a
// 1024-byte atom (kSBO apart), and the row's 16-byte chunk c lies at
// position c ^ (row % 8), so that the 8 chunks of a row, and one chunk of
// 8 rows, each fill all 32 banks.
constexpr int kSBO = 1024;
// The loaders: 8 threads copy the 128 bytes of a stage of one pixel (A) or
// output channel (B), kRowStep rows at a time.
constexpr int kRowStep = kThreads / (BK / 4);
constexpr int kARows = BM / kRowStep, kBRows = BN / kRowStep;
constexpr int kRowDst = kRowStep / 8 * (kSBO / 4);  // shared floats kRowStep rows on
constexpr int kR = 3;       // the largest kernel radius (convf1's 7 x 7)
constexpr int kMaxParts = 3;
constexpr int kMaxConvs = 2;
constexpr int kMaxPhases = 9;
static_assert(BK == 2 * KC, "a stage is two chunks");
static_assert(kStages >= 3, "a stage in flight while the next is awaited");
static_assert(BK * 4 == 128, "a stage of a row is one 128-byte swizzle row");
static_assert(kRowStep % 8 == 0, "a loader's rows share their place in the swizzle");
static_assert(BM == 64 && kThreads == 128, "one m64 warpgroup MMA a tile");

enum Epilogue : int {
  kBiasRelu = 0,  // out[m, off + n] = relu(acc + b); with `flow`, channels
                  // N and N + 1 of the row get the flow, copied bit for bit
  kGates = 1,     // N = 2C: n < C -> out = sigmoid(acc + b)      (z)
                  //         n >= C -> out1 = sigmoid(acc + b) * h (r * h)
  kBlend = 2,     // N = C: out = (1 - z) * h + z * tanh(acc + b)
  kBiasWarp = 3,  // N = 2: out = acc + b, one warp per pixel
  kBias = 4,      // the bf16 tile's N = 2: out[m, n] = acc + b for n < N
};

// T is the activations' and the weights' type: float (3xTF32 products,
// the weights hi then lo) or __nv_bfloat16 (the bf16 form, one bf16 product
// pass; see conv_tile's bfloat16 overload). The bias is float either way
// (the bf16 form's holds bfloat16 values).
template <typename T>
struct ConvT {
  const T* in[kMaxParts];      // NHWC parts, each (M, cin[p]) contiguous
  int cin[kMaxParts];
  int nparts;
  int ky, kx;                  // odd kernel size, zero padding ky/2, kx/2
  const T* w;                  // hi then lo, each (ldw, packed_rows) row-major
                               // (bfloat16: one matrix); kBiasWarp: one
                               // (taps * cin, 2) matrix
  const float* bias;           // (ldw)
  int N, ldw;
  int epi;
  T* out;                      // (M, ld_out), written at channels off + n
  int ld_out, out_off;
  T* out1;                     // kGates: r * h, (M, N / 2)
  const T* h;                  // kGates, kBlend: the GRU state, (M, N / 2)
  const T* z;                  // kBlend: the update gate, (M, N)
  const T* flow;               // kBiasRelu: (M, 2) copied to N, N + 1, or null
};

template <typename T>
struct PhaseT {
  ConvT<T> conv[kMaxConvs];
  int nconv;
};

template <typename T>
struct ProgramT {
  PhaseT<T> phase[kMaxPhases];
  int nphases;
  int M, H, W;
};

using Conv = ConvT<float>;
using Phase = PhaseT<float>;
using Program = ProgramT<float>;
using bf16 = __nv_bfloat16;

struct __align__(1024) Smem {
  float A[kStages][BM * BK];     // pixels x K
  float B[kStages][2][BN * BK];  // channels x K, hi and lo
};

// Float offset of the 16-byte chunk (row, K entries 4 c .. 4 c + 3) in a
// swizzled tile.
__device__ __forceinline__ int chunk_at(int row, int c) {
  return (row >> 3) * (kSBO / 4) + (row & 7) * (BK) + ((c ^ (row & 7)) * 4);
}

// The bf16 form's ring: a stage is BKH = 64 bfloat16 K entries a row, the
// same 128 bytes as a float32 stage, so the swizzle and its producer's rows
// are the float32 tiles'.
constexpr int BKH = 64;
constexpr int kRowDstH = kRowStep / 8 * (kSBO / 2);  // bfloat16s kRowStep rows on
static_assert(BKH * 2 == 128, "a bfloat16 stage of a row is one 128-byte swizzle row");
static_assert(BKH == 4 * KC, "a bfloat16 stage is four chunks");

// Element offset of the 16-byte chunk (row, K entries 8 c .. 8 c + 7) in a
// swizzled bfloat16 tile.
__device__ __forceinline__ int chunk_at_h(int row, int c) {
  return (row >> 3) * (kSBO / 2) + (row & 7) * BKH + ((c ^ (row & 7)) * 8);
}

template <typename T>
struct SmemOf {
  using type = Smem;
};
// Dynamic shared memory of a block: the ring, + alignment slack.
template <typename T>
constexpr int smem_bytes() {
  return sizeof(typename SmemOf<T>::type) + 1024;
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename T>
__host__ __device__ inline bool two_channel(const ConvT<T>& c) {
  return c.nparts == 1 && c.cin[0] == 2;
}

// Rows of the packed weight matrix (of each of hi and lo).
template <typename T>
__host__ __device__ inline int packed_rows(const ConvT<T>& c) {
  const int taps = c.ky * c.kx;
  if (two_channel(c)) return round_up(2 * taps, KC);
  int per_tap = 0;
  for (int p = 0; p < c.nparts; ++p) per_tap += round_up(c.cin[p], KC);
  return taps * per_tap;
}

template <typename T>
__host__ __device__ inline int conv_tiles(const ConvT<T>& c, int M) {
  return c.epi == kBiasWarp ? 0 : ((M + BM - 1) / BM) * (c.ldw / BN);
}

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// An activation load, through L2 only: a buffer written in one phase of a
// launch is neither read-only for the launch nor coherent in L1.
template <typename T>
__device__ __forceinline__ T act(const T* p) {
  return __ldcg(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2 only; zero-filled when !valid (the
// source is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes, cached in L1: only for inputs that the launch never writes.
__device__ __forceinline__ void cp_async8_readonly(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// 4 bytes, cached in L1: only for inputs that the launch never writes.
__device__ __forceinline__ void cp_async4_readonly(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// hi = x rounded to TF32 (to nearest, ties away from zero: cvt.rna.tf32 in
// two integer operations), lo = x - hi exactly. The tensor core reads the
// top 11 bits of lo's significand, so x = hi + lo to 2^-21 relative.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A wgmma shared-memory matrix descriptor of a K-major tile with the
// 128-byte swizzle, its atoms 1024-byte aligned, starting at `p` (an atom's
// start plus the K offset in bytes; the leading offset is unused).
__device__ __forceinline__ uint64_t gmma_desc(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(kSBO >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ uint64_t gmma_desc(const bf16* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(kSBO >> 4) << 32 | (uint64_t)1 << 62;
}

// d (+)= a * b over one k8 step, a 64 x 64 x 8 TF32 product of the
// warpgroup on the tensor cores with f32 accumulation: A from registers
// (warp w's rows 16 w .. 16 w + 15 in the m16n8k8 fragment layout), B
// from shared memory; d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Orders this thread's ordinary shared-memory writes before the tensor
// cores' (async proxy) reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One BM x BN output tile of convolution `c`.
__device__ void conv_tile(const Conv& c, int M, int H, int W, int tile, Smem& sm) {
  const int tid = threadIdx.x;
  const int mtiles = (M + BM - 1) / BM;
  const int m0 = (tile % mtiles) * BM;
  const int n0 = (tile / mtiles) * BN;
  const int kx = c.kx, ky = c.ky, taps = kx * ky;
  const bool two = two_channel(c);
  const float* in0 = c.in[0];
  const float* in1 = c.in[1];
  const float* in2 = c.in[2];
  const int cin0 = c.cin[0], cin1 = c.cin[1], cin2 = c.cin[2];
  const int chunks0 = round_up(cin0, KC) / KC;
  const int chunks1 = c.nparts > 1 ? round_up(cin1, KC) / KC : 0;
  const int chunks2 = c.nparts > 2 ? round_up(cin2, KC) / KC : 0;
  const int per_tap = chunks0 + chunks1 + chunks2;
  const int krows = packed_rows(c);
  const int nchunks = krows / KC;
  const int ksteps = (krows + BK - 1) / BK;

  // The loaders: 16-byte column l_c of the stage (chunk l_c / 4), rows
  // l_r0 + kRowStep i (pixels of A, output channels of B), at shared float
  // offset dst + kRowDst i of a tile.
  const int l_c = tid & 7;
  const int l_r0 = tid >> 3;
  const int dst = chunk_at(l_r0, l_c);
  // this thread's first weight row (hi; lo lies lo_off further) and K entry
  const float* w_src = c.w + (long long)(n0 + l_r0) * krows + l_c * 4;
  const long long w_row = (long long)kRowStep * krows, lo_off = (long long)c.ldw * krows;
  const int a_half = l_c >> 2;
  const int a_f = (l_c & 3) * 4;  // first K entry of the float4 in its chunk
  // Each pixel row's valid tap offsets: bit dx + kR of a_ok when its column
  // + dx lies in the image, bit dy + kR + 8 when its row + dy does; none
  // past M.
  int a_m[kARows], a_ok[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    a_m[i] = m0 + l_r0 + kRowStep * i;
    const int x = a_m[i] % W, y = (a_m[i] / W) % H;
    int ok = 0;
#pragma unroll
    for (int d = -kR; d <= kR; ++d)
      ok |= (x + d >= 0 && x + d < W) << (d + kR) | (y + d >= 0 && y + d < H) << (d + kR + 8);
    a_ok[i] = a_m[i] < M ? ok : 0;
  }
  auto inside = [&](int i, int dy, int dx) {
    return (a_ok[i] >> (dx + kR)) & (a_ok[i] >> (dy + kR + 8)) & 1;
  };
  // This thread's next chunk q = (BK / KC) kt + a_half: its tap (ty, tx)
  // and its chunk w within the tap, walked forward without a division (the
  // stages are loaded in order).
  int w_ty = 0, w_tx = 0, w_c = a_half;
  while (w_c >= per_tap) {
    w_c -= per_tap;
    if (++w_tx == kx) w_tx = 0, ++w_ty;
  }
  auto load_stage = [&](int kt, int slot) {
    const int q = kt * (BK / KC) + a_half;  // this thread's chunk
    if (two) {  // K entries (tap, channel) = (k / 2, k % 2), 8-byte pixels
      const int t0 = (q * KC + a_f) / 2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tap = t0 + e;
        const int dy = tap / kx - ky / 2, dx = tap % kx - kx / 2;
#pragma unroll
        for (int i = 0; i < kARows; ++i) {
          const bool ok = tap < taps && inside(i, dy, dx);
          const float* src = ok ? in0 + 2LL * (a_m[i] + dy * W + dx) : in0;
          cp_async8_readonly(&sm.A[slot][dst + kRowDst * i + 2 * e], src, ok);
        }
      }
    } else {
      const float* base = in0;
      int cin = cin0, r = 0, dy = 0, dx = 0;
      bool ok = false;
      if (q < nchunks) {
        int w = w_c;
        if (w >= chunks0) {
          w -= chunks0;
          if (w >= chunks1) {
            w -= chunks1;
            base = in2;
            cin = cin2;
          } else {
            base = in1;
            cin = cin1;
          }
        }
        r = w * KC + a_f;
        dy = w_ty - ky / 2;
        dx = w_tx - kx / 2;
        // cin is a multiple of 4: a float4 is all real or all padding
        ok = r < cin;
        w_c += BK / KC;
        while (w_c >= per_tap) {
          w_c -= per_tap;
          if (++w_tx == kx) w_tx = 0, ++w_ty;
        }
      }
      const float* at = base + (long long)(dy * W + dx) * cin + r;
#pragma unroll
      for (int i = 0; i < kARows; ++i) {
        const bool v = ok && inside(i, dy, dx);
        const float* src = v ? at + (long long)a_m[i] * cin : base;
        cp_async16(&sm.A[slot][dst + kRowDst * i], src, v);
      }
    }
    const bool bv = kt * BK + l_c * 4 < krows;  // krows is a multiple of 4
    const float* w = bv ? w_src + kt * BK : c.w;
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      cp_async16(&sm.B[slot][0][dst + kRowDst * i], w + w_row * i, bv);
      cp_async16(&sm.B[slot][1][dst + kRowDst * i], w + w_row * i + lo_off, bv);
    }
  };

  // The tile's sum and the partial sum of a stage.
  float acc[kNt][4], part[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.f;

  // A fragments: warp w's thread (g, tq) holds rows r = 16 w + g and r + 8
  // at K entries tq and tq + 4 of each k8 step.
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wm = (tid >> 5) * 16;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ksteps) load_stage(s, s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  fence_async_shared();
  __syncthreads();  // stage 0 landed and is visible to the tensor cores
  // Stage kt's products run on the tensor cores while the block waits for
  // stage kt + 1 and issues the copies of stage kt + kStages - 1.
  for (int kt = 0; kt < ksteps; ++kt) {
    const int slot = kt % kStages;
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int s = 0; s < BK / 8; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 8 * s + tq + 4 * (q >> 1);
        const float v = sm.A[slot][chunk_at(wm + g + 8 * (q & 1), k >> 2) + (k & 3)];
        split_tf32(v, ah[s][q], al[s][q]);
      }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {  // k8 step s: 32 bytes into each row
      const int k = 8 * s;
      const uint64_t b_hi = gmma_desc(&sm.B[slot][0][k]);
      const uint64_t b_lo = gmma_desc(&sm.B[slot][1][k]);
      wgmma_tf32(&part[0][0], al[s], b_hi, s > 0);
      wgmma_tf32(&part[0][0], ah[s], b_lo, 1);
      wgmma_tf32(&part[0][0], ah[s], b_hi, 1);
    }
    wgmma_commit();
    if (kt + 1 < ksteps) {
      cp_async_wait<kStages - 3>();  // stage kt + 1 landed (this thread's part)
      fence_async_shared();
    }
    // the slot refilled here held stage kt - 1, multiplied and waited for
    const int next = kt + kStages - 1;
    if (next < ksteps) load_stage(next, next % kStages);
    cp_async_commit();
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    __syncthreads();  // stage kt + 1 visible; every thread done with stage kt
  }
  cp_async_wait<0>();
  __syncthreads();  // frees shared memory for the block's next tile
  // Epilogue: warp w's thread (g, tq) holds in acc[j] rows 16 w + g and
  // 16 w + g + 8, columns 8 j + 2 tq and 8 j + 2 tq + 1.
  const int N = c.N;
  const int half = N / 2;
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    const int n = n0 + j * 8 + 2 * tq;
    const float2 bias = __ldg(reinterpret_cast<const float2*>(c.bias + n));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + wm + g + 8 * e;
      if (m >= M) continue;
      const float v0 = acc[j][2 * e] + bias.x;
      const float v1 = acc[j][2 * e + 1] + bias.y;
      if (c.epi == kBiasRelu) {
        float* dst = c.out + (long long)m * c.ld_out + c.out_off + n;
        if (n + 1 < N) {
          *reinterpret_cast<float2*>(dst) = make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        } else {
          const float o[2] = {fmaxf(v0, 0.f), fmaxf(v1, 0.f)};
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            if (n + t < N)
              dst[t] = o[t];
            else if (c.flow != nullptr && n + t < N + 2)
              dst[t] = act(c.flow + 2LL * m + (n + t - N));
          }
        }
      } else if (c.epi == kGates) {
        if (n < half) {  // z half (the tile lies wholly in one half)
          *reinterpret_cast<float2*>(c.out + (long long)m * half + n) =
              make_float2(sigmoidf_(v0), sigmoidf_(v1));
        } else {  // r half: emit r * h
          const long long at = (long long)m * half + (n - half);
          const float2 hv = act(reinterpret_cast<const float2*>(c.h + at));
          *reinterpret_cast<float2*>(c.out1 + at) =
              make_float2(sigmoidf_(v0) * hv.x, sigmoidf_(v1) * hv.y);
        }
      } else {  // kBlend
        const long long at = (long long)m * N + n;
        const float2 hv = act(reinterpret_cast<const float2*>(c.h + at));
        const float2 zv = act(reinterpret_cast<const float2*>(c.z + at));
        *reinterpret_cast<float2*>(c.out + at) =
            make_float2((1.f - zv.x) * hv.x + zv.x * tanhf(v0),
                        (1.f - zv.y) * hv.y + zv.y * tanhf(v1));
      }
    }
  }
}

// An N = 2 convolution of a single part (cin a multiple of 4), one warp
// per pixel in f32 SIMT: each lane dots four channels at a time against the
// two weight columns, then the warp sums its lanes. Weights (taps * cin,
// 2), bias (2).
__device__ void conv_n2_pixels(const Conv& c, int M, int H, int W, int warp, int nwarps) {
  const int lane = threadIdx.x & 31;
  const int cin = c.cin[0];
  const int kx = c.kx, ky = c.ky, taps = kx * ky;
  for (int m = warp; m < M; m += nwarps) {
    const int x = m % W;
    const int y = (m / W) % H;
    float a0 = 0.f, a1 = 0.f;
    for (int tap = 0; tap < taps; ++tap) {
      const int dy = tap / kx - ky / 2;
      const int dx = tap % kx - kx / 2;
      if (y + dy < 0 || y + dy >= H || x + dx < 0 || x + dx >= W) continue;
      const float* src = c.in[0] + (long long)(m + dy * W + dx) * cin;
      const float* wr = c.w + 2LL * tap * cin;
      for (int ch = lane * 4; ch < cin; ch += 128) {
        const float4 v = act(reinterpret_cast<const float4*>(src + ch));
        const float4 w01 = __ldg(reinterpret_cast<const float4*>(wr + 2 * ch));
        const float4 w23 = __ldg(reinterpret_cast<const float4*>(wr + 2 * ch + 4));
        a0 = fmaf(v.x, w01.x, fmaf(v.y, w01.z, fmaf(v.z, w23.x, fmaf(v.w, w23.z, a0))));
        a1 = fmaf(v.x, w01.y, fmaf(v.y, w01.w, fmaf(v.z, w23.y, fmaf(v.w, w23.w, a1))));
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, s);
      a1 += __shfl_xor_sync(0xffffffffu, a1, s);
    }
    if (lane == 0) {
      c.out[2LL * m] = a0 + __ldg(c.bias);
      c.out[2LL * m + 1] = a1 + __ldg(c.bias + 1);
    }
  }
}


// ---- the bf16 form ----------------------------------------------------------
//
// bfloat16 activations and weights (the TPU kernels' compute dtype), f32
// accumulation, on a warp-specialised tile of its own. A block is three
// warpgroups, one block an SM: two consumers (warps 0-7) and a producer
// (warps 8-11). It computes 64 pixels of one image row (a row segment: x0
// .. x0 + 63, ceil(W / 64) segments a row, the columns past W masked) x
// block_n output channels, block_n the whole N of the conv up to 256 (a
// multiple of 64 dividing the packed columns ldw; the Python plan,
// ops/conv_tile.py, sets it for each conv). Consumer c takes columns c *
// block_n / 2 onward, one wgmma m64n{block_n / 2}k16 a k16 step (n128 for
// the N = 256 convs, n96 for convc2's 192, n64 for 128, n32 for convf2's
// 64). Both consumers read the same A stage, so each pixel's im2col column
// is gathered once per conv (a 64 x 64 tile gathers it once per 64 output
// channels: four times for the GRU's gates).
//
// The K loop is a ring of kStagesH stages in shared memory, each BKH = 64 K
// entries: A (64 pixels x 128 bytes) and B (block_n channels x 128 bytes),
// both K-major with the 128-byte swizzle. The producer fills it, signalling
// each stage on its "full" mbarrier:
//   - B, the weights (stored ldw x K, K contiguous), by one TMA 2-D tile
//     load a stage (box 64 K x block_n rows, zero fill past K);
//   - A, where every part's channels are a multiple of 64 (h, inp,
//     [motion | flow] and the scratch buffers), by one TMA 4-D tile load a
//     stage of the part seen as (C, W, H, B): a stage is then 64 channels
//     of one (tap, part), so it is the box (64 channels, 64 pixels, 1, 1)
//     at (c0, x0 + dx, y + dy, b), the tap's shift, and TMA's zero fill
//     outside the tensor is the convs' zero padding at the image edge (and
//     past W). One thread issues both loads with the stage's byte count;
//   - A otherwise (convc1's lookup of 324 channels, 648 bytes a pixel,
//     which TMA's 16-byte stride rule refuses; convf1's 2-channel flow), by
//     cp.async from the 128 producer threads (8 a pixel, zero-filled in the
//     padding and past W): 16-byte copies where the pixel stride allows,
//     two 8-byte ones for the lookup, 4-byte ones (4 taps a 16-byte chunk)
//     for the flow; the 8- and 4-byte copies cache in L1 and are taken only
//     by launch inputs. Each thread keeps kLag stages of copies in flight
//     and publishes the oldest (cp.async.wait_group, a proxy fence into the
//     async proxy, its arrival on the full barrier).
// The consumers wait on "full", issue the stage's four wgmma, commit, and
// keep one group in flight (wgmma.wait_group 1): the stage before is then
// multiplied and its warps free it on its "empty" mbarrier, on which the
// producer waits before it refills it. The K loop has no __syncthreads();
// the ring runs on across tiles and phases, so the producer loads a tile's
// first stages while the consumers run the epilogue of the one before. One
// accumulator a tile: the products of bfloat16 values are exact in f32.
//
// Why, measured on an H100 (scripts/conv_tile_bench.py bf16 and its trace
// variant; PERF.md): a stage of the GRU's gates (40 KB of copies, 2.1
// MFLOP of products) takes about 1,000 cycles, paced by the copies from L2
// more than by the products. With A gathered by cp.async for every conv,
// the producer took longer to issue and land a stage than the consumers
// took to multiply it (and with cp.async.mbarrier.arrive.noinc signalling
// the copies, it issued a stage only once the one before had landed);
// 128-pixel blocks with their consumers splitting the pixels, and clusters
// of two blocks sharing each stage's weights by TMA multicast, were both
// slower than this tile.
//
// Rounding, as the JAX kernels' (step_pallas.py, gru_pallas.py, flax Conv
// at dtype bfloat16): each conv's f32 sum is rounded to bfloat16 and the
// bfloat16 bias added in bfloat16, v = bf16(bf16(acc) + b); then
//   kBiasRelu: relu(v);
//   kGates: z = bf16(sigmoid(v)); r * h as bf16(bf16(sigmoid(v)) * h);
//   kBlend: q = bf16(tanh(v)), h' = bf16(bf16(bf16(1 - z) * h) + bf16(z * q));
//   kBias (the flow head's N = 2 conv, on the tile like the others, its
//     columns padded to 64): v, f32 sums of the exact products of bfloat16
//     values rounded once.
// Each value is computed in f32 registers and rounded where the JAX kernel
// rounds.

__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float2 bf2_at(const bf16* p) {
  return __bfloat1622float2(act(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ void put_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

constexpr int kConsumers = 2;                  // consumer warpgroups a block
constexpr int kProducer = 128 * kConsumers;    // the producer's first thread
constexpr int kThreadsH = kProducer + 128;
constexpr int kStagesH = 4;                    // depth of the ring
constexpr int kMaxBlockN = 256;                // a block's output channels
// full: a producer warp's arrival each (once its copies have landed), + the
// expect_tx of the stage's TMA loads
constexpr int kProducerWarps = 4;
constexpr int kFullCount = kProducerWarps + 1;
// Stages of cp.async copies a producer thread keeps in flight before it
// publishes the oldest (kLag < kStagesH - 1, or the ring deadlocks: the
// consumers free a stage only once they hold the next).
constexpr int kLag = 2;
static_assert(kLag < kStagesH - 1, "a published stage for the consumers while the producer waits");
constexpr int kEmptyCount = 4 * kConsumers;    // a warp of each consumer
static_assert(kMaxBlockN / kConsumers <= 128, "a consumer's wgmma is at most n128");

// The Python plan of one conv (ops/conv_tile.py): its block's output
// channels, whether A comes by TMA, and each part's cp.async width.
struct ConvPlan {
  int block_n;
  int a_tma;
  int copy[kMaxParts];
};
constexpr int kPlanInts = 2 + kMaxParts;  // ints a conv slot in the plan array

// A consumer's staged sums, bfloat16 pairs: 64 rows of up to 64 pairs, + 4
// words of padding a row, so that a fragment store's 8 rows x 4 pairs fall
// in 32 banks.
constexpr int kEpiLd = kMaxBlockN / kConsumers / 2 + 4;

struct __align__(1024) SmemH {
  bf16 A[kStagesH][BM * BKH];          // pixels x K
  bf16 B[kStagesH][kMaxBlockN * BKH];  // channels x K
  uint64_t full[kStagesH];
  uint64_t empty[kStagesH];
  uint32_t epi[kConsumers][BM * kEpiLd];
};
// Dynamic shared memory of a bf16 block: the ring, + alignment slack.
constexpr int kSmemBytesH = sizeof(SmemH) + 1024;

// The bf16 program: the phases, each conv's plan, its weights' TMA
// descriptor and (a_tma) each part's, passed as a __grid_constant__
// parameter; the row segments' geometry.
struct ProgramH {
  CUtensorMap wmap[kMaxPhases][kMaxConvs];
  CUtensorMap amap[kMaxPhases][kMaxConvs][kMaxParts];
  PhaseT<bf16> phase[kMaxPhases];
  ConvPlan plan[kMaxPhases][kMaxConvs];
  int nphases;
  int M, H, W;
  int xtiles;  // row segments a row, ceil(W / BM)
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Waits until the barrier's round of this parity has completed. A round
// that does not complete within 2^32 cycles (about 2 s; a fault in the
// ring's accounting) traps the kernel, a launch error, rather than hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (uint32_t tries = 1;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((tries & 255) == 0) {
      if (t0 == 0) t0 = clock64();
      else if (clock64() - t0 > (1LL << 32)) __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_n(uint64_t* bar, uint32_t count) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(count)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// A TMA 2-D tile load of `map` at (c0, c1) (innermost first) into `dst`,
// completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// A TMA 4-D tile load of `map` at (c0, c1, c2, c3) (innermost first, signed:
// outside the tensor reads zeros) into `dst`, completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= a * b over one k16 step, a 64 x NC x 16 bfloat16 product of the
// warpgroup on the tensor cores with f32 accumulation, both operands K-major
// from shared memory; d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_bf16_n32(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_n64(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_n96(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int NC>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b, int accumulate) {
  if constexpr (NC == 128) wgmma_bf16_n128(d, a, b, accumulate);
  else if constexpr (NC == 96) wgmma_bf16_n96(d, a, b, accumulate);
  else if constexpr (NC == 64) wgmma_bf16_n64(d, a, b, accumulate);
  else wgmma_bf16_n32(d, a, b, accumulate);
}

// A ring position: the stage and the parity of its current round.
struct Ring {
  int stage = 0;
  uint32_t parity = 0;
  __device__ void advance() {
    if (++stage == kStagesH) stage = 0, parity ^= 1;
  }
};

// The producer's positions: where it issues the next stage, where it next
// publishes one (kLag behind), and the stages issued but not published.
struct ProducerRing {
  Ring issue, publish;
  int pending = 0;
};

// Publish the oldest issued stage: this thread's copies of it have landed
// (cp.async.wait_group), the proxy fence makes them visible to the tensor
// cores, then, once the warp's lanes are there, its warp's arrival on the
// stage's full barrier.
__device__ __forceinline__ void publish(SmemH& sm, ProducerRing& pr) {
  fence_async_shared();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&sm.full[pr.publish.stage]);
  pr.publish.advance();
  --pr.pending;
}

// At the end of a phase, and before a tile whose A comes by TMA: publish
// every stage still pending.
__device__ __forceinline__ void drain(SmemH& sm, ProducerRing& pr) {
  cp_async_wait<0>();
  while (pr.pending > 0) publish(sm, pr);
}

// Blocks' tiles of conv `c` over the program's row segments: (segments) x
// (N tiles).
__host__ __device__ inline int tiles_h(const ConvT<bf16>& c, const ConvPlan& pl, int M, int W,
                                       int xtiles) {
  return (M / W) * xtiles * (c.ldw / pl.block_n);
}

// A tile's place: image row `row` (b * H + y), its first column x0, and its
// first output channel n0.
struct TilePos {
  int row, x0, n0;
};

__device__ __forceinline__ TilePos tile_pos(int tile, int block_n, int M, int W, int xtiles) {
  const int segs = (M / W) * xtiles;
  const int t = tile % segs;
  return TilePos{t / xtiles, (t % xtiles) * BM, (tile / segs) * block_n};
}

// The producer's part of tile `tile` of conv `c`: for each stage, wait
// until it is free, then load B, and A where the plan says so, by TMA onto
// its full barrier, or A by cp.async, publishing the stage issued kLag
// stages before.
__device__ void produce_tile(const ConvT<bf16>& c, const ConvPlan& pl, const CUtensorMap* wmap,
                             const CUtensorMap* amap, int M, int H, int W, int xtiles, int tile,
                             SmemH& sm, ProducerRing& pr) {
  const int tid = threadIdx.x - kProducer;
  const TilePos at = tile_pos(tile, pl.block_n, M, W, xtiles);
  const int kx = c.kx, ky = c.ky, taps = kx * ky;
  const bf16* in0 = c.in[0];
  const bf16* in1 = c.in[1];
  const bf16* in2 = c.in[2];
  const int cin0 = c.cin[0], cin1 = c.cin[1], cin2 = c.cin[2];
  const int chunks0 = round_up(cin0, KC) / KC;
  const int chunks1 = c.nparts > 1 ? round_up(cin1, KC) / KC : 0;
  const int chunks2 = c.nparts > 2 ? round_up(cin2, KC) / KC : 0;
  const int per_tap = chunks0 + chunks1 + chunks2;
  const int krows = packed_rows(c);
  const int nchunks = krows / KC;
  const int ksteps = (krows + BKH - 1) / BKH;
  const uint32_t b_bytes = pl.block_n * BKH * 2;
  const int y = at.row % H, b = at.row / H;

  if (pl.a_tma) {
    // A stage ks is chunks 4 ks .. 4 ks + 3 of one (tap, part); one thread
    // issues the stage's two loads and stands for the four warps' arrivals
    if (pr.pending > 0) drain(sm, pr);
    if (tid == 0) {
      for (int kt = 0; kt < ksteps; ++kt) {
        const int slot = pr.issue.stage;
        mbar_wait(&sm.empty[slot], pr.issue.parity ^ 1);
        const int ks = kt;  // the stage's place in K
        const int tap = ks * (BKH / KC) / per_tap;
        int w = ks * (BKH / KC) - tap * per_tap, p = 0;
        if (w >= chunks0) {
          w -= chunks0;
          p = 1;
          if (w >= chunks1) w -= chunks1, p = 2;
        }
        mbar_arrive_expect_tx(&sm.full[slot], b_bytes + BM * BKH * 2);
        tma_load_2d(sm.B[slot], wmap, ks * BKH, at.n0, &sm.full[slot]);
        tma_load_4d(sm.A[slot], amap + p, w * KC, at.x0 + tap % kx - kx / 2,
                    y + tap / kx - ky / 2, b, &sm.full[slot]);
        mbar_arrive_n(&sm.full[slot], kProducerWarps);
        pr.issue.advance();
        pr.publish.advance();
      }
    } else {
      for (int kt = 0; kt < ksteps; ++kt) pr.issue.advance(), pr.publish.advance();
    }
    return;
  }

  // 16-byte column l_c of the stage (chunk l_c / 2, its K entries a_f ..
  // a_f + 7), pixels x0 + l_r0 + kRowStep i of the row.
  const int l_c = tid & 7;
  const int l_r0 = tid >> 3;
  const int dst = chunk_at_h(l_r0, l_c);
  const int a_q = l_c >> 1;
  const int a_f = (l_c & 1) * 8;
  // Each pixel's valid tap offsets: bit dx + kR of a_ok when its column +
  // dx lies in the image, bit dy + kR + 8 when its row + dy does; none past
  // the row's end.
  int a_m[kARows], a_ok[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int x = at.x0 + l_r0 + kRowStep * i;
    a_m[i] = at.row * W + x;
    int ok = 0;
#pragma unroll
    for (int d = -kR; d <= kR; ++d)
      ok |= (x + d >= 0 && x + d < W) << (d + kR) | (y + d >= 0 && y + d < H) << (d + kR + 8);
    a_ok[i] = x < W ? ok : 0;
  }
  auto inside = [&](int i, int dy, int dx) {
    return (a_ok[i] >> (dx + kR)) & (a_ok[i] >> (dy + kR + 8)) & 1;
  };
  // This thread's next chunk q = (BKH / KC) kt + a_q: its tap (ty, tx) and
  // its chunk w within the tap, walked forward without a division.
  int w_ty = 0, w_tx = 0, w_c = a_q;
  while (w_c >= per_tap) {
    w_c -= per_tap;
    if (++w_tx == kx) w_tx = 0, ++w_ty;
  }
  for (int kt = 0; kt < ksteps; ++kt) {
    const int slot = pr.issue.stage;
    mbar_wait(&sm.empty[slot], pr.issue.parity ^ 1);
    if (tid == 0) {
      mbar_arrive_expect_tx(&sm.full[slot], b_bytes);
      tma_load_2d(sm.B[slot], wmap, kt * BKH, at.n0, &sm.full[slot]);
    }
    const int q = kt * (BKH / KC) + a_q;  // this thread's chunk
    if (pl.copy[0] == 4) {  // the flow: K entries (tap, channel) = (k / 2, k % 2)
      const int t0 = (q * KC + a_f) / 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tap = t0 + e;
        const int dy = tap / kx - ky / 2, dx = tap % kx - kx / 2;
#pragma unroll
        for (int i = 0; i < kARows; ++i) {
          const bool ok = tap < taps && inside(i, dy, dx);
          const bf16* src = ok ? in0 + 2LL * (a_m[i] + dy * W + dx) : in0;
          cp_async4_readonly(&sm.A[slot][dst + kRowDstH * i + 2 * e], src, ok);
        }
      }
    } else {
      const bf16* base = in0;
      int cin = cin0, r = 0, dy = 0, dx = 0, width = pl.copy[0];
      bool ok = false;
      if (q < nchunks) {
        int w = w_c;
        if (w >= chunks0) {
          w -= chunks0;
          if (w >= chunks1) {
            w -= chunks1;
            base = in2;
            cin = cin2;
            width = pl.copy[2];
          } else {
            base = in1;
            cin = cin1;
            width = pl.copy[1];
          }
        }
        r = w * KC + a_f;
        dy = w_ty - ky / 2;
        dx = w_tx - kx / 2;
        ok = r < cin;
        w_c += BKH / KC;
        while (w_c >= per_tap) {
          w_c -= per_tap;
          if (++w_tx == kx) w_tx = 0, ++w_ty;
        }
      }
      // cin is a multiple of 4: a half copy is all real or all padding
      const bool ok_hi = r + 4 < cin;
      const bf16* src0 = base + (long long)(dy * W + dx) * cin + r;
#pragma unroll
      for (int i = 0; i < kARows; ++i) {
        const bool v = ok && inside(i, dy, dx);
        const bf16* src = v ? src0 + (long long)a_m[i] * cin : base;
        bf16* d = &sm.A[slot][dst + kRowDstH * i];
        if (width == 8) {
          cp_async8_readonly(d, src, v);
          cp_async8_readonly(d + 4, v && ok_hi ? src + 4 : base, v && ok_hi);
        } else {
          cp_async16(d, src, v);
        }
      }
    }
    cp_async_commit();
    pr.issue.advance();
    if (++pr.pending > kLag) {
      cp_async_wait<kLag>();
      publish(sm, pr);
    }
  }
}

// Bars the consumer warpgroup `cons` (named barrier 1 + cons, its 128
// threads).
__device__ __forceinline__ void consumer_sync(int cons) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cons) : "memory");
}

// The epilogue of a consumer's columns n0 .. n0 + NC - 1 of the tile at
// `at`, one instance for each epilogue EPI. The consumer first stages its
// sums, each rounded to bfloat16, in shared memory (`st`), from the
// accumulators' fragment layout (acc[4 j + 2 e + t]: row 16 w + g + 8 e,
// column 8 j + 2 tq + t); then its threads walk the tile's (row, column
// pair)s in order, a pair each, so that a warp's loads of h and z and its
// stores take whole rows of 128 bytes, in a loop unrolled only twice: each
// phase runs its epilogue once a tile, with its code fetched cold, and an
// epilogue unrolled over every output in the accumulators' layout took
// 13,000-24,000 cycles a tile (scripts/conv_tile_bench.py bf16: variant
// trace; epi_unroll1 and epi_unroll4 time the loop's unrolling).
template <int NC, int EPI>
__device__ __forceinline__ void epilogue(const ConvT<bf16>& c, const float* acc, uint32_t* st,
                                         TilePos at, int n0, int W, int cons, int ctid) {
  constexpr int kPairs = NC / 2;
  const int g = (ctid & 31) >> 2;
  const int tq = ctid & 3;
  const int wm = (ctid >> 5) * 16;
  consumer_sync(cons);  // the last tile's epilogue has read the stage
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
      st[(wm + g + 8 * e) * kEpiLd + 4 * j + tq] = *reinterpret_cast<const uint32_t*>(&v);
    }
  consumer_sync(cons);
  const int N = c.N;
  const int half = N / 2;
  // a thread's column pair is the same on every row when kPairs divides 128
  constexpr bool kFixedPair = 128 % kPairs == 0;
  const float2 bias0 = __ldg(reinterpret_cast<const float2*>(c.bias + n0 + 2 * (ctid % kPairs)));
#pragma unroll 2
  for (int idx = ctid; idx < BM * kPairs; idx += 128) {
    const int r = idx / kPairs;
    const int cp = idx - r * kPairs;
    const int x = at.x0 + r;
    if (x >= W) continue;
    const long long m = (long long)at.row * W + x;
    const int n = n0 + 2 * cp;
    const uint32_t word = st[r * kEpiLd + cp];
    const float2 sum = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&word));
    const float2 bias =
        kFixedPair ? bias0 : __ldg(reinterpret_cast<const float2*>(c.bias + n));
    const float v0 = rbf(sum.x + bias.x);
    const float v1 = rbf(sum.y + bias.y);
    if (EPI == kBiasRelu) {
      bf16* dst_p = c.out + m * c.ld_out + c.out_off + n;
      if (n + 1 < N) {
        put_bf2(dst_p, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      } else {
        const float o[2] = {fmaxf(v0, 0.f), fmaxf(v1, 0.f)};
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (n + t < N)
            dst_p[t] = __float2bfloat16_rn(o[t]);
          else if (c.flow != nullptr && n + t < N + 2)
            dst_p[t] = act(c.flow + 2 * m + (n + t - N));
        }
      }
    } else if (EPI == kBias) {
      if (n + 1 < N) {
        put_bf2(c.out + m * c.ld_out + n, v0, v1);
      } else if (n < N) {
        c.out[m * c.ld_out + n] = __float2bfloat16_rn(v0);
      }
    } else if (EPI == kGates) {
      if (n < half) {  // z
        put_bf2(c.out + m * half + n, sigmoidf_(v0), sigmoidf_(v1));
      } else {  // r: emit r * h
        const long long at_h = m * half + (n - half);
        const float2 hv = bf2_at(c.h + at_h);
        put_bf2(c.out1 + at_h, rbf(sigmoidf_(v0)) * hv.x, rbf(sigmoidf_(v1)) * hv.y);
      }
    } else {  // kBlend
      const long long at_h = m * N + n;
      const float2 hv = bf2_at(c.h + at_h);
      const float2 zv = bf2_at(c.z + at_h);
      const float q0 = rbf(tanhf(v0)), q1 = rbf(tanhf(v1));
      put_bf2(c.out + at_h, rbf(rbf(1.f - zv.x) * hv.x) + rbf(zv.x * q0),
              rbf(rbf(1.f - zv.y) * hv.y) + rbf(zv.y * q1));
    }
  }
}

// A consumer's part of tile `tile` of conv `c`: the 64 x NC products of its
// columns over every stage, then the epilogue. Consumer warp w's thread
// (g, tq) holds in acc[4 j + 2 e + t] the row segment's pixel 16 w + g + 8
// e, column 8 j + 2 tq + t of the consumer's columns.
template <int NC>
__device__ void consume_tile(const ConvT<bf16>& c, int block_n, int M, int W, int xtiles,
                             int tile, SmemH& sm, Ring& ring) {
  const int cons = threadIdx.x >> 7;
  const int ctid = threadIdx.x & 127;
  const TilePos at = tile_pos(tile, block_n, M, W, xtiles);
  const int n0 = at.n0 + cons * NC;
  const int ksteps = (packed_rows(c) + BKH - 1) / BKH;
  const int lane = ctid & 31;
  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  int prev = -1;
  for (int kt = 0; kt < ksteps; ++kt) {
    const int slot = ring.stage;
    mbar_wait(&sm.full[slot], ring.parity);
    wgmma_fence();
    const bf16* a = sm.A[slot];
    const bf16* b = sm.B[slot] + cons * NC * BKH;
#pragma unroll
    for (int s = 0; s < BKH / 16; ++s)  // k16 step s: 32 bytes into each row
      wgmma_bf16<NC>(acc, gmma_desc(a + 16 * s), gmma_desc(b + 16 * s), kt > 0 || s > 0);
    wgmma_commit();
    wgmma_wait_n<1>();  // the stage before is multiplied: free it
    if (prev >= 0 && lane == 0) mbar_arrive(&sm.empty[prev]);
    prev = slot;
    ring.advance();
  }
  wgmma_wait_n<0>();
  if (prev >= 0 && lane == 0) mbar_arrive(&sm.empty[prev]);

  uint32_t* st = sm.epi[cons];
  switch (c.epi) {
    case kBiasRelu: epilogue<NC, kBiasRelu>(c, acc, st, at, n0, W, cons, ctid); break;
    case kBias: epilogue<NC, kBias>(c, acc, st, at, n0, W, cons, ctid); break;
    case kGates: epilogue<NC, kGates>(c, acc, st, at, n0, W, cons, ctid); break;
    default: epilogue<NC, kBlend>(c, acc, st, at, n0, W, cons, ctid); break;
  }
}

// One phase: the blocks share out the tiles of every tiled convolution of
// the phase in order, then the pixels of an N = 2 convolution by warp.
template <typename T, typename S>
__device__ void run_phase(const PhaseT<T>& ph, int M, int H, int W, S& sm) {
  int total = 0;
  for (int i = 0; i < ph.nconv; ++i) total += conv_tiles(ph.conv[i], M);
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int local = t, i = 0;
    while (local >= conv_tiles(ph.conv[i], M)) local -= conv_tiles(ph.conv[i++], M);
    conv_tile(ph.conv[i], M, H, W, local, sm);
  }
  for (int i = 0; i < ph.nconv; ++i) {
    if (ph.conv[i].epi == kBiasWarp)
      conv_n2_pixels(ph.conv[i], M, H, W, blockIdx.x * kWarps + (threadIdx.x >> 5),
                     gridDim.x * kWarps);
  }
}

// The body of a program kernel. Launch it through launch_program only: the
// grid barrier needs a cooperative launch, and the ring smem_bytes<T>() of
// dynamic shared memory.
template <typename T>
__device__ __forceinline__ void run_program(const ProgramT<T>& p) {
  using S = typename SmemOf<T>::type;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment: launch_program gives
  // 1024 bytes of slack
  S& sm = *reinterpret_cast<S*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  for (int i = 0; i < p.nphases; ++i) {
    if (i > 0) cooperative_groups::this_grid().sync();
    run_phase(p.phase[i], p.M, p.H, p.W, sm);
  }
}

// The body of a bf16 program kernel (kThreadsH threads; launch it through
// launch_program only): the ring's barriers, then each phase's tiles, the
// producer warpgroup and the consumers walking the same tiles in the same
// order; a grid barrier between two phases.
__device__ __forceinline__ void run_program_h(const ProgramH& p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  SmemH& sm =
      *reinterpret_cast<SmemH*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesH; ++s) {
      mbar_init(&sm.full[s], kFullCount);
      mbar_init(&sm.empty[s], kEmptyCount);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const bool producer = threadIdx.x >= kProducer;
  ProducerRing pr;
  Ring ring;
  for (int i = 0; i < p.nphases; ++i) {
    if (i > 0) cooperative_groups::this_grid().sync();
    const PhaseT<bf16>& ph = p.phase[i];
    int total = 0;
    for (int j = 0; j < ph.nconv; ++j)
      total += tiles_h(ph.conv[j], p.plan[i][j], p.M, p.W, p.xtiles);
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int local = t, j = 0;
      while (local >= tiles_h(ph.conv[j], p.plan[i][j], p.M, p.W, p.xtiles))
        local -= tiles_h(ph.conv[j], p.plan[i][j], p.M, p.W, p.xtiles), ++j;
      const ConvT<bf16>& c = ph.conv[j];
      const ConvPlan& pl = p.plan[i][j];
      if (producer) {
        produce_tile(c, pl, &p.wmap[i][j], p.amap[i][j], p.M, p.H, p.W, p.xtiles, local, sm,
                     pr);
      } else {
        switch (pl.block_n / kConsumers) {
          case 128: consume_tile<128>(c, pl.block_n, p.M, p.W, p.xtiles, local, sm, ring); break;
          case 96: consume_tile<96>(c, pl.block_n, p.M, p.W, p.xtiles, local, sm, ring); break;
          case 64: consume_tile<64>(c, pl.block_n, p.M, p.W, p.xtiles, local, sm, ring); break;
          default: consume_tile<32>(c, pl.block_n, p.M, p.W, p.xtiles, local, sm, ring); break;
        }
      }
    }
    if (producer) drain(sm, pr);
  }
}

// ---- host side -------------------------------------------------------------

template <typename T>
inline ConvT<T> make_conv(int ky, int kx, const T* w, const float* bias, int N, int epi,
                          T* out, int ld_out, int out_off) {
  ConvT<T> c{};
  c.ky = ky;
  c.kx = kx;
  c.w = w;
  c.bias = bias;
  c.N = N;
  c.ldw = epi == kBiasWarp ? N : round_up(N, BN);
  c.epi = epi;
  c.out = out;
  c.ld_out = ld_out;
  c.out_off = out_off;
  return c;
}

template <typename T>
inline void add_part(ConvT<T>& c, const T* in, int cin) {
  c.in[c.nparts] = in;
  c.cin[c.nparts] = cin;
  ++c.nparts;
}

template <typename T>
inline void add_phase(ProgramT<T>& p, const ConvT<T>& a) {
  p.phase[p.nphases].conv[0] = a;
  p.phase[p.nphases].nconv = 1;
  ++p.nphases;
}

template <typename T>
inline void add_phase(ProgramT<T>& p, const ConvT<T>& a, const ConvT<T>& b) {
  p.phase[p.nphases].conv[0] = a;
  p.phase[p.nphases].conv[1] = b;
  p.phase[p.nphases].nconv = 2;
  ++p.nphases;
}

// Widths of RAFT-large's BasicMotionEncoder (convc1, convc2, convf1,
// convf2, conv); its output is [conv (126) | flow (2)].
constexpr int kC1 = 256, kC2 = 192, kF1 = 128, kF2 = 64, kCo = 126, kMotion = kCo + 2;
// Scratch floats per pixel of the motion phases: c1, f1, [cor | flo].
constexpr int kMotionScratch = kC1 + kF1 + kC2 + kF2;

template <typename T>
struct MotionWeightsT {
  const T* wc1;
  const float* bc1;
  const T* wc2;
  const float* bc2;
  const T* wf1;
  const float* bf1;
  const T* wf2;
  const float* bf2;
  const T* wo;
  const float* bo;
};
using MotionWeights = MotionWeightsT<float>;

// The three motion phases: convc1 | convf1, convc2 | convf2 (into one
// [cor | flo] buffer), then conv into `out` (M, 128) with the flow in
// channels 126-127. `scratch` holds kMotionScratch floats per pixel.
template <typename T>
inline void add_motion_phases(ProgramT<T>& p, const T* corr, int cc, const T* flow,
                              const MotionWeightsT<T>& mw, T* scratch, T* out) {
  const long long M = p.M;
  T* c1 = scratch;
  T* f1 = c1 + M * kC1;
  T* cf = f1 + M * kF1;
  ConvT<T> convc1 = make_conv(1, 1, mw.wc1, mw.bc1, kC1, kBiasRelu, c1, kC1, 0);
  add_part(convc1, corr, cc);
  ConvT<T> convf1 = make_conv(7, 7, mw.wf1, mw.bf1, kF1, kBiasRelu, f1, kF1, 0);
  add_part(convf1, flow, 2);
  add_phase(p, convc1, convf1);
  ConvT<T> convc2 = make_conv(3, 3, mw.wc2, mw.bc2, kC2, kBiasRelu, cf, kC2 + kF2, 0);
  add_part(convc2, c1, kC1);
  ConvT<T> convf2 = make_conv(3, 3, mw.wf2, mw.bf2, kF2, kBiasRelu, cf, kC2 + kF2, kC2);
  add_part(convf2, f1, kF1);
  add_phase(p, convc2, convf2);
  ConvT<T> conv = make_conv(3, 3, mw.wo, mw.bo, kCo, kBiasRelu, out, kMotion, 0);
  add_part(conv, cf, kC2 + kF2);
  conv.flow = flow;
  add_phase(p, conv);
}

template <typename T>
struct GruWeightsT {
  const T* w_zr1;
  const float* b_zr1;
  const T* w_q1;
  const float* b_q1;
  const T* w_zr2;
  const float* b_zr2;
  const T* w_q2;
  const float* b_q2;
};
using GruWeights = GruWeightsT<float>;

// The four GRU phases (gates, then candidate + blend, for the 1x5 half and
// then the 5x1 half) with x given as parts; z, rh and h1 are (M, C)
// scratch, `out` receives h'.
template <typename T>
inline void add_gru_phases(ProgramT<T>& p, const T* h, int C, const T* const* xs,
                           const int* cxs, int nx, const GruWeightsT<T>& gw, T* z, T* rh,
                           T* h1, T* out) {
  const T* w_zr[2] = {gw.w_zr1, gw.w_zr2};
  const float* b_zr[2] = {gw.b_zr1, gw.b_zr2};
  const T* w_q[2] = {gw.w_q1, gw.w_q2};
  const float* b_q[2] = {gw.b_q1, gw.b_q2};
  const T* state[2] = {h, h1};
  T* result[2] = {h1, out};
  for (int half = 0; half < 2; ++half) {
    const int ky = half ? 5 : 1, kx = half ? 1 : 5;
    ConvT<T> gates = make_conv(ky, kx, w_zr[half], b_zr[half], 2 * C, kGates, z, C, 0);
    gates.out1 = rh;
    gates.h = state[half];
    add_part(gates, state[half], C);
    ConvT<T> cand = make_conv(ky, kx, w_q[half], b_q[half], C, kBlend, result[half], C, 0);
    cand.h = state[half];
    cand.z = z;
    add_part(cand, rh, C);
    for (int i = 0; i < nx; ++i) {
      add_part(gates, xs[i], cxs[i]);
      add_part(cand, xs[i], cxs[i]);
    }
    add_phase(p, gates);
    add_phase(p, cand);
  }
}

// Launch `kernel` (a __global__ wrapper of run_program) over the whole
// card as a cooperative grid on `stream`, with smem_bytes<T>() of dynamic
// shared memory a block. Returns a cudaError_t: the card cannot run
// cooperative launches, the kernel fits no block on an SM, or the launch was
// refused.
template <typename Kernel, typename T>
inline cudaError_t launch_program(Kernel kernel, const ProgramT<T>& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T>();
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int work = 1;  // blocks the busiest phase can use
  for (int i = 0; i < p.nphases; ++i) {
    int blocks = 0;
    for (int j = 0; j < p.phase[i].nconv; ++j) {
      const ConvT<T>& c = p.phase[i].conv[j];
      if (c.ky / 2 > kR || c.kx / 2 > kR) return cudaErrorInvalidValue;
      blocks += c.epi == kBiasWarp ? (p.M + kWarps - 1) / kWarps : conv_tiles(c, p.M);
    }
    work = blocks > work ? blocks : work;
  }
  const int grid = per_sm * sms < work ? per_sm * sms : work;
  void* args[] = {const_cast<ProgramT<T>*>(&p)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The bf16 program of `p` with the plan `plan` (kPlanInts ints for each of
// the kMaxConvs conv slots of each phase: block_n, a_tma, then the copy
// width of each part, 0 in an empty slot or part; ops/conv_tile.py), a TMA
// descriptor of each tiled conv's weights (ldw x packed_rows bfloat16) and,
// where a_tma, of each part (seen as (C, W, H, B); box 64 channels x 64
// pixels), every tensor 16-byte aligned. The plan must be the one the
// kernel takes: block_n a multiple of 64 up to kMaxBlockN dividing ldw (the
// N = 2 conv is kBias, on the tile), a_tma 1 exactly when every part's channels are a
// multiple of 64, each part's width 16 where its channels are a multiple of
// 8, 8 where they are a multiple of 4, 4 for a 2-channel part. Returns
// cudaErrorInvalidValue otherwise.
inline cudaError_t make_program_h(const ProgramT<bf16>& p, const int* plan, int plan_len,
                                  ProgramH& out) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  if (plan == nullptr || plan_len != p.nphases * kMaxConvs * kPlanInts) return cudaErrorInvalidValue;
  out.nphases = p.nphases;
  out.M = p.M;
  out.H = p.H;
  out.W = p.W;
  out.xtiles = (p.W + BM - 1) / BM;
  const cuuint64_t batch = (cuuint64_t)p.M / ((cuuint64_t)p.H * p.W);
  for (int i = 0; i < p.nphases; ++i) {
    out.phase[i] = p.phase[i];
    for (int j = 0; j < kMaxConvs; ++j) {
      const int* q = plan + (i * kMaxConvs + j) * kPlanInts;
      ConvPlan& pl = out.plan[i][j];
      pl.block_n = q[0];
      pl.a_tma = q[1];
      for (int k = 0; k < kMaxParts; ++k) pl.copy[k] = q[2 + k];
      if (j >= p.phase[i].nconv) {
        for (int k = 0; k < kPlanInts; ++k)
          if (q[k] != 0) return cudaErrorInvalidValue;
        continue;
      }
      const ConvT<bf16>& c = p.phase[i].conv[j];
      for (int k = 0; k < kMaxParts; ++k) {
        const int cin = c.cin[k];
        const int want = k >= c.nparts ? 0 : cin == 2 && c.nparts == 1 ? 4 : cin % 8 == 0 ? 16 : 8;
        if (pl.copy[k] != want) return cudaErrorInvalidValue;
      }
      bool tma = !two_channel(c);
      for (int k = 0; k < c.nparts; ++k) tma = tma && c.cin[k] % 64 == 0;
      if (c.epi == kBiasWarp || pl.a_tma != (int)tma) return cudaErrorInvalidValue;
      if (pl.block_n <= 0 || pl.block_n % BN != 0 || pl.block_n > kMaxBlockN ||
          c.ldw % pl.block_n != 0) {
        return cudaErrorInvalidValue;
      }
      const cuuint64_t dims[2] = {(cuuint64_t)packed_rows(c), (cuuint64_t)c.ldw};
      const cuuint64_t strides[1] = {(cuuint64_t)packed_rows(c) * sizeof(bf16)};
      const cuuint32_t box[2] = {(cuuint32_t)BKH, (cuuint32_t)pl.block_n};
      const cuuint32_t steps[2] = {1, 1};
      const CUresult r = encode(&out.wmap[i][j], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                const_cast<bf16*>(c.w), dims, strides, box, steps,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
      for (int k = 0; tma && k < c.nparts; ++k) {
        const cuuint64_t cin = c.cin[k];
        const cuuint64_t adims[4] = {cin, (cuuint64_t)p.W, (cuuint64_t)p.H, batch};
        const cuuint64_t astrides[3] = {cin * sizeof(bf16), cin * p.W * sizeof(bf16),
                                        cin * p.W * p.H * sizeof(bf16)};
        const cuuint32_t abox[4] = {(cuuint32_t)BKH, (cuuint32_t)BM, 1, 1};
        const cuuint32_t asteps[4] = {1, 1, 1, 1};
        const CUresult ra = encode(&out.amap[i][j][k], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                   const_cast<bf16*>(c.in[k]), adims, astrides, abox, asteps,
                                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
        if (ra != CUDA_SUCCESS) return cudaErrorInvalidValue;
      }
    }
  }
  return cudaSuccess;
}

// Launch `kernel` (a __global__ wrapper of run_program_h with
// __launch_bounds__(kThreadsH, 1)) over the whole card as a cooperative grid
// on `stream`: the bf16 program of `p` and `plan` (make_program_h), with
// kSmemBytesH of dynamic shared memory a block and as many blocks as the
// occupancy calculator fits (one an SM) or the busiest phase can use.
// Returns a cudaError_t, as launch_program.
template <typename Kernel>
inline cudaError_t launch_program(Kernel kernel, const ProgramT<bf16>& p, const int* plan,
                                  int plan_len, cudaStream_t stream) {
  ProgramH h;
  cudaError_t err = make_program_h(p, plan, plan_len, h);
  if (err != cudaSuccess) return err;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytesH);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreadsH, kSmemBytesH);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int work = 1;  // blocks the busiest phase can use
  for (int i = 0; i < h.nphases; ++i) {
    int blocks = 0;
    for (int j = 0; j < h.phase[i].nconv; ++j) {
      const ConvT<bf16>& c = h.phase[i].conv[j];
      if (c.ky / 2 > kR || c.kx / 2 > kR) return cudaErrorInvalidValue;
      blocks += tiles_h(c, h.plan[i][j], h.M, h.W, h.xtiles);
    }
    work = blocks > work ? blocks : work;
  }
  const int grid = per_sm * sms < work ? per_sm * sms : work;
  void* args[] = {&h};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreadsH), args, kSmemBytesH, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The float32 form's launch, beside the bf16 one's: the plan is the bf16
// tile's and is not read.
template <typename Kernel>
inline cudaError_t launch_program(Kernel kernel, const ProgramT<float>& p, const int*, int,
                                  cudaStream_t stream) {
  return launch_program(kernel, p, stream);
}

// Checks shared by the entry points: sizes positive and M addressable.
inline bool valid_geometry(int batch, int height, int width) {
  if (batch < 0 || height < 0 || width < 0) return false;
  return (long long)batch * height * width <= (1LL << 30);
}

}  // namespace conv_phase
