// The shared convolution tile and phase runner of the port's update-block
// kernels (sepconv_gru.cu, motion_fwd.cu, update_step.cu), NVIDIA Hopper
// (sm_90a): an implicit GEMM on the tensor cores in 3xTF32, which gives
// float32-grade products, with float32 accumulation. update_step.cu also
// runs a bf16 form of the tile (bfloat16 activations and weights, one bf16
// product pass; "the bf16 form" below), for the mixed-precision policy.
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
// same 128 bytes as a float32 stage, so the swizzle and the loaders' rows
// are the float32 tiles'.
constexpr int BKH = 64;
constexpr int kRowDstH = kRowStep / 8 * (kSBO / 2);  // bfloat16s kRowStep rows on
static_assert(BKH * 2 == 128, "a bfloat16 stage of a row is one 128-byte swizzle row");
static_assert(BKH == 4 * KC, "a bfloat16 stage is four chunks");

struct __align__(1024) SmemBf16 {
  bf16 A[kStages][BM * BKH];  // pixels x K
  bf16 B[kStages][BN * BKH];  // channels x K
};

// Element offset of the 16-byte chunk (row, K entries 8 c .. 8 c + 7) in a
// swizzled bfloat16 tile.
__device__ __forceinline__ int chunk_at_h(int row, int c) {
  return (row >> 3) * (kSBO / 2) + (row & 7) * BKH + ((c ^ (row & 7)) * 8);
}

template <typename T>
struct SmemOf {
  using type = Smem;
};
template <>
struct SmemOf<bf16> {
  using type = SmemBf16;
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

// d (+)= a * b over one k16 step, a 64 x 64 x 16 bfloat16 product of the
// warpgroup on the tensor cores with f32 accumulation, both operands K-major
// from shared memory; d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b, int accumulate) {
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
// The same tile, ring and epilogue places with bfloat16 activations and
// weights (the TPU kernels' compute dtype bfloat16): a stage is BKH = 64 K
// entries (four chunks), A and B both K-major in shared memory with the
// 128-byte swizzle, and each k16 step is one wgmma m64n64k16 bf16 product
// with f32 accumulation (the float32 form runs three TF32 products per k8
// step). Operand copies: 16 bytes (8 channels) a copy; a part whose channels
// are a multiple of 4 but not of 8 (the lookup's 324) has 8-byte aligned
// pixels and takes two 8-byte copies (cached in L1: only a launch input may
// be such a part); the flow's 4-byte pixels 4-byte copies (4 taps a
// 16-byte slot).
//
// Rounding, as the JAX kernels' (step_pallas.py, gru_pallas.py, flax Conv
// at dtype bfloat16): each conv's f32 sum is rounded to bfloat16 and the
// bfloat16 bias added in bfloat16, v = bf16(bf16(acc) + b); then
//   kBiasRelu: relu(v);
//   kGates: z = bf16(sigmoid(v)); r * h as bf16(bf16(sigmoid(v)) * h);
//   kBlend: q = bf16(tanh(v)), h' = bf16(bf16(bf16(1 - z) * h) + bf16(z * q));
//   kBiasWarp: f32 sums of the exact products of bfloat16 values, then v.
// Each value is computed in f32 registers and rounded where the JAX kernel
// rounds.

__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float2 bf2_at(const bf16* p) {
  return __bfloat1622float2(act(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ void put_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One BM x BN output tile of a bfloat16 convolution `c`.
__device__ void conv_tile(const ConvT<bf16>& c, int M, int H, int W, int tile, SmemBf16& sm) {
  const int tid = threadIdx.x;
  const int mtiles = (M + BM - 1) / BM;
  const int m0 = (tile % mtiles) * BM;
  const int n0 = (tile / mtiles) * BN;
  const int kx = c.kx, ky = c.ky, taps = kx * ky;
  const bool two = two_channel(c);
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

  // The loaders: 16-byte column l_c of the stage (chunk l_c / 2, its K
  // entries a_f .. a_f + 7), rows l_r0 + kRowStep i.
  const int l_c = tid & 7;
  const int l_r0 = tid >> 3;
  const int dst = chunk_at_h(l_r0, l_c);
  const bf16* w_src = c.w + (long long)(n0 + l_r0) * krows + l_c * 8;
  const long long w_row = (long long)kRowStep * krows;
  const int a_q = l_c >> 1;
  const int a_f = (l_c & 1) * 8;
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
  int w_ty = 0, w_tx = 0, w_c = a_q;
  while (w_c >= per_tap) {
    w_c -= per_tap;
    if (++w_tx == kx) w_tx = 0, ++w_ty;
  }
  auto load_stage = [&](int kt, int slot) {
    const int q = kt * (BKH / KC) + a_q;  // this thread's chunk
    if (two) {  // K entries (tap, channel) = (k / 2, k % 2), 4-byte pixels
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
        ok = r < cin;
        w_c += BKH / KC;
        while (w_c >= per_tap) {
          w_c -= per_tap;
          if (++w_tx == kx) w_tx = 0, ++w_ty;
        }
      }
      // cin is a multiple of 4: a half copy is all real or all padding
      const bool narrow = (cin & 7) != 0;
      const bool ok_hi = r + 4 < cin;
      const bf16* at = base + (long long)(dy * W + dx) * cin + r;
#pragma unroll
      for (int i = 0; i < kARows; ++i) {
        const bool v = ok && inside(i, dy, dx);
        const bf16* src = v ? at + (long long)a_m[i] * cin : base;
        bf16* d = &sm.A[slot][dst + kRowDstH * i];
        if (narrow) {
          cp_async8_readonly(d, src, v);
          cp_async8_readonly(d + 4, v && ok_hi ? src + 4 : base, v && ok_hi);
        } else {
          cp_async16(d, src, v);
        }
      }
    }
    const bool bv = kt * BKH + l_c * 8 < krows;  // krows is a multiple of 16
    const bf16* w = bv ? w_src + kt * BKH : c.w;
#pragma unroll
    for (int i = 0; i < kBRows; ++i) cp_async16(&sm.B[slot][dst + kRowDstH * i], w + w_row * i, bv);
  };

  float acc[kNt][4], part[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.f;
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
  __syncthreads();
  for (int kt = 0; kt < ksteps; ++kt) {
    const int slot = kt % kStages;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < BKH / 16; ++s) {  // k16 step s: 32 bytes into each row
      wgmma_bf16(&part[0][0], gmma_desc(&sm.A[slot][16 * s]), gmma_desc(&sm.B[slot][16 * s]),
                 s > 0);
    }
    wgmma_commit();
    if (kt + 1 < ksteps) {
      cp_async_wait<kStages - 3>();
      fence_async_shared();
    }
    const int next = kt + kStages - 1;
    if (next < ksteps) load_stage(next, next % kStages);
    cp_async_commit();
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
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
      const float v0 = rbf(rbf(acc[j][2 * e]) + bias.x);
      const float v1 = rbf(rbf(acc[j][2 * e + 1]) + bias.y);
      if (c.epi == kBiasRelu) {
        bf16* dst_p = c.out + (long long)m * c.ld_out + c.out_off + n;
        if (n + 1 < N) {
          put_bf2(dst_p, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        } else {
          const float o[2] = {fmaxf(v0, 0.f), fmaxf(v1, 0.f)};
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            if (n + t < N)
              dst_p[t] = __float2bfloat16_rn(o[t]);
            else if (c.flow != nullptr && n + t < N + 2)
              dst_p[t] = act(c.flow + 2LL * m + (n + t - N));
          }
        }
      } else if (c.epi == kGates) {
        if (n < half) {  // z half (the tile lies wholly in one half)
          put_bf2(c.out + (long long)m * half + n, sigmoidf_(v0), sigmoidf_(v1));
        } else {  // r half: emit r * h
          const long long at = (long long)m * half + (n - half);
          const float2 hv = bf2_at(c.h + at);
          put_bf2(c.out1 + at, rbf(sigmoidf_(v0)) * hv.x, rbf(sigmoidf_(v1)) * hv.y);
        }
      } else {  // kBlend
        const long long at = (long long)m * N + n;
        const float2 hv = bf2_at(c.h + at);
        const float2 zv = bf2_at(c.z + at);
        const float q0 = rbf(tanhf(v0)), q1 = rbf(tanhf(v1));
        put_bf2(c.out + at, rbf(rbf(1.f - zv.x) * hv.x) + rbf(zv.x * q0),
                rbf(rbf(1.f - zv.y) * hv.y) + rbf(zv.y * q1));
      }
    }
  }
}

// The N = 2 convolution of the bf16 form, one warp per pixel: each lane
// dots four channels at a time (8 bytes of input, 16 bytes of the (taps *
// cin, 2) bfloat16 weights) in f32; cin a multiple of 4.
__device__ void conv_n2_pixels(const ConvT<bf16>& c, int M, int H, int W, int warp, int nwarps) {
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
      const bf16* src = c.in[0] + (long long)(m + dy * W + dx) * cin;
      const bf16* wr = c.w + 2LL * tap * cin;
      for (int ch = lane * 4; ch < cin; ch += 128) {
        const float2 v01 = bf2_at(src + ch), v23 = bf2_at(src + ch + 2);
        const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wr + 2 * ch));
        const float2 w0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv.x));
        const float2 w1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv.y));
        const float2 w2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv.z));
        const float2 w3 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv.w));
        a0 = fmaf(v01.x, w0.x, fmaf(v01.y, w1.x, fmaf(v23.x, w2.x, fmaf(v23.y, w3.x, a0))));
        a1 = fmaf(v01.x, w0.y, fmaf(v01.y, w1.y, fmaf(v23.x, w2.y, fmaf(v23.y, w3.y, a1))));
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, s);
      a1 += __shfl_xor_sync(0xffffffffu, a1, s);
    }
    if (lane == 0) {
      c.out[2LL * m] = __float2bfloat16_rn(rbf(a0) + __ldg(c.bias));
      c.out[2LL * m + 1] = __float2bfloat16_rn(rbf(a1) + __ldg(c.bias + 1));
    }
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

// Checks shared by the entry points: sizes positive and M addressable.
inline bool valid_geometry(int batch, int height, int width) {
  if (batch < 0 || height < 0 || width < 0) return false;
  return (long long)batch * height * width <= (1LL << 30);
}

}  // namespace conv_phase
