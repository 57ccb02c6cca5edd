// The shared convolution tile and phase runner of the port's update-block
// kernels (sepconv_gru.cu, motion_fwd.cu, update_step.cu), NVIDIA Hopper
// (sm_90a), plain SIMT float32 with float32 accumulation.
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
// followed by zero rows up to a multiple of BK; a 2-channel input (the
// flow, whose 8-byte pixels allow no float4 load) packs taps x 2 channels
// densely instead, zero rows up to a multiple of BK; columns padded with
// zeros to a multiple of BN, and the bias likewise.
//
// A block computes a 64x64 output tile with 256 threads (4x4 each) through
// a double-buffered shared-memory pipeline with register prefetch, then
// applies one epilogue (bias + ReLU into a channel slice of a wider buffer,
// with an optional flow passthrough; the GRU gates; the GRU blend). An
// N = 2 convolution (the flow head's last) runs one warp per pixel instead
// of a 64-wide tile.
//
// A *program* is a list of phases, each of one or two convolutions whose
// tiles the blocks of one persistent cooperative grid share out; a
// grid-wide barrier separates two phases, so a whole chain of convolutions
// is one launch. The grid is sized by the occupancy calculator so that
// every block is co-resident; a launch the card refuses returns its error,
// and nothing falls back. Activations, which one phase writes and a later
// one reads, are loaded with ordinary loads, ordered by the barrier; the
// non-coherent read-only path (__ldg) is kept for the weights.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace conv_phase {

constexpr int BM = 64;     // pixels per tile
constexpr int BN = 64;     // output channels per tile
constexpr int BK = 16;     // reduction slice
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPadA = 4;   // shared-memory row padding of the A tile
constexpr int kMaxParts = 3;
constexpr int kMaxConvs = 2;
constexpr int kMaxPhases = 9;

enum Epilogue : int {
  kBiasRelu = 0,  // out[m, off + n] = relu(acc + b); with `flow`, channels
                  // N and N + 1 of the row get the flow, copied bit for bit
  kGates = 1,     // N = 2C: n < C -> out = sigmoid(acc + b)      (z)
                  //         n >= C -> out1 = sigmoid(acc + b) * h (r * h)
  kBlend = 2,     // N = C: out = (1 - z) * h + z * tanh(acc + b)
  kBiasWarp = 3,  // N = 2: out = acc + b, one warp per pixel
};

struct Conv {
  const float* in[kMaxParts];  // NHWC parts, each (M, cin[p]) contiguous
  int cin[kMaxParts];
  int nparts;
  int ky, kx;                  // odd kernel size, zero padding ky/2, kx/2
  const float* w;              // (packed_rows, ldw) row-major
  const float* bias;           // (ldw)
  int N, ldw;
  int epi;
  float* out;                  // (M, ld_out), written at channels off + n
  int ld_out, out_off;
  float* out1;                 // kGates: r * h, (M, N / 2)
  const float* h;              // kGates, kBlend: the GRU state, (M, N / 2)
  const float* z;              // kBlend: the update gate, (M, N)
  const float* flow;           // kBiasRelu: (M, 2) copied to N, N + 1, or null
};

struct Phase {
  Conv conv[kMaxConvs];
  int nconv;
};

struct Program {
  Phase phase[kMaxPhases];
  int nphases;
  int M, H, W;
};

struct Smem {
  float As[2][BK][BM + kPadA];
  float Bs[2][BK][BN];
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ inline bool two_channel(const Conv& c) {
  return c.nparts == 1 && c.cin[0] == 2;
}

// Rows of the packed weight matrix.
__host__ __device__ inline int packed_rows(const Conv& c) {
  const int taps = c.ky * c.kx;
  if (two_channel(c)) return round_up(2 * taps, BK);
  int per_tap = 0;
  for (int p = 0; p < c.nparts; ++p) per_tap += round_up(c.cin[p], BK);
  return taps * per_tap;
}

__host__ __device__ inline int conv_tiles(const Conv& c, int M) {
  return c.epi == kBiasWarp ? 0 : ((M + BM - 1) / BM) * (c.ldw / BN);
}

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// An activation load: an ordinary (weak, L1-cached) load, which the grid
// barrier orders after the previous phase's stores. Never __ldg: a buffer
// written in one phase of a launch is not read-only for the launch.
template <typename T>
__device__ __forceinline__ T act(const T* p) {
  return *p;
}

// One 64x64 output tile of convolution `c`.
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
  const int rows0 = round_up(cin0, BK);
  const int rows1 = c.nparts > 1 ? round_up(cin1, BK) : 0;
  const int rows2 = c.nparts > 2 ? round_up(cin2, BK) : 0;
  const int per_tap = rows0 + rows1 + rows2;
  const int ksteps = packed_rows(c) / BK;
  const int ldw = c.ldw;
  const float* wp = c.w;

  // A loader: one pixel row, four consecutive K entries of the slice.
  const int a_row = tid >> 2;
  const int a_k = (tid & 3) * 4;
  const int a_m = m0 + a_row;
  const bool a_live = a_m < M;
  const int a_x = a_m % W;
  const int a_y = (a_m / W) % H;
  // B loader: one weight row, four consecutive output channels.
  const int b_k = tid >> 4;
  const int b_n = (tid & 15) * 4;

  auto pixel = [&](int dy, int dx, int& src) -> bool {
    src = a_m + dy * W + dx;
    return a_live && a_y + dy >= 0 && a_y + dy < H && a_x + dx >= 0 && a_x + dx < W;
  };
  // Where the next A slice starts: its row within the tap's K rows and the
  // tap's offset. Slices are loaded in order, so this walks forward with
  // no division (a slice never straddles a tap or a part).
  int r0 = 0, dy = -(ky / 2), dx = -(kx / 2);
  auto load_a = [&](int kt) -> float4 {
    int src;
    if (two) {  // K entries (tap, channel) = (k/2, k%2) .. (k/2 + 1, 1)
      const int t0 = (kt * BK + a_k) >> 1;
      float2 lo = make_float2(0.f, 0.f), hi = make_float2(0.f, 0.f);
      if (t0 < taps && pixel(t0 / kx - ky / 2, t0 % kx - kx / 2, src))
        lo = act(reinterpret_cast<const float2*>(in0) + src);
      if (t0 + 1 < taps && pixel((t0 + 1) / kx - ky / 2, (t0 + 1) % kx - kx / 2, src))
        hi = act(reinterpret_cast<const float2*>(in0) + src);
      return make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    int r = r0 + a_k;
    const float* base = in0;
    int cin = cin0;
    if (r >= rows0) {
      r -= rows0;
      if (r >= rows1) {
        r -= rows1;
        base = in2;
        cin = cin2;
      } else {
        base = in1;
        cin = cin1;
      }
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    // cin is a multiple of 4, so four channels are all real or all padding
    if (r < cin && pixel(dy, dx, src))
      v = act(reinterpret_cast<const float4*>(base + (long long)src * cin + r));
    r0 += BK;
    if (r0 == per_tap) {
      r0 = 0;
      if (++dx > kx / 2) {
        dx = -(kx / 2);
        ++dy;
      }
    }
    return v;
  };
  auto load_b = [&](int kt) -> float4 {
    const long long row = (long long)kt * BK + b_k;
    return __ldg(reinterpret_cast<const float4*>(wp + row * ldw + n0 + b_n));
  };
  auto store = [&](int buf, float4 av, float4 bv) {
    sm.As[buf][a_k + 0][a_row] = av.x;
    sm.As[buf][a_k + 1][a_row] = av.y;
    sm.As[buf][a_k + 2][a_row] = av.z;
    sm.As[buf][a_k + 3][a_row] = av.w;
    *reinterpret_cast<float4*>(&sm.Bs[buf][b_k][b_n]) = bv;
  };

  const int ty = tid >> 4;  // output rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // output cols tx*4 .. tx*4+3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  store(0, load_a(0), load_b(0));
  __syncthreads();
  int buf = 0;
  for (int kt = 0; kt < ksteps; ++kt) {
    float4 next_a, next_b;
    const bool more = kt + 1 < ksteps;
    if (more) {
      next_a = load_a(kt + 1);
      next_b = load_b(kt + 1);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.As[buf][kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.Bs[buf][kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (more) store(buf ^ 1, next_a, next_b);
    __syncthreads();  // also frees shared memory for the block's next tile
    buf ^= 1;
  }

  const int n = n0 + tx * 4;
  const float4 bias = __ldg(reinterpret_cast<const float4*>(c.bias + n));
  const float bb[4] = {bias.x, bias.y, bias.z, bias.w};
  const int N = c.N;
  const int half = N / 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) break;
    float o[4];
    if (c.epi == kBiasRelu) {
      float* dst = c.out + (long long)m * c.ld_out + c.out_off + n;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = fmaxf(acc[i][j] + bb[j], 0.f);
      if (n + 4 <= N) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j < N)
            dst[j] = o[j];
          else if (c.flow != nullptr && n + j < N + 2)
            dst[j] = act(c.flow + 2LL * m + (n + j - N));
        }
      }
    } else if (c.epi == kGates) {
      if (n < half) {  // z half (the tile lies wholly in one half)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = sigmoidf_(acc[i][j] + bb[j]);
        *reinterpret_cast<float4*>(c.out + (long long)m * half + n) =
            make_float4(o[0], o[1], o[2], o[3]);
      } else {  // r half: emit r * h
        const int nc = n - half;
        const float4 hv = act(reinterpret_cast<const float4*>(c.h + (long long)m * half + nc));
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = sigmoidf_(acc[i][j] + bb[j]) * hr[j];
        *reinterpret_cast<float4*>(c.out1 + (long long)m * half + nc) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    } else {  // kBlend
      const long long at = (long long)m * N + n;
      const float4 hv = act(reinterpret_cast<const float4*>(c.h + at));
      const float4 zv = act(reinterpret_cast<const float4*>(c.z + at));
      const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
      const float zr[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float q = tanhf(acc[i][j] + bb[j]);
        o[j] = (1.f - zr[j]) * hr[j] + zr[j] * q;
      }
      *reinterpret_cast<float4*>(c.out + at) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// An N = 2 convolution of a single part (cin a multiple of 4), one warp
// per pixel: each lane dots four channels at a time against the two weight
// columns, then the warp sums its lanes. Weights (taps * cin, 2), bias (2).
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

// One phase: the blocks share out the tiles of every tiled convolution of
// the phase in order, then the pixels of an N = 2 convolution by warp.
__device__ void run_phase(const Phase& ph, int M, int H, int W, Smem& sm) {
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
// grid barrier needs a cooperative launch.
__device__ __forceinline__ void run_program(const Program& p) {
  __shared__ __align__(16) Smem sm;
  for (int i = 0; i < p.nphases; ++i) {
    if (i > 0) cooperative_groups::this_grid().sync();
    run_phase(p.phase[i], p.M, p.H, p.W, sm);
  }
}

// ---- host side -------------------------------------------------------------

inline Conv make_conv(int ky, int kx, const float* w, const float* bias, int N, int epi,
                      float* out, int ld_out, int out_off) {
  Conv c{};
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

inline void add_part(Conv& c, const float* in, int cin) {
  c.in[c.nparts] = in;
  c.cin[c.nparts] = cin;
  ++c.nparts;
}

inline void add_phase(Program& p, const Conv& a) {
  p.phase[p.nphases].conv[0] = a;
  p.phase[p.nphases].nconv = 1;
  ++p.nphases;
}

inline void add_phase(Program& p, const Conv& a, const Conv& b) {
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

struct MotionWeights {
  const float *wc1, *bc1, *wc2, *bc2, *wf1, *bf1, *wf2, *bf2, *wo, *bo;
};

// The three motion phases: convc1 | convf1, convc2 | convf2 (into one
// [cor | flo] buffer), then conv into `out` (M, 128) with the flow in
// channels 126-127. `scratch` holds kMotionScratch floats per pixel.
inline void add_motion_phases(Program& p, const float* corr, int cc, const float* flow,
                              const MotionWeights& mw, float* scratch, float* out) {
  const long long M = p.M;
  float* c1 = scratch;
  float* f1 = c1 + M * kC1;
  float* cf = f1 + M * kF1;
  Conv convc1 = make_conv(1, 1, mw.wc1, mw.bc1, kC1, kBiasRelu, c1, kC1, 0);
  add_part(convc1, corr, cc);
  Conv convf1 = make_conv(7, 7, mw.wf1, mw.bf1, kF1, kBiasRelu, f1, kF1, 0);
  add_part(convf1, flow, 2);
  add_phase(p, convc1, convf1);
  Conv convc2 = make_conv(3, 3, mw.wc2, mw.bc2, kC2, kBiasRelu, cf, kC2 + kF2, 0);
  add_part(convc2, c1, kC1);
  Conv convf2 = make_conv(3, 3, mw.wf2, mw.bf2, kF2, kBiasRelu, cf, kC2 + kF2, kC2);
  add_part(convf2, f1, kF1);
  add_phase(p, convc2, convf2);
  Conv conv = make_conv(3, 3, mw.wo, mw.bo, kCo, kBiasRelu, out, kMotion, 0);
  add_part(conv, cf, kC2 + kF2);
  conv.flow = flow;
  add_phase(p, conv);
}

struct GruWeights {
  const float *w_zr1, *b_zr1, *w_q1, *b_q1, *w_zr2, *b_zr2, *w_q2, *b_q2;
};

// The four GRU phases (gates, then candidate + blend, for the 1x5 half and
// then the 5x1 half) with x given as parts; z, rh and h1 are (M, C)
// scratch, `out` receives h'.
inline void add_gru_phases(Program& p, const float* h, int C, const float* const* xs,
                           const int* cxs, int nx, const GruWeights& gw, float* z, float* rh,
                           float* h1, float* out) {
  const float* w_zr[2] = {gw.w_zr1, gw.w_zr2};
  const float* b_zr[2] = {gw.b_zr1, gw.b_zr2};
  const float* w_q[2] = {gw.w_q1, gw.w_q2};
  const float* b_q[2] = {gw.b_q1, gw.b_q2};
  const float* state[2] = {h, h1};
  float* result[2] = {h1, out};
  for (int half = 0; half < 2; ++half) {
    const int ky = half ? 5 : 1, kx = half ? 1 : 5;
    Conv gates = make_conv(ky, kx, w_zr[half], b_zr[half], 2 * C, kGates, z, C, 0);
    gates.out1 = rh;
    gates.h = state[half];
    add_part(gates, state[half], C);
    Conv cand = make_conv(ky, kx, w_q[half], b_q[half], C, kBlend, result[half], C, 0);
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
// card as a cooperative grid on `stream`. Returns a cudaError_t: the card
// cannot run cooperative launches, the kernel fits no block on an SM, or
// the launch was refused.
template <typename Kernel>
inline cudaError_t launch_program(Kernel kernel, const Program& p, cudaStream_t stream) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int work = 1;  // blocks the busiest phase can use
  for (int i = 0; i < p.nphases; ++i) {
    int blocks = 0;
    for (int j = 0; j < p.phase[i].nconv; ++j) {
      const Conv& c = p.phase[i].conv[j];
      blocks += c.epi == kBiasWarp ? (p.M + kWarps - 1) / kWarps : conv_tiles(c, p.M);
    }
    work = blocks > work ? blocks : work;
  }
  const int grid = per_sm * sms < work ? per_sm * sms : work;
  void* args[] = {const_cast<Program*>(&p)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Checks shared by the entry points: sizes positive and M addressable.
inline bool valid_geometry(int batch, int height, int width) {
  if (batch < 0 || height < 0 || width < 0) return false;
  return (long long)batch * height * width <= (1LL << 30);
}

}  // namespace conv_phase
