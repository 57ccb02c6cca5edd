#!/usr/bin/env python3
"""Where the port's conv tile (``raft_tpu_torch/csrc/conv_phase.cuh``)
spends its time, on one CUDA card.

The card's machine has no kernel profiler, so this script times variants
of the tile with parts of its work taken out: it writes each variant of
the header into ``build/conv_tile_bench/<variant>/``, builds one small
harness against each (one ``nvcc`` each, all at once) and times the GRU
cell's four phases (``add_gru_phases``, C = 128, x as two 128-channel
parts) at the Sintel feature shape (B=1, 55x128) with CUDA events, 20
launches after 3 warm-ups. Variants:

- ``tile``: the tile as it is;
- ``no_a_copies``: the activations' cp.async copies only for the first
  stages of a tile (later stages reuse stale shared memory);
- ``no_b_copies``: the same for the weights' copies;
- ``no_mma``: the tensor-core products replaced by one add each.

A variant's results are wrong by design; only its time is read.

``bf16`` mode times the tile's bf16 form with the same four variants,
each in a copy of this tree's ``raft_tpu_torch`` written under
``build/conv_tile_bench/bf16-<variant>/`` (the variant's edits in its
``conv_phase.cuh``) and run in a process of its own through the port's
wrappers: ``update_step_bf16`` at both depths (the step's nine phases at
'mgf', seven at 'mg') and ``sepconv_gru_bf16`` (the GRU's four phases, x
as the chain's two parts) and ``motion_fwd_bf16`` (three phases) at the
Sintel feature shape (B=1, 55x128, C=128, Cc=324), and the step at 'mg'
at the chairs training shape (B=8, 46x62), on seeded inputs and weights
(the same in every tree). Each time is chip_smoke's ``queued_ms`` (median
of 30 launches queued behind a sleep: device time). The ``tile`` variant
also holds each bf16 form against its plain version (8 bf16 eps of
max(1, max|plain|); delta of max|plain|) and times the float32 forms of
the three kernels on the same values. ``--parent DIR`` first runs the
``tile`` variant on another tree: the parent commit unpacked with ``git
archive`` into a git-ignored directory, so that the parent's kernels and
these are timed in one call. A variant's edits are given for the bf16
tile before its warp-specialised redesign and after it; the script applies
the set whose texts the tree's header holds. The warp-specialised tile
has three more variants: ``epi_unroll1`` and ``epi_unroll4`` (the
epilogue's loop unrolled once and four times, twice in the tile), and
``trace``, which prints ``clock64()`` stamps that block 0 recorded in each
kernel's third launch (warm): each stage of the first gates phase (when
the producer found it free and had issued it, when the consumers found it
full and had freed the one before), each phase's length, the shortest and
longest work of a block in it, and each epilogue (and its staging of the
sums); ``--variants`` picks the variants to run.

Run from the repository root:

    python3 scripts/conv_tile_bench.py [f32|bf16] [--parent build/parent]
        [--variants tile,no_a_copies,no_b_copies,no_mma]
"""

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(REPO, "raft_tpu_torch", "csrc", "conv_phase.cuh")
OUT = os.path.join(REPO, "build", "conv_tile_bench")

HARNESS = r"""
#include "conv_phase.cuh"
#include <cstdio>
#include <cstdlib>
#include <vector>
using namespace conv_phase;
__global__ void __launch_bounds__(kThreads, 2) prog(const __grid_constant__ Program p) {
  run_program(p);
}
static float* dev_rand(size_t n, float scale, unsigned seed) {
  std::vector<float> h(n);
  srand(seed);
  for (auto& v : h) v = scale * ((rand() / (float)RAND_MAX) * 2.f - 1.f);
  float* d;
  cudaMalloc(&d, n * 4);
  cudaMemcpy(d, h.data(), n * 4, cudaMemcpyHostToDevice);
  return d;
}
int main() {
  const int H = 55, W = 128, M = H * W, C = 128, K = 5 * 3 * C;
  float* h = dev_rand((size_t)M * C, 1.f, 1);
  const float* xs[2] = {dev_rand((size_t)M * C, 1.f, 2), dev_rand((size_t)M * C, 1.f, 3)};
  const int cxs[2] = {C, C};
  float* w_zr = dev_rand((size_t)2 * 2 * C * K, 0.02f, 4);
  float* b_zr = dev_rand(2 * C, 0.1f, 5);
  float* w_q = dev_rand((size_t)2 * C * K, 0.02f, 6);
  float* b_q = dev_rand(C, 0.1f, 7);
  float* scratch;
  cudaMalloc(&scratch, (size_t)4 * M * C * 4);
  const GruWeights gw{w_zr, b_zr, w_q, b_q, w_zr, b_zr, w_q, b_q};
  Program p{};
  p.M = M;
  p.H = H;
  p.W = W;
  add_gru_phases(p, h, C, xs, cxs, 2, gw, scratch, scratch + (size_t)M * C,
                 scratch + (size_t)2 * M * C, scratch + (size_t)3 * M * C);
  for (int i = 0; i < 3; ++i) launch_program(prog, p, 0);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < 20; ++i) launch_program(prog, p, 0);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("error %s\n", cudaGetErrorString(err));
    return 1;
  }
  const double flop = 2.0 * 2 * M * 5.0 * 384 * 384;
  printf("%.4f ms, %.1f TFLOP/s\n", ms / 20, flop / (ms / 20) / 1e9);
  return 0;
}
"""

# (text in the header, its replacement)
A_COPY = "        cp_async16(&sm.A[slot][dst + kRowDst * i], src, v);"
B_COPY = "      cp_async16(&sm.B[slot][0][dst + kRowDst * i], w + w_row * i, bv);"
B_COPY_LO = ("      cp_async16(&sm.B[slot][1][dst + kRowDst * i], "
             "w + w_row * i + lo_off, bv);")
FIRST = "if (kt < kStages - 1) "
MMAS = ("      wgmma_tf32(&part[0][0], al[s], b_hi, s > 0);\n"
        "      wgmma_tf32(&part[0][0], ah[s], b_lo, 1);\n"
        "      wgmma_tf32(&part[0][0], ah[s], b_hi, 1);")
VARIANTS = {
    "tile": [],
    "no_a_copies": [(A_COPY, A_COPY.replace("cp_async16", FIRST + "cp_async16"))],
    "no_b_copies": [(B_COPY, B_COPY.replace("cp_async16", FIRST + "cp_async16")),
                    (B_COPY_LO, B_COPY_LO.replace("cp_async16", FIRST + "cp_async16"))],
    "no_mma": [(MMAS, "      part[0][0] += __uint_as_float(al[s][0] ^ ah[s][1]) "
                      "+ (float)(b_hi & 7) + (float)(b_lo & 3);")],
}


def main_f32():
    src = open(HEADER).read()
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    jobs = []
    for name, subs in VARIANTS.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        text = src
        for old, new in subs:
            if old not in text:
                sys.exit(f"conv_tile_bench: {name}: the header no longer has {old!r}")
            text = text.replace(old, new)
        with open(os.path.join(d, "conv_phase.cuh"), "w") as f:
            f.write(text)
        with open(os.path.join(d, "bench.cu"), "w") as f:
            f.write(HARNESS)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-I", d, "-o", os.path.join(d, "bench"), os.path.join(d, "bench.cu")]
        jobs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    failed = False
    for name, proc in jobs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            print(f"{name}: build failed\n{log}")
            failed = True
    if failed:
        sys.exit(1)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for name, _ in jobs:
        run = subprocess.run([os.path.join(OUT, name, "bench")], capture_output=True,
                             text=True, timeout=300)
        print(f"GRU cell (Sintel, 4 phases) [{name}]: {run.stdout.strip()}")
        if run.returncode != 0:
            sys.exit(1)


# -- bf16 mode ----------------------------------------------------------------

# The bf16 tile before its warp-specialised redesign: (text, replacement).
_OLD_A = "        bf16* d = &sm.A[slot][dst + kRowDstH * i];\n"
_OLD_FLOW = "          cp_async4_readonly(&sm.A[slot][dst + kRowDstH * i + 2 * e], src, ok);"
_OLD_B = ("    for (int i = 0; i < kBRows; ++i) cp_async16(&sm.B[slot][dst + kRowDstH * i], "
          "w + w_row * i, bv);")
_OLD_MMA = ("      wgmma_bf16(&part[0][0], gmma_desc(&sm.A[slot][16 * s]), "
            "gmma_desc(&sm.B[slot][16 * s]),\n                 s > 0);")
OLD_BF16 = {
    "tile": [],
    "no_a_copies": [(_OLD_A, _OLD_A + "        if (kt >= kStages - 1) continue;\n"),
                    (_OLD_FLOW, "          if (kt < kStages - 1) " + _OLD_FLOW.lstrip())],
    "no_b_copies": [(_OLD_B, _OLD_B.replace("cp_async16", "if (kt < kStages - 1) cp_async16"))],
    "no_mma": [(_OLD_MMA, "      part[0][0] += (float)(gmma_desc(&sm.A[slot][16 * s]) & 7) + "
                          "(float)(gmma_desc(&sm.B[slot][16 * s]) & 3);")],
}
# The warp-specialised tile, recognised by NEW_MARKER.
NEW_MARKER = "kConsumers"
_NEW_A = "    if (pl.copy[0] == 4) {  // the flow: K entries (tap, channel) = (k / 2, k % 2)"
_NEW_TMA_EXPECT = "        mbar_arrive_expect_tx(&sm.full[slot], b_bytes + BM * BKH * 2);\n"
_NEW_TMA_B = "        tma_load_2d(sm.B[slot], wmap, ks * BKH, at.n0, &sm.full[slot]);\n"
_NEW_TMA_A = "        tma_load_4d(sm.A[slot], amap + p,"
_NEW_CP_B = ("      mbar_arrive_expect_tx(&sm.full[slot], b_bytes);\n"
             "      tma_load_2d(sm.B[slot], wmap, kt * BKH, at.n0, &sm.full[slot]);\n")
_NEW_MMA = ("      wgmma_bf16<NC>(acc, gmma_desc(a + 16 * s), gmma_desc(b + 16 * s), "
            "kt > 0 || s > 0);")
_LATER = "kt < kStagesH - 1"   # a later stage reuses the ring's stale data
_NEW_EMPTY = "\n    mbar_wait(&sm.empty[slot], pr.issue.parity ^ 1);\n"
_NEW_EMPTY_TMA = "\n        mbar_wait(&sm.empty[slot], pr.issue.parity ^ 1);\n"
_NEW_ISSUED_TMA = "        pr.issue.advance();\n        pr.publish.advance();\n"
_NEW_ISSUED = "    cp_async_commit();\n    pr.issue.advance();\n"
_NEW_FULL = "    mbar_wait(&sm.full[slot], ring.parity);\n"
_NEW_FREED = "    wgmma_wait_n<1>();  // the stage before is multiplied: free it\n"
_NEW_DONE = "  wgmma_wait_n<0>();\n  if (prev >= 0 && lane == 0) mbar_arrive(&sm.empty[prev]);\n"


def _stamp(row, who):
    return (f"    if (blockIdx.x == 0 && {who} == 0 && kt < 64) "
            f"g_trace[{row}][kt] = clock64();\n")


# The trace prints what it recorded in the third launch of each kernel (warm
# caches): block 0's first gates phase stage by stage, each phase's length
# for block 0 and the shortest and longest own work of a block in it (the
# phase's tiles, to the end of the block's last epilogue), and block 0's
# epilogues in order.
_TRACE_DECLS = (
    "__device__ volatile long long g_trace[4][64];\n"
    "__device__ volatile long long g_phase[16];\n"
    "__device__ volatile long long g_epi[32];\n"
    "__device__ volatile long long g_staged[32];\n"
    "__device__ int g_launch, g_nepi;\n"
    "__device__ unsigned long long g_work_max[4][16];\n"
    "__device__ unsigned long long g_work_min[4][16] = {"
    + ", ".join("{" + ", ".join(["~0ull"] * 16) + "}" for _ in range(4)) + "};\n")
_TRACE_PRINT = r"""  if (blockIdx.x == 0 && threadIdx.x == 0 && c.epi == kGates && c.ky == 1 &&
      g_launch == 2) {
    for (int k = 0; k < ksteps && k < 64; ++k)
      printf("trace gates1 block 0 stage %d: empty passed %lld, issued %lld, full passed "
             "%lld, stage before freed %lld\n", k, g_trace[0][k] - g_trace[0][0],
             g_trace[1][k] - g_trace[0][0], g_trace[2][k] - g_trace[0][0],
             g_trace[3][k] - g_trace[0][0]);
  }
  const long long t_epi = clock64();
"""
_NEW_SYNC = "    if (i > 0) cooperative_groups::this_grid().sync();\n    const PhaseT<bf16>& ph = p.phase[i];\n"
_NEW_END = "    if (producer) drain(sm, pr);\n  }\n}\n"
_NEW_EPI_END = ("    default: epilogue<NC, kBlend>(c, acc, st, at, n0, W, cons, ctid); break;\n"
                "  }\n}\n")
_NEW_EPI_LOOP = "#pragma unroll 2\n  for (int idx = ctid; idx < BM * kPairs; idx += 128) {"
_NEW_STAGED = "  consumer_sync(cons);\n  const int N = c.N;\n"
_EPI_STAMP = ("  if (blockIdx.x == 0 && threadIdx.x == 0 && g_nepi < 32) "
              "g_staged[g_nepi] -= t_epi, g_epi[g_nepi++] = clock64() - t_epi;\n")
_PHASE_PRINT = r"""  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (g_launch == 2) {
      g_phase[p.nphases] = clock64();
      for (int i = 0; i < p.nphases; ++i)
        printf("trace phase %d of %d, block 0: %lld cycles; a block's own work in it: "
               "%llu to %llu cycles\n", i, p.nphases, g_phase[i + 1] - g_phase[i],
               g_work_min[2][i], g_work_max[2][i]);
      for (int k = 0; k < g_nepi; ++k)
        printf("trace block 0 epilogue %d: %lld cycles, %lld of them to stage the sums\n", k,
               g_epi[k], g_staged[k]);
    }
    ++g_launch;
  }
"""
_WORK = ("    if (threadIdx.x == 0 && launch < 4) {\n"
         "      const unsigned long long d = clock64() - t_start;\n"
         "      atomicMax(&g_work_max[launch][i], d);\n"
         "      atomicMin(&g_work_min[launch][i], d);\n    }\n")
_RUN_START = "  const bool producer = threadIdx.x >= kProducer;\n"
NEW_BF16 = {
    "tile": [],
    "no_a_copies": [(_NEW_A, "    if (kt >= kStagesH - 1) {\n    } else" + _NEW_A[3:]),
                    (_NEW_TMA_EXPECT, _NEW_TMA_EXPECT.replace(
                        "BM * BKH * 2", f"({_LATER} ? BM * BKH * 2 : 0)")),
                    (_NEW_TMA_A, f"        if ({_LATER}) " + _NEW_TMA_A.lstrip())],
    "no_b_copies": [(_NEW_TMA_EXPECT, _NEW_TMA_EXPECT.replace(
                        "b_bytes", f"({_LATER} ? b_bytes : 0)")),
                    (_NEW_TMA_B, f"        if ({_LATER}) " + _NEW_TMA_B.lstrip()),
                    (_NEW_CP_B, _NEW_CP_B.replace("b_bytes", f"{_LATER} ? b_bytes : 0")
                     .replace("      tma_load_2d", f"      if ({_LATER}) tma_load_2d"))],
    "no_mma": [(_NEW_MMA, "      acc[0] += (float)(gmma_desc(a + 16 * s) & 7) + "
                          "(float)(gmma_desc(b + 16 * s) & 3);")],
    # clock64() stamps of block 0's first stages of the first gates phase:
    # when the producer finds each stage free and has issued its copies,
    # when the consumers find it full and have freed the one before
    "trace": [("#include <cooperative_groups.h>\n", "#include <cooperative_groups.h>\n#include <cstdio>\n"),
              ("constexpr int kConsumers = 2;", _TRACE_DECLS + "constexpr int kConsumers = 2;"),
              (_RUN_START, _RUN_START + "  const int launch = g_launch;\n"
               "  if (blockIdx.x == 0 && threadIdx.x == 0) g_nepi = 0;\n"),
              (_NEW_SYNC, _NEW_SYNC + "    if (blockIdx.x == 0 && threadIdx.x == 0) g_phase[i] = clock64();\n"
               "    const long long t_start = clock64();\n"),
              (_NEW_END, "    if (producer) drain(sm, pr);\n" + _WORK + "  }\n" + _PHASE_PRINT + "}\n"),
              (_NEW_EMPTY, _NEW_EMPTY + _stamp(0, "tid")),
              (_NEW_ISSUED, _NEW_ISSUED + _stamp(1, "tid")),
              (_NEW_EMPTY_TMA, _NEW_EMPTY_TMA + "    " + _stamp(0, "tid")),
              (_NEW_ISSUED_TMA, "    " + _stamp(1, "tid") + _NEW_ISSUED_TMA),
              (_NEW_FULL, _NEW_FULL + _stamp(2, "threadIdx.x")),
              (_NEW_FREED, _NEW_FREED + _stamp(3, "threadIdx.x")),
              (_NEW_DONE, _NEW_DONE + _TRACE_PRINT),
              (_NEW_EPI_END, _NEW_EPI_END[:-2] + _EPI_STAMP + "}\n"),
              (_NEW_STAGED, _NEW_STAGED + "  if (blockIdx.x == 0 && threadIdx.x == 0 && g_nepi < 32) "
               "g_staged[g_nepi] = clock64();\n")],
    # the epilogue's loop over the tile's column pairs unrolled 1 and 4 times
    # (2 in the tile)
    "epi_unroll1": [(_NEW_EPI_LOOP, _NEW_EPI_LOOP.replace("unroll 2", "unroll 1"))],
    "epi_unroll4": [(_NEW_EPI_LOOP, _NEW_EPI_LOOP.replace("unroll 2", "unroll 4"))],
}
BF16_VARIANTS = ("tile", "no_a_copies", "no_b_copies", "no_mma")
# (label, batch, height, width, what is timed there)
BF16_SHAPES = (("sintel", 1, 55, 128, ("mgf", "mg", "gru", "motion")),
               ("chairs", 8, 46, 62, ("mg",)))


def bf16_edits(header_text, name):
    """The edits of variant ``name`` for the tile this header holds."""
    table = NEW_BF16 if NEW_MARKER in header_text else OLD_BF16
    edits = table[name]
    for old, _ in edits:
        if header_text.count(old) != 1:
            sys.exit(f"conv_tile_bench: bf16 {name}: the header has {old!r} "
                     f"{header_text.count(old)} times, not once")
    return edits


def bf16_tree(name):
    """A copy of this tree's raft_tpu_torch with variant ``name``'s edits."""
    root = os.path.join(OUT, f"bf16-{name}")
    pkg = os.path.join(root, "raft_tpu_torch")
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "raft_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(pkg, "csrc", "conv_phase.cuh")
    text = open(path).read()
    for old, new in bf16_edits(text, name):
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return root


def load_smoke():
    """chip_smoke.py of this tree (its inputs, bars and timer)."""
    spec = importlib.util.spec_from_file_location(
        "conv_bench_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_bf16(name):
    """Time (and for ``tile`` check) the bf16 forms of the tree on sys.path."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("conv_tile_bench: no CUDA device")
    smoke = load_smoke()
    from raft_tpu_torch.models.update import BasicUpdateBlock
    from raft_tpu_torch.ops import build, gru_cuda, motion_cuda, step_cuda

    exact = name in ("tile", "parent")
    print(smoke.card_line())
    paths = build.build(("update_step", "sepconv_gru", "motion_fwd"))
    for lib, path in paths.items():
        with open(path + ".log") as f:
            print(f"{lib}: " + " | ".join(ln.strip() for ln in f
                                         if "registers" in ln or "spill" in ln))
    torch.manual_seed(0)
    dev = torch.device("cuda")
    block = BasicUpdateBlock().to(dev).eval()
    enc, gru, head = block.encoder, block.gru, block.flow_head
    convs = (enc.convs(), gru.convs(), head.convs())
    packed = {torch.bfloat16: step_cuda.pack_bf16(convs),
              torch.float32: (enc.packed_weights(), gru.packed_weights(),
                              head.packed_weights())}
    gru_packed = {torch.bfloat16: gru.packed_weights_bf16(),
                  torch.float32: gru.packed_weights()}
    motion_packed = {torch.bfloat16: enc.packed_weights_bf16(),
                     torch.float32: enc.packed_weights()}
    worst = 0.0
    for label, b, h, w, what in BF16_SHAPES:
        rng = np.random.default_rng(0)

        def put(a):
            return torch.tensor(a, dtype=torch.float32, device=dev)
        f32 = (put(np.tanh(rng.standard_normal((b, h, w, 128)))),
               put(np.maximum(rng.standard_normal((b, h, w, 128)), 0)),
               put(rng.standard_normal((b, h, w, 324))),
               put(rng.uniform(-20.0, 20.0, (b, h, w, 2))))
        for dt in ((torch.bfloat16, torch.float32) if exact else (torch.bfloat16,)):
            net, inp, cor, flow = (t.to(dt) for t in f32)
            with torch.inference_mode():
                mot = motion_cuda.motion_encoder_plain(flow, cor, enc.convs())
            runs = {
                "mgf": (lambda: step_cuda.fused_step_cuda(net, inp, cor, flow, packed[dt]),
                        lambda: step_cuda.fused_step_plain(net, inp, cor, flow, convs)),
                "mg": (lambda: step_cuda.fused_step_cuda(
                           net, inp, cor, flow, packed[dt][:2] + (None,)),
                       lambda: step_cuda.fused_step_plain(
                           net, inp, cor, flow, convs[:2] + (None,))),
                "gru": (lambda: gru_cuda.sepconv_gru_cuda(net, (inp, mot), gru_packed[dt]),
                        lambda: gru_cuda.sepconv_gru_plain(net, (inp, mot), gru.convs())),
                "motion": (lambda: motion_cuda.motion_encoder_cuda(flow, cor,
                                                                   motion_packed[dt]),
                           lambda: motion_cuda.motion_encoder_plain(flow, cor,
                                                                    enc.convs())),
            }
            for key in what:
                run, plain = runs[key]
                row = {"variant": name, "kernel": key, "dtype": str(dt).split(".")[-1],
                       "shape": f"{label} B={b} {h}x{w}"}
                with torch.inference_mode():
                    if exact and dt == torch.bfloat16:
                        got, want = run(), plain()
                        torch.cuda.synchronize()
                        got = got if isinstance(got, tuple) else (got,)
                        want = want if isinstance(want, tuple) else (want,)
                        errs = []
                        for i, (a, c) in enumerate(zip(got, want)):
                            top = float(c.float().abs().max())
                            scale = max(1.0, top) if i == 0 else top
                            errs.append(float((a.float() - c.float()).abs().max()) / scale)
                        row["err_eps"] = max(errs) / smoke.BF16_EPS
                        worst = max(worst, row["err_eps"])
                    row["ms_q"] = smoke.queued_ms(torch, run)
                print(json.dumps(row), flush=True)
    print(smoke.card_line())
    if exact:
        print(json.dumps({"variant": name, "worst_err_eps": worst, "bar_eps": 8}))
        if not worst <= 8:
            raise SystemExit(f"conv_tile_bench: bf16 {name} disagrees with the plain version")


def main_bf16(parent, variants=BF16_VARIANTS):
    runs = [("parent", os.path.abspath(parent))] if parent else []
    runs += [(name, bf16_tree(name)) for name in variants]
    failed = []
    for name, tree in runs:
        print(f"variant {name}", flush=True)
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "bf16",
                              "--child", name, tree], text=True, capture_output=True)
        print(run.stdout + run.stderr, flush=True)
        if run.returncode:
            failed.append(name)
    if failed:
        raise SystemExit(f"conv_tile_bench: failed: {', '.join(failed)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", choices=("f32", "bf16"), default="f32",
                    help="the float32 tile's breakdown (default) or the bf16 form's")
    ap.add_argument("--parent", metavar="DIR",
                    help="bf16: the parent commit's tree (git archive), whose kernels "
                         "are timed and checked first, on the same inputs")
    ap.add_argument("--variants", default=",".join(BF16_VARIANTS),
                    help="bf16: the variants to run, comma-separated (default: all)")
    ap.add_argument("--child", nargs=2, metavar=("NAME", "TREE"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, os.path.abspath(args.child[1]))
        run_bf16(args.child[0])
    elif args.mode == "bf16":
        main_bf16(args.parent, args.variants.split(","))
    else:
        main_f32()


if __name__ == "__main__":
    main()
