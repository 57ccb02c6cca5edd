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

A variant's results are wrong by design; only its time is read. Run from
the repository root: ``python3 scripts/conv_tile_bench.py``.
"""

import os
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


def main():
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


if __name__ == "__main__":
    main()
