#!/usr/bin/env python3
"""What holds the port's windowed-correlation kernels back, and its
deformable-attention (MSDA) kernels, on one CUDA card: their time by
variant, budget or path, and input.

For the lookup shapes of the main paths (Sintel, B=1, 55x128, C=256, 4
levels; the chairs train shape, B=8, 46x62; the sparse family's fork lookup
at its three token levels of 352x480, B=8, 2 levels without rescale, at its
half-pixel centres), on chip_smoke's coherent and incoherent flows, this
script times ``corr_fwd`` and ``corr_bwd`` (chip_smoke's ``time_ms``:
median of 30 launches between CUDA events) in copies of this tree's
kernels with one part of their work changed, each written under
``build/corr_tile_bench/<variant>/`` and run in a process of its own:

- ``tile``: the kernels as they are, at the budgets 0 (the warp path on
  every block), 256, 512, 1024 (the default), 2048 and 10**8 (the shared
  path on every block);
- ``no_copies``: the shared path's cp.async copies only for the first
  stage (forward) or the first chunk (backward), later ones reuse stale
  shared memory;
- ``one_pass``: one TF32 product (hi x hi) in place of 3xTF32's three;
- ``no_mma``: the tensor-core products replaced by one add each;
- ``no_df2_atomics``: the backward's shared path without its df2 atomics;
- ``warp_smem``: the launch reserves only the warp path's dynamic shared
  memory (budget 0 only: the shared path would overrun it);
- ``warp_only``: ``warp_smem`` with the shared path compiled out, so that
  the kernel also holds only the warp path's registers (budget 0);
- ``no_df1_atomics``: the backward's warp path stores its df1 sums in
  place of adding them with atomics (budget 0).

Each time is taken twice: by chip_smoke's ``time_ms``, whose events may
also hold the host's time in the wrapper when the card runs ahead of it (a
kernel shorter than the wrapper's Python), and by chip_smoke's
``queued_ms``, which first queues a ``torch.cuda._sleep`` of about 10 ms
so that every timed launch waits in the stream and its events hold the
kernel alone.

The variants that compute the lookup exactly (``tile``, ``warp_smem``,
``warp_only``) are held against the plain versions (chip_smoke's ``TOL``
and ``CORR_BWD_REL``); the others are wrong by design and only timed. Each
row, one JSON line, has the share of (tile, level) blocks on the shared
path and the blocks of a launch; each variant prints its libraries'
registers and spills and the card's name and power limit.

``--parent DIR`` first times and checks, at its default and on the same
inputs, the kernels of another tree: the parent commit unpacked with
``git archive`` into a git-ignored directory, so that the parent's kernels
and these are timed in one call.

With the kernel name ``msda`` it times ``msda_fwd`` and ``msda_bwd``
instead, at chip_smoke's decoder (B=8, Lq=100, D=16) and encoder (B=4,
Lq=6930, D=8) shapes on its incoherent inputs and at the encoder's on its
coherent one, in copies under ``build/corr_tile_bench/msda-<variant>/``:

- ``launch``: the kernels as they are, and with the forward's slots a
  group (``FWD_SLOTS``, default 4) set to 1, 2, 8 and 16 (at most a
  warp), also on the encoder's coherent input cut to a sixth and a 24th
  of its queries; the backward's blocks cut to 56 KB of shared memory
  (``BAND_BYTES``: bands of rows) and its bands never split over a
  cluster of two blocks (``sm_count`` 1);
- ``ranked``: the backward puts each pixel's slice of shares in entry
  order (an insertion sort a pixel) before summing it, so that d_value is
  bit-reproducible;
- ``no_sort``: the backward without its counting sort of the d_value
  shares (no slots, touched pixels or entries, so its shared-memory
  atomics, scan, list and sums do no work; d_value stays zero);
- ``no_dloc_daw``: the backward computes and writes no location or weight
  gradient.

``launch`` and ``ranked`` compute the function exactly; each of their rows
is held against the plain versions (``TOL``, ``CORR_BWD_REL``) and carries
the forward's slots and the backward's plan.

With ``bwd_bf16`` it times the bf16 backward, ``corr_bwd_bf16``, in its
three operand combinations (bf16 maps at mxu "float32" and "bfloat16",
float32 maps at "bfloat16"; the cotangent in the maps' dtype) by the
queued timer, at the chairs train shape (B=8, 46x62, C=256, r=4) on
coherent and incoherent flows, at Sintel (B=1, 55x128, C=256, r=4) and at
RAFT-small's lookup there (C=128, r=3) on coherent ones, in copies under
``build/corr_tile_bench/bwd_bf16-<variant>/``:

- ``tile``: the kernel as it is, each combination held against the plain
  version (chip_smoke's ``CORR_BWD_BF16_BARS`` on the float32 sums, the
  control above the 2-norm bar), and beside it on the same inputs the
  float32 ``corr_bwd``, ``corr_fwd`` and ``corr_fwd_bf16``;
- ``no_copies``: the maps staged for the first box chunk only (with F1);
- ``no_products``: the tensor-core products replaced by one add each;
- ``no_g_build``: the coefficients' block G built for the first chunk only;
- ``no_df2_atomics``, ``no_df1_atomics``, ``no_sums``: the shared path
  without its df2 (df1, both) reductions;
- ``split_c``: two blocks over 128 channels each at C=256 (two an SM, the
  sums by float4 atomics) instead of one over the whole C (one an SM, the
  sums by bulk reductions of rows staged in shared memory);
- ``red_sums``: the whole-C blocks with the sums added by the threads' own
  float4 atomics from their accumulators;
- ``no_fold_loads``: the fold without its cotangent copies;
- ``stamps``: the kernel as it is with ``clock64()`` stamps of its shared
  path's phases summed over the blocks (thread 0's clock, barriers
  included), printed as cycles a shared-path block.

With ``fwd_bf16`` it times the bf16 forward, ``corr_fwd_bf16``, in its two
operand routes (bfloat16 maps and windows, the mixed policy's; float32
maps and windows, ``corr_mxu_dtype="bfloat16"`` alone) by the queued timer
and the host's time a call (``host_us``: calls queued behind a sleep), at
Sintel (B=1, 55x128, C=256, r=4) and the chairs train shape (B=8, 46x62)
on coherent and incoherent flows and at RAFT-small's lookup (Sintel,
C=128, r=3) on coherent ones, in copies under
``build/corr_tile_bench/fwd_bf16-<variant>/``:

- ``tile``: the kernel as it is, each route held against the plain version
  (chip_smoke's bars, as every exact variant), and beside it on the same
  inputs ``corr_fwd``, ``corr_bwd`` and ``corr_bwd_bf16`` (bf16 maps, mxu
  "float32"), as for the parent;
- ``no_copies``: the ring's chunks copied for the first chunk only;
- ``no_products``: the tensor-core products replaced by one xor-add each;
- ``no_epilogue``: no dots into S (one compare keeps the sums live), no
  windows into O and no row stores;
- ``levels2``, ``levels4``: the grid with one block a tile over two of its
  levels or over all four (one an SM, O apart; all four: a tile row's
  whole rows one run), in place of one a (tile, level) (two an SM, O over
  the idle ring);
- ``stamps``: the kernel as it is with ``clock64()`` stamps of its phases
  summed over the blocks (thread 0's clock, barriers included), printed as
  cycles a block.

Run from the repository root:

    python3 scripts/corr_tile_bench.py [corr|msda|bwd_bf16|fwd_bf16] [--parent build/parent]
        [--variants tile,stamps]
"""

import argparse
import functools
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "corr_tile_bench")
RADIUS = 4

# edits of a file under raft_tpu_torch/csrc: (file, text, its replacement)
_FWD_COPY = ("        cp_async16(buf + row * kLdk + 4 * c4, src[i] + ks * kKC + 4 * c4, "
             "ok[i]);")
_BWD_COPY = "        Form::stage4(F2c + row * kLd + 4 * c16, f2 + off + c0 + 4 * c16, ok);"
_BWD_F1_COPY = ("      Form::stage4(F1c + row * kLd + 4 * c16, fmap1 + (ok ? t.q[row] * C : 0) "
                "+ c0 + 4 * c16, ok);")
_SMALL = "  mma_tf32(small, al, bh);\n  mma_tf32(small, ah, bl);\n"
_BIG = "  mma_tf32(step, ah, bh);\n"
_DF2 = "        if (pix < nb) {\n          const long long off ="
_CHOOSE = "  const bool shared = tile_width && nb <= budget;"
# an empty box (nb = 0) would take the shared path at budget 0
_WARP_SMEM = [("corr_fwd.cu", "  return kMasked ? kWarps", "  return true ? kWarps"),
              ("corr_tile.cuh", "(kMasked ? 0 : kQ * kLdg", "(true ? 0 : kQ * kLdg"),
              ("corr_tile.cuh", _CHOOSE, _CHOOSE.replace("nb <= budget", "nb > 0 && nb <= budget"))]
_DF1 = "atomicAdd(reinterpret_cast<Vec*>(df1 + q * C + ch), acc[v]);"
# variant -> (edits, budgets (None: the default), exact)
VARIANTS = {
    "tile": ([], (0, 256, 512, None, 2048, 10 ** 8), True),
    "no_copies": ([("corr_fwd.cu", _FWD_COPY, "        if (ks == 0) " + _FWD_COPY.lstrip()),
                   ("corr_tile.cuh", _BWD_COPY,
                    "        if (n0 == 0 && c0 == 0) " + _BWD_COPY.lstrip()),
                   ("corr_tile.cuh", _BWD_F1_COPY, "      if (c0 == 0) " + _BWD_F1_COPY.lstrip())],
                  (None,), False),
    "one_pass": ([("corr_tile.cuh", _SMALL, "")], (None,), False),
    "no_mma": ([("corr_tile.cuh", _SMALL, ""),
                ("corr_tile.cuh", _BIG,
                 "  step[0] = __uint_as_float(ah[0] ^ al[1] ^ ah[2] ^ al[3] ^ bh[0] ^ bl[1]);\n")],
               (None,), False),
    "no_df2_atomics": ([("corr_tile.cuh", _DF2, _DF2.replace("pix < nb", "pix < 0"))],
                       (None,), False),
    "warp_smem": (_WARP_SMEM, (0,), True),
    "warp_only": (_WARP_SMEM[:2] + [("corr_tile.cuh", _CHOOSE, "  const bool shared = false;")],
                  (0,), True),
    "no_df1_atomics": ([("corr_tile.cuh", _DF1,
                         "*reinterpret_cast<Vec*>(df1 + q * C + ch) = acc[v];")], (0,), False),
}
_MSDA_SUM = "    // 4. each (touched pixel, 4 channels) sums its slice\n"
_MSDA_RANK = """    // each slice in entry order
    for (int k = threadIdx.x; k < nt; k += kThreads) {
      const int lo = base[k];
      const int hi = k + 1 < nt ? base[k + 1] : lo + last_count;
      for (int r = lo + 1; r < hi; ++r) {
        const unsigned short e = list[r];
        int t = r;
        for (; t > lo && list[t - 1] > e; --t) list[t] = list[t - 1];
        list[t] = e;
      }
    }
    __syncthreads();
"""
_MSDA_COUNT = ("          const int k = atomicAdd(cnt + p, 1);\n"
               "          slot[i * 4 + c] = (unsigned short)k;\n"
               "          if (k == 0) touched[atomicAdd(&n_touched, 1)] = (unsigned short)p;\n")
_MSDA_ENTRY = ("          list[cnt[(y - y_lo) * w + s.x0 + (c & 1)] + slot[i * 4 + c]] =\n"
               "              (unsigned short)(i * 4 + c);\n")


def _one_sm(device):
    return 1


# variant -> (edits, settings of ops/msda_cuda.py's names ({}: the
# defaults), exact)
MSDA_VARIANTS = {
    "launch": ([], ({}, *({"FWD_SLOTS": n} for n in (1, 2, 8, 16)),
                    {"BAND_BYTES": 56 * 1024}, {"sm_count": _one_sm}), True),
    "ranked": ([("msda_bwd.cu", _MSDA_SUM, _MSDA_RANK + _MSDA_SUM)], ({},), True),
    "no_sort": ([("msda_bwd.cu", _MSDA_COUNT, "          ;\n"),
                 ("msda_bwd.cu", _MSDA_ENTRY, "          ;\n")],
                ({},), False),
    "no_dloc_daw": ([("msda_bwd.cu", "      if (oy / rows == band) {", "      if (false) {")],
                    ({},), False),
}
# the bf16 backward (csrc/corr_bwd_bf16.cu on corr_tile_bf16.cuh) with one
# part of its shared path's work changed or taken out: variant -> (edits,
# exact)
_BF16_HDR = "corr_tile_bf16.cuh"
_BF16_G = "      for (int k = 0; k < kQ / 8; ++k) {"
_BF16_MMAS = ("mma_bf16(acc2[mt][nt], a, b[nt]);", "mma_bf16(fresh[mt][nt], a, b[nt]);",
              "mma_bf16(acc1[mt][nt], a, b[nt]);")
_BF16_DF2 = "float* row = pix < nb ? d2 + pixel(pix) : nullptr;"
_BF16_DF1 = "float* row = t.q[qi] >= 0 && t.near[qi] ? df1 + t.q[qi] * C : nullptr;"
# the reductions taken out on both paths (bulk at C=256, atomics at C=128)
_NO_DF2 = [(_BF16_HDR, _BF16_DF2, "float* row = nullptr;"),
           (_BF16_HDR, "          if (wm + lane < kmax) {\n            bulk_add(",
            "          if (false) {\n            bulk_add(")]
_NO_DF1 = [(_BF16_HDR, _BF16_DF1, "float* row = nullptr;"),
           (_BF16_HDR, "if (t.q[qi] >= 0 && t.near[qi]) bulk_add(", "if (false) bulk_add(")]
# the stamps variant: block-summed clock64() cycles of the shared path's
# phases (thread 0's clock, barriers included), in path_counts after the
# bwd pair: the block's, then each chunk's
STAMPS = ("tile and box", "chunk 0 issued", "fold", "chunks and df1 atomics",
          "next copies issued", "G build", "wait and barrier", "df2 products", "df2 atomics",
          "df1 products", "end barrier", "cotangent and F1 loads issued")
_STAMP = ("  if (shared && threadIdx.x == 0) {{ const long long now = clock64(); "
          "atomicAdd(path_counts + 2 + {0}, (Count)(now - st)); st = now; }}\n")
_CHUNK_STAMP = ("    if (threadIdx.x == 0) {{ const long long now = clock64(); "
                "atomicAdd(path_counts + 2 + {0}, (Count)(now - st)); st = now; }}\n")
# (anchor, stamp before it, stamp after it) in the chunk loop
_CHUNK_AT = (("    cp_async_commit();\n    // G: the coefficient", None, None),
             ("    cp_async_wait<1>();\n", 5, None),
             ("    __syncthreads();  // G and this chunk's stage (and F1) in place for every "
              "thread\n", None, 6),
             ("        if constexpr (kBulkSums<CB>) {\n          // the warp's 32 x WN block", 7, None),
             ("    if (n + 1 < chunks) {  // a float32 map's next chunk", 8, None),
             ("    __syncthreads();  // G and this stage are rewritten by the next chunks\n", 9, 10))


def _stamped(at, before, after):
    """A stamp edit of the chunk loop (the first anchor splits its text)."""
    if before is None and after is None:
        head, tail = at.split("\n", 1)
        return (_BF16_HDR, at, head + "\n" + _CHUNK_STAMP.format(4) + tail)
    return (_BF16_HDR, at, (_CHUNK_STAMP.format(before) if before is not None else "") + at
            + (_CHUNK_STAMP.format(after) if after is not None else ""))


BWD_BF16_VARIANTS = {
    "tile": ([], True),
    "no_copies": ([(_BF16_HDR, "    Piece<M> pieces[Rw::kCopies];\n    if (n + 1 < chunks) {",
                    "    Piece<M> pieces[Rw::kCopies];\n    if (false) {")], False),
    "no_products": ([(_BF16_HDR, mma, mma[len("mma_bf16("):mma.index(",")]
                      + "[0] += __uint_as_float(a[0] ^ a[3] ^ b[nt][0] ^ b[nt][1]);")
                     for mma in _BF16_MMAS], False),
    "no_g_build": ([(_BF16_HDR, _BF16_G, _BF16_G.replace("k < kQ / 8", "k < (n == 0 ? kQ / 8 : 0)"))],
                   False),
    "no_df2_atomics": (_NO_DF2, False),
    "no_df1_atomics": (_NO_DF1, False),
    "no_sums": (_NO_DF2 + _NO_DF1, False),
    "split_c": ([(_BF16_HDR, "constexpr int kMaxBlockC = 256;", "constexpr int kMaxBlockC = 128;")],
                True),
    "red_sums": ([(_BF16_HDR, "constexpr bool kBulkSums = CB == 256;",
                   "constexpr bool kBulkSums = false;")], True),
    "no_fold_loads": ([(_BF16_HDR, "      cp_async4(gs + idx, reinterpret_cast<const char*>(grad) + at, "
                                   "(int)min(4LL, end - at));", "      ;")], False),
    "stamps": ([("../ops/corr_cuda.py", "torch.zeros(4, dtype=torch.int64",
                 "torch.zeros(16, dtype=torch.int64"),
                (_BF16_HDR, "  __shared__ TileQueries t;\n",
                 "  __shared__ TileQueries t;\n  long long st = clock64();\n")]
               + [(_BF16_HDR, at, at + _STAMP.format(k)) for k, at in enumerate((
                   "  if (c0 == 0 && threadIdx.x == 0) atomicAdd(path_counts + (shared ? 0 : 1), "
                   "1ULL);\n",
                   "    cp_async_commit();  // F1 and chunk 0\n  }\n",
                   "    fold<R>(t, static_cast<const float*>(grad), num_levels, l, inv_scale, gs, coef);"
                   "\n  }\n",
                   "coef, df1 + c0, F1);\n"))]
               + [(_BF16_HDR, "  if (rescale) {\n    load_tile<R, true>",
                   _STAMP.replace("shared && ", "").format(11)
                   + "  if (rescale) {\n    load_tile<R, true>")]
               + [(_BF16_HDR, "float* __restrict__ df1, bf16* F1) {",
                   "float* __restrict__ df1, bf16* F1, Count* path_counts) {"),
                  (_BF16_HDR, "coef, df1 + c0, F1);", "coef, df1 + c0, F1, path_counts);"),
                  (_BF16_HDR, "  const int chunks = (nb + kChunk - 1) / kChunk;",
                   "  long long st = clock64();\n  const int chunks = (nb + kChunk - 1) / kChunk;")]
               + [_stamped(*at) for at in _CHUNK_AT],
               True),
}
# the bf16 forward (csrc/corr_fwd_bf16.cu) with one part of its work
# changed or taken out, or another grid: variant -> (edits, exact)
_FWD_HDR = "corr_fwd_bf16.cu"
_FWD_MMAS = ("mma_bf16(acc[2 * np], a[s], b);", "mma_bf16(acc[2 * np + 1], a[s], b + 2);")
_FWD_FETCH = ("          pieces[i].fetch(dst + row * LD + col, f2 + (ok ? ((long long)y * w2 + x) * C "
              ": 0), ok);")
_FWD_LEVELS = "constexpr int kLevelsPerBlock = 1;"
# the stamps variant: block-summed clock64() cycles of the kernel's phases
# (thread 0's clock, barriers included), in path_counts[4..12], the blocks
# in path_counts[15]
FWD_STAMPS = ("set-up: F1 issued, centres and boxes", "first chunks issued", "wait and barrier",
              "next chunk issued", "products", "dots into S (f32 maps: rows stored)",
              "level windows into O", "warp path (dots and windows)", "row stores")
FWD_BF16_VARIANTS = {
    "tile": ([], True),
    "no_copies": ([(_FWD_HDR, _FWD_FETCH, "        if (c_li + c_n0 == 0)\n  " + _FWD_FETCH)],
                  False),
    "no_products": ([(_FWD_HDR, mma, mma[len("mma_bf16("):mma.index("],") + 1]
                      + "[0] += __uint_as_float(a[s][0] ^ b[" + ("2" if "b + 2" in mma else "0")
                      + "]);") for mma in _FWD_MMAS], False),
    "no_epilogue": ([(_FWD_HDR, "              if ((unsigned)i < D && (unsigned)j < D) {",
                      "              if (acc[nt][2 * e2 + e1] == 1.2345e-30f && i == j) {"),
                     (_FWD_HDR, "      if (t[li].q[qi] >= 0) {\n        window_column<R>(",
                      "      if (false) {\n        window_column<R>("),
                     (_FWD_HDR, "      M* g = out + O.out_first(u);",
                      "      continue;\n      M* g = out + O.out_first(u);")],
                    False),
    "levels2": ([(_FWD_HDR, _FWD_LEVELS, "constexpr int kLevelsPerBlock = 2;")], True),
    "levels4": ([(_FWD_HDR, _FWD_LEVELS, "constexpr int kLevelsPerBlock = 4;")], True),
    "stamps": ([("../ops/corr_cuda.py", "torch.zeros(4, dtype=torch.int64",
                 "torch.zeros(16, dtype=torch.int64"),
                (_FWD_HDR, "constexpr bool kStamps = false;", "constexpr bool kStamps = true;")],
               True),
}
TABLES = {"corr": VARIANTS, "msda": MSDA_VARIANTS, "bwd_bf16": BWD_BF16_VARIANTS,
          "fwd_bf16": FWD_BF16_VARIANTS}


def variant_tree(kernel, name):
    """A copy of this tree's raft_tpu_torch with variant ``name``'s edits."""
    root = os.path.join(OUT, name if kernel == "corr" else f"{kernel}-{name}")
    pkg = os.path.join(root, "raft_tpu_torch")
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "raft_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in TABLES[kernel][name][0]:
        path = os.path.join(pkg, "csrc", fname)
        text = open(path).read()
        if old not in text:
            sys.exit(f"corr_tile_bench: {name}: {fname} no longer has {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def load_smoke():
    """chip_smoke.py of this tree (its inputs, bars and timer)."""
    spec = importlib.util.spec_from_file_location(
        "corr_bench_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(torch, smoke, corr, sampling):
    """(label, flow, f1, pyramid, coords, rescale) of every timed lookup."""
    rng = np.random.default_rng(0)
    for label, b, h, w, flows in smoke.lookup_cases({"sintel": (55, 128)}):
        for flow, max_px in flows.items():
            f1, pyr, coords = smoke.corr_inputs(torch, sampling, corr, rng, h, w,
                                                flow=flow, b=b, max_px=max_px)
            yield f"{label} B={b} {h}x{w} C=256", flow, f1, pyr, coords, True
    for c, (h, w) in zip((128, 192, 256), smoke.SPARSE_LEVELS[:3]):
        f1, pyr, centers = smoke.sparse_corr_inputs(torch, rng, smoke.SPARSE_RUNS[0][1],
                                                    h, w, c)
        yield (f"fork B={smoke.SPARSE_RUNS[0][1]} {h}x{w} C={c}", "half-pixel centres",
               f1, pyr, centers, False)


def run_variant(name):
    """Time (and, for an exact variant, check) variant ``name``, whose tree
    is on sys.path."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("corr_tile_bench: no CUDA device")
    smoke = load_smoke()
    from raft_tpu_torch.models import corr
    from raft_tpu_torch.ops import build, corr_cuda, sampling

    _, budgets, exact = VARIANTS.get(name, ((), (None,), True))
    tiled = hasattr(corr_cuda, "TILE_BUDGET")  # the parent commit's kernels have one path
    print(smoke.card_line())
    paths = build.build(("corr_fwd", "corr_bwd"))
    for lib, path in paths.items():
        with open(path + ".log") as f:
            print(f"{lib}: " + " | ".join(ln.strip() for ln in f
                                         if "registers" in ln or "spill" in ln))
    default = getattr(corr_cuda, "TILE_BUDGET", None)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for label, flow, f1, pyr, coords, rescale in cases(torch, smoke, corr, sampling):
        g = torch.randn(*coords.shape[:3], len(pyr) * (2 * RADIUS + 1) ** 2,
                        device="cuda")
        fwd = functools.partial(corr_cuda.windowed_correlation_cuda, f1, pyr, coords,
                                RADIUS, rescale=rescale)
        bwd = functools.partial(corr_cuda.windowed_correlation_bwd_cuda, f1, pyr, coords,
                                g, RADIUS, rescale=rescale)
        if exact:
            with torch.inference_mode():
                want = corr_cuda.windowed_correlation_fused_plain(
                    f1, pyr, coords, RADIUS, rescale=rescale)
            want_d = corr_cuda.windowed_correlation_bwd_plain(
                f1, pyr, coords, g, RADIUS, rescale=rescale)
        for budget in budgets:
            if tiled:
                corr_cuda.TILE_BUDGET = default if budget is None else budget
                corr_cuda.reset_path_counts()
            with torch.inference_mode():
                got = fwd()
            got_d = bwd()
            torch.cuda.synchronize()
            row = {"variant": name, "shape": label, "flow": flow,
                   "budget": corr_cuda.TILE_BUDGET if tiled else None}
            if tiled:
                shares = corr_cuda.path_counts()
                row["blocks"] = sum(shares["fwd"])
                row["fwd_shared"] = smoke.shared_share(shares["fwd"])
                row["bwd_shared"] = smoke.shared_share(shares["bwd"])
            if exact:
                row["fwd_err"] = float((got - want).abs().max())
                row["bwd_rel"] = max(float((a - b).abs().max()) / float(b.abs().max())
                                     for a, b in zip((got_d[0], *got_d[1]),
                                                     (want_d[0], *want_d[1])))
                worst["fwd"] = max(worst["fwd"], row["fwd_err"])
                worst["bwd"] = max(worst["bwd"], row["bwd_rel"])
            with torch.inference_mode():
                row["fwd_ms"] = smoke.time_ms(torch, fwd)
                row["fwd_ms_queued"] = smoke.queued_ms(torch, fwd)
            row["bwd_ms"] = smoke.time_ms(torch, bwd)
            row["bwd_ms_queued"] = smoke.queued_ms(torch, bwd)
            print(json.dumps(row), flush=True)
    if tiled:
        corr_cuda.TILE_BUDGET = default
    print(smoke.card_line())
    if exact:
        print(json.dumps({"variant": name, "worst_fwd_err": worst["fwd"],
                          "worst_bwd_rel": worst["bwd"], "tol": smoke.TOL,
                          "bwd_rel_bar": smoke.CORR_BWD_REL}))
        if not (worst["fwd"] <= smoke.TOL and worst["bwd"] <= smoke.CORR_BWD_REL):
            raise SystemExit(f"corr_tile_bench: {name} disagrees with the plain version")


def bwd_bf16_cases(torch, smoke, corr, sampling):
    """(label, radius, f1, pyramid, coords) of every timed bf16 backward:
    the chairs train shape (B=8, 46x62, C=256, r=4) on coherent and
    incoherent flows, Sintel (B=1, 55x128, C=256, r=4) and RAFT-small's
    lookup there (C=128, r=3) on coherent ones; float32 maps."""
    rng = np.random.default_rng(0)
    chairs = (smoke.TRAIN_B, smoke.TRAIN_HW[0] // 8, smoke.TRAIN_HW[1] // 8)
    for label, (b, h, w), c, r, flow, max_px in (
            ("chairs", chairs, 256, 4, "coherent", smoke.CORR_FLOWS["chairs"]["coherent"]),
            ("chairs", chairs, 256, 4, "incoherent",
             smoke.CORR_FLOWS["chairs"]["incoherent"]),
            ("sintel", (1, 55, 128), 256, 4, "coherent",
             smoke.CORR_FLOWS["sintel"]["coherent"]),
            ("sintel r=3", (1, 55, 128), smoke.SMALL_C, 3, "coherent",
             smoke.CORR_FLOWS["sintel"]["coherent"])):
        f1, pyr, coords = smoke.corr_inputs(torch, sampling, corr, rng, h, w, c=c, flow=flow,
                                            b=b, max_px=max_px)
        yield f"{label} {flow} B={b} {h}x{w} C={c} r={r}", r, f1, pyr, coords


def run_bwd_bf16_variant(name):
    """Time variant ``name`` of the bf16 backward (whose tree is on
    sys.path) in its three operand combinations, queued; the exact variant
    (and the parent) also checked against the plain version
    (chip_smoke's CORR_BWD_BF16_BARS on the float32 sums, with the control
    at the other mxu_dtype above the 2-norm bar), beside the float32
    backward and the two forwards on the same inputs."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("corr_tile_bench: no CUDA device")
    smoke = load_smoke()
    from raft_tpu_torch.models import corr
    from raft_tpu_torch.ops import build, corr_cuda, sampling

    exact = BWD_BF16_VARIANTS.get(name, ((), True))[1]
    print(smoke.card_line())
    libs = ("corr_bwd_bf16", "corr_bwd", "corr_fwd", "corr_fwd_bf16") if exact \
        else ("corr_bwd_bf16",)
    paths = build.build(libs)
    for lib, path in paths.items():
        with open(path + ".log") as f:
            print(f"{lib}: " + " | ".join(ln.strip() for ln in f
                                         if "registers" in ln or "spill" in ln))
    problems = []

    def rel(got, want, norm=False):
        pairs = zip((got[0], *got[1]), (want[0], *want[1]))
        if norm:
            return max(float((a.float() - b.float()).norm() / b.float().norm())
                       for a, b in pairs)
        return max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                   for a, b in pairs)

    for label, r, f1, pyr, coords in bwd_bf16_cases(torch, smoke, corr, sampling):
        g = torch.randn(*coords.shape[:3], len(pyr) * (2 * r + 1) ** 2, device="cuda")
        for maps, mxu in smoke.BF16_BWD_COMBOS:
            dt = getattr(torch, maps)
            f1m, pyrm, gm = f1.to(dt), tuple(p.to(dt) for p in pyr), g.to(dt)
            run = functools.partial(corr_cuda.windowed_correlation_bwd_bf16_cuda, f1m, pyrm,
                                    coords, gm, r, mxu_dtype=mxu)
            row = {"variant": name, "kernel": "corr_bwd_bf16", "shape": label,
                   "maps": maps, "mxu": mxu}
            if exact:
                got = corr_cuda.windowed_correlation_bwd_bf16_cuda(
                    f1m, pyrm, coords, gm, r, mxu_dtype=mxu, out_dtype=torch.float32)
                f1f, pyrf = f1m.float(), tuple(p.float() for p in pyrm)
                other = "float32" if mxu == "bfloat16" else "bfloat16"
                want = corr_cuda.windowed_correlation_bwd_plain(f1f, pyrf, coords, gm, r,
                                                                mxu_dtype=mxu)
                ctrl = corr_cuda.windowed_correlation_bwd_plain(f1f, pyrf, coords, gm, r,
                                                                mxu_dtype=other)
                bars = smoke.CORR_BWD_BF16_BARS[(maps, mxu)]
                row.update(sums=rel(got, want), norm=rel(got, want, norm=True),
                           control=rel(got, ctrl, norm=True), bars=bars)
                if not (row["sums"] <= bars[0] and row["norm"] <= bars[1] < row["control"]):
                    problems.append(f"{label} {maps}/{mxu}")
            if name == "stamps":
                corr_cuda.reset_path_counts()
                run()
                counts = corr_cuda._counts(f1.device).tolist()
                row["cycles_a_block"] = {k: c / max(1, counts[2]) for k, c in
                                         zip(STAMPS, counts[4:])}
            row["ms_q"] = smoke.queued_ms(torch, run)
            print(json.dumps(row), flush=True)
        if not exact:
            continue
        timed = [("corr_bwd", functools.partial(corr_cuda.windowed_correlation_bwd_cuda,
                                                f1, pyr, coords, g, r)),
                 ("corr_fwd", functools.partial(corr_cuda.windowed_correlation_cuda,
                                                f1, pyr, coords, r))]
        if f1.shape[-1] in corr_cuda.BF16_CHANNELS:
            f1b, pyrb = f1.bfloat16(), tuple(p.bfloat16() for p in pyr)
            timed.append(("corr_fwd_bf16", functools.partial(
                corr_cuda.windowed_correlation_bf16_cuda, f1b, pyrb, coords, r,
                out_dtype=torch.bfloat16)))
        for kernel, run in timed:
            with torch.inference_mode():
                print(json.dumps({"variant": name, "kernel": kernel, "shape": label,
                                  "ms_q": smoke.queued_ms(torch, run)}), flush=True)
    print(smoke.card_line())
    if problems:
        raise SystemExit("corr_tile_bench: corr_bwd_bf16 disagrees with the plain version "
                         "at " + "; ".join(problems))


def fwd_bf16_cases(torch, smoke, corr, sampling):
    """(label, radius, f1, pyramid, coords) of every timed bf16 forward:
    Sintel (B=1, 55x128, C=256, r=4) and the chairs train shape (B=8,
    46x62) on coherent and incoherent flows, and RAFT-small's lookup at
    Sintel (C=128, r=3) on coherent ones; float32 maps."""
    rng = np.random.default_rng(0)
    chairs = (smoke.TRAIN_B, smoke.TRAIN_HW[0] // 8, smoke.TRAIN_HW[1] // 8)
    flows = smoke.CORR_FLOWS
    for label, (b, h, w), c, r, flow, max_px in (
            ("sintel", (1, 55, 128), 256, 4, "coherent", flows["sintel"]["coherent"]),
            ("sintel", (1, 55, 128), 256, 4, "incoherent", flows["sintel"]["incoherent"]),
            ("chairs", chairs, 256, 4, "coherent", flows["chairs"]["coherent"]),
            ("chairs", chairs, 256, 4, "incoherent", flows["chairs"]["incoherent"]),
            ("sintel r=3", (1, 55, 128), smoke.SMALL_C, 3, "coherent",
             flows["sintel"]["coherent"])):
        f1, pyr, coords = smoke.corr_inputs(torch, sampling, corr, rng, h, w, c=c, flow=flow,
                                            b=b, max_px=max_px)
        yield f"{label} {flow} B={b} {h}x{w} C={c} r={r}", r, f1, pyr, coords


def host_us(torch, smoke, fn, n=30, repeats=5):
    """The host's time a call of ``fn`` in microseconds: ``n`` calls queued
    behind a sleep on the stream, so that none waits for the card; the
    median of ``repeats`` such runs."""
    for _ in range(3):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda._sleep(smoke.QUEUE_CYCLES)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append(1e6 * (time.perf_counter() - t0) / n)
    torch.cuda.synchronize()
    return sorted(runs)[repeats // 2]


def run_fwd_bf16_variant(name):
    """Time variant ``name`` of the bf16 forward (whose tree is on sys.path)
    in its two operand routes (bfloat16 maps and windows; float32 maps and
    windows), queued, with the host's time a call; an exact variant (and
    the parent) checked against the plain version at chip_smoke's bars (1
    bf16 eps of max(1, max|plain|) for bfloat16 windows, TOL for float32
    ones), beside corr_fwd, corr_bwd and corr_bwd_bf16 on the same
    inputs."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("corr_tile_bench: no CUDA device")
    smoke = load_smoke()
    from raft_tpu_torch.models import corr
    from raft_tpu_torch.ops import build, corr_cuda, sampling

    exact = FWD_BF16_VARIANTS.get(name, ((), True))[1]
    beside = name in ("tile", "parent")   # the other corr kernels timed too
    print(smoke.card_line())
    libs = ("corr_fwd_bf16", "corr_fwd", "corr_bwd", "corr_bwd_bf16") if beside \
        else ("corr_fwd_bf16",)
    paths = build.build(libs)
    for lib, path in paths.items():
        with open(path + ".log") as f:
            print(f"{lib}: " + " | ".join(ln.strip() for ln in f
                                         if "registers" in ln or "spill" in ln))
    problems = []
    for label, r, f1, pyr, coords in fwd_bf16_cases(torch, smoke, corr, sampling):
        for maps in ("bfloat16", "float32"):
            dt = getattr(torch, maps)
            f1m, pyrm = f1.to(dt), tuple(p.to(dt) for p in pyr)
            run = functools.partial(corr_cuda.windowed_correlation_bf16_cuda, f1m, pyrm,
                                    coords, r, out_dtype=dt)
            row = {"variant": name, "kernel": "corr_fwd_bf16", "shape": label, "maps": maps}
            with torch.inference_mode():
                corr_cuda.reset_path_counts()
                got = run()
                counts = corr_cuda._counts(f1.device).tolist()
                row["blocks"] = counts[0] + counts[1]
                row["shared_share"] = smoke.shared_share(counts[:2])
                if exact:
                    want = corr_cuda.windowed_correlation_fused_plain(
                        f1m, pyrm, coords, r, mxu_dtype="bfloat16", out_dtype=dt).float()
                    top = float(want.abs().max())
                    bar = (smoke.BF16_EPS if maps == "bfloat16" else smoke.TOL) * max(1.0, top)
                    row.update(err=float((got.float() - want).abs().max()), bar=bar)
                    if not (row["err"] <= bar and got.dtype == dt):
                        problems.append(f"{label} {maps}")
                if name == "stamps":
                    cycles = counts[4:4 + len(FWD_STAMPS)]
                    row["cycles_a_block"] = {k: c / max(1, counts[15])
                                             for k, c in zip(FWD_STAMPS, cycles)}
                row["ms_q"] = smoke.queued_ms(torch, run)
                row["host_us"] = host_us(torch, smoke, run)
            print(json.dumps(row), flush=True)
        if not beside:
            continue
        g = torch.randn(*coords.shape[:3], len(pyr) * (2 * r + 1) ** 2, device="cuda")
        f1b, pyrb = f1.bfloat16(), tuple(p.bfloat16() for p in pyr)
        timed = [("corr_fwd", functools.partial(corr_cuda.windowed_correlation_cuda,
                                                f1, pyr, coords, r)),
                 ("corr_bwd", functools.partial(corr_cuda.windowed_correlation_bwd_cuda,
                                                f1, pyr, coords, g, r)),
                 ("corr_bwd_bf16", functools.partial(
                     corr_cuda.windowed_correlation_bwd_bf16_cuda, f1b, pyrb, coords,
                     g.bfloat16(), r, mxu_dtype="float32"))]
        for kernel, run in timed:
            with torch.inference_mode():
                print(json.dumps({"variant": name, "kernel": kernel, "shape": label,
                                  "ms_q": smoke.queued_ms(torch, run)}), flush=True)
    print(smoke.card_line())
    if problems:
        raise SystemExit("corr_tile_bench: corr_fwd_bf16 disagrees with the plain version "
                         "at " + "; ".join(problems))


def msda_cases(torch, smoke, fewer=False):
    """(label, value, loc, aw, cotangent) of every timed MSDA input; with
    ``fewer`` also the encoder's coherent input cut to a sixth and a 24th
    of its queries, between the decoder's and the encoder's launch
    sizes."""
    rng = np.random.default_rng(0)
    dec = (smoke.SPARSE_RUNS[0][1], 100, 16)
    s = sum(h * w for h, w in smoke.SPARSE_LEVELS)
    enc = (smoke.SPARSE_RUNS[1][1], s, 8)
    cases = [("decoder", dec, False), ("encoder", enc, False), ("encoder", enc, True)]
    if fewer:
        cases += [("fewer", (enc[0], s // n, 8), True) for n in (6, 24)]
    for label, (b, lq, d), coherent in cases:
        if coherent:
            value, loc, aw = smoke.msda_coherent_inputs(torch, rng, b, d)
            loc, aw = loc[:, :lq].contiguous(), aw[:, :lq].contiguous()
        else:
            value, loc, aw = smoke.msda_inputs(torch, rng, b, lq, d)
        g = torch.randn(b, lq, 8 * d, device="cuda")
        yield (f"{label} {'coherent' if coherent else 'incoherent'} B={b} Lq={lq} "
               f"M=8 D={d} L=6 P=4", value, loc, aw, g)


def run_msda_variant(name):
    """Time (and, for an exact variant, check) MSDA variant ``name``, whose
    tree is on sys.path."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("corr_tile_bench: no CUDA device")
    smoke = load_smoke()
    from raft_tpu_torch.ops import build, msda, msda_cuda

    _, settings, exact = MSDA_VARIANTS.get(name, ((), ({},), True))
    planned = hasattr(msda_cuda, "plan")  # the parent commit's kernels have no plan
    print(smoke.card_line())
    paths = build.build(("msda_fwd", "msda_bwd"))
    for lib, path in paths.items():
        with open(path + ".log") as f:
            print(f"{lib}: " + " | ".join(ln.strip() for ln in f
                                         if "registers" in ln or "spill" in ln))
    defaults = {k: getattr(msda_cuda, k) for k in
                ("FWD_SLOTS", "BAND_BYTES", "sm_count") if planned}
    worst = {"fwd": 0.0, "bwd": 0.0}
    levels = smoke.SPARSE_LEVELS
    for label, value, loc, aw, g in msda_cases(torch, smoke, fewer=name == "launch"):
        fwd = functools.partial(msda_cuda.ms_deform_attn_cuda, value, levels, loc, aw)
        bwd = functools.partial(msda_cuda.ms_deform_attn_bwd_cuda, value, levels, loc,
                                aw, g)
        if exact:
            with torch.inference_mode():
                want = msda.ms_deform_attn_plain(value, levels, loc, aw)
            want_d = msda.ms_deform_attn_bwd_plain(value, levels, loc, aw, g)
        for setting in settings if planned else ({},):
            for k, v in {**defaults, **setting}.items():
                setattr(msda_cuda, k, v)
            row = {"variant": name, "input": label,
                   "setting": {k: v if isinstance(v, (int, float)) else v.__name__
                               for k, v in setting.items()}}
            if planned:
                row["fwd_slots"] = msda_cuda.fwd_slots(value.shape[-1])
                row["plan"] = msda_cuda.plan(levels, value.shape[0], loc.shape[1], 8, 4,
                                             value.shape[-1],
                                             msda_cuda.sm_count(value.device))
            with torch.inference_mode():
                got = fwd()
            got_d = bwd()
            torch.cuda.synchronize()
            if exact:
                row["fwd_err"] = float((got - want).abs().max())
                row["bwd_rel"] = max(float((a - b).abs().max()) / float(b.abs().max())
                                     for a, b in zip(got_d, want_d))
                worst["fwd"] = max(worst["fwd"], row["fwd_err"])
                worst["bwd"] = max(worst["bwd"], row["bwd_rel"])
            with torch.inference_mode():
                row["fwd_ms"] = smoke.time_ms(torch, fwd)
                row["fwd_ms_queued"] = smoke.queued_ms(torch, fwd)
            row["bwd_ms"] = smoke.time_ms(torch, bwd)
            row["bwd_ms_queued"] = smoke.queued_ms(torch, bwd)
            print(json.dumps(row), flush=True)
    for k, v in defaults.items():
        setattr(msda_cuda, k, v)
    print(smoke.card_line())
    if exact:
        print(json.dumps({"variant": name, "worst_fwd_err": worst["fwd"],
                          "worst_bwd_rel": worst["bwd"], "tol": smoke.TOL,
                          "bwd_rel_bar": smoke.CORR_BWD_REL}))
        if not (worst["fwd"] <= smoke.TOL and worst["bwd"] <= smoke.CORR_BWD_REL):
            raise SystemExit(f"corr_tile_bench: msda {name} disagrees with the plain "
                             f"version")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", nargs="?", choices=tuple(TABLES), default="corr",
                    help="the kernels to time: the corr pair (default), the MSDA pair, "
                         "the bf16 corr backward or the bf16 corr forward")
    ap.add_argument("--parent", metavar="DIR",
                    help="the parent commit's tree (git archive), whose kernels are "
                         "timed and checked first, on the same inputs")
    ap.add_argument("--variants", metavar="A,B",
                    help="only these variants (comma-separated; default: all)")
    ap.add_argument("--child", nargs=2, metavar=("NAME", "TREE"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, os.path.abspath(args.child[1]))
        {"corr": run_variant, "msda": run_msda_variant, "bwd_bf16": run_bwd_bf16_variant,
         "fwd_bf16": run_fwd_bf16_variant}[args.kernel](args.child[0])
        return
    runs = [("parent", args.parent)] if args.parent else []
    names = args.variants.split(",") if args.variants else list(TABLES[args.kernel])
    unknown = set(names) - set(TABLES[args.kernel])
    if unknown:
        ap.error(f"unknown variants: {', '.join(sorted(unknown))}")
    runs += [(name, variant_tree(args.kernel, name)) for name in names]
    failed = []
    for name, tree in runs:
        print(f"variant {name}", flush=True)
        run = subprocess.run([sys.executable, os.path.abspath(__file__), args.kernel,
                              "--child", name, tree],
                             text=True, capture_output=True)
        print(run.stdout + run.stderr, flush=True)
        if run.returncode:
            failed.append(name)
    if failed:
        raise SystemExit(f"corr_tile_bench: failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()
