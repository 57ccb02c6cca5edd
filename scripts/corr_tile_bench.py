#!/usr/bin/env python3
"""What holds the port's windowed-correlation kernels back, on one CUDA
card: their time by variant, budget and input.

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

Each time is taken twice: by ``time_ms``, whose events may also hold the
host's time in the wrapper when the card runs ahead of it (a kernel
shorter than the wrapper's Python), and by ``queued_ms``, which first
queues a ``torch.cuda._sleep`` of about 10 ms so that every timed launch
waits in the stream and its events hold the kernel alone.

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

Run from the repository root:

    python3 scripts/corr_tile_bench.py [--parent build/parent]
"""

import argparse
import functools
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "corr_tile_bench")
RADIUS = 4

# edits of a file under raft_tpu_torch/csrc: (file, text, its replacement)
_FWD_COPY = ("        cp_async16(buf + row * kLdk + 4 * c4, src[i] + ks * kKC + 4 * c4, "
             "ok[i]);")
_BWD_COPY = "        cp_async16(F2c + row * kLd + 4 * c16, f2 + off + c0 + 4 * c16, ok);"
_BWD_F1_COPY = ("      cp_async16(F1c + row * kLd + 4 * c16, fmap1 + (ok ? t.q[row] * C : 0) "
                "+ c0 + 4 * c16, ok);")
_SMALL = "  mma_tf32(small, al, bh);\n  mma_tf32(small, ah, bl);\n"
_BIG = "  mma_tf32(step, ah, bh);\n"
_DF2 = "        if (pix < nb) {\n          const long long off ="
_CHOOSE = "  const bool shared = tile_width && nb <= budget;"
# an empty box (nb = 0) would take the shared path at budget 0
_WARP_SMEM = [("corr_fwd.cu", "  return kMasked ? kWarps", "  return true ? kWarps"),
              ("corr_bwd.cu", "(kMasked ? 0 : kQ * kLdg", "(true ? 0 : kQ * kLdg"),
              ("corr_tile.cuh", _CHOOSE, _CHOOSE.replace("nb <= budget", "nb > 0 && nb <= budget"))]
_DF1 = "atomicAdd(out + lane + 32 * v, acc[v]);"
# variant -> (edits, budgets (None: the default), exact)
VARIANTS = {
    "tile": ([], (0, 256, 512, None, 2048, 10 ** 8), True),
    "no_copies": ([("corr_fwd.cu", _FWD_COPY, "        if (ks == 0) " + _FWD_COPY.lstrip()),
                   ("corr_bwd.cu", _BWD_COPY,
                    "        if (n0 == 0 && c0 == 0) " + _BWD_COPY.lstrip()),
                   ("corr_bwd.cu", _BWD_F1_COPY, "      if (c0 == 0) " + _BWD_F1_COPY.lstrip())],
                  (None,), False),
    "one_pass": ([("corr_tile.cuh", _SMALL, "")], (None,), False),
    "no_mma": ([("corr_tile.cuh", _SMALL, ""),
                ("corr_tile.cuh", _BIG,
                 "  step[0] = __uint_as_float(ah[0] ^ al[1] ^ ah[2] ^ al[3] ^ bh[0] ^ bl[1]);\n")],
               (None,), False),
    "no_df2_atomics": ([("corr_bwd.cu", _DF2, _DF2.replace("pix < nb", "pix < 0"))],
                       (None,), False),
    "warp_smem": (_WARP_SMEM, (0,), True),
    "warp_only": (_WARP_SMEM[:2] + [("corr_tile.cuh", _CHOOSE, "  const bool shared = false;")],
                  (0,), True),
    "no_df1_atomics": ([("corr_bwd.cu", _DF1, "out[lane + 32 * v] = acc[v];")], (0,), False),
}
# cycles of torch.cuda._sleep ahead of queued_ms's launches: about 10 ms,
# longer than the host takes to queue 30 launches of a wrapper
QUEUE_CYCLES = 20_000_000


def variant_tree(name):
    """A copy of this tree's raft_tpu_torch with variant ``name``'s edits."""
    root = os.path.join(OUT, name)
    pkg = os.path.join(root, "raft_tpu_torch")
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "raft_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in VARIANTS[name][0]:
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


def queued_ms(torch, fn, n=30):
    """Median over ``n`` calls of ``fn`` between two CUDA events, queued
    behind a sleep on the stream, so that the card never waits for the
    host between them."""
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


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
                row["fwd_ms_queued"] = queued_ms(torch, fwd)
            row["bwd_ms"] = smoke.time_ms(torch, bwd)
            row["bwd_ms_queued"] = queued_ms(torch, bwd)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="the parent commit's tree (git archive), whose kernels are "
                         "timed and checked first, on the same inputs")
    ap.add_argument("--child", nargs=2, metavar=("NAME", "TREE"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, os.path.abspath(args.child[1]))
        run_variant(args.child[0])
        return
    runs = [("parent", args.parent)] if args.parent else []
    runs += [(name, variant_tree(name)) for name in VARIANTS]
    failed = []
    for name, tree in runs:
        print(f"variant {name}", flush=True)
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", name, tree],
                             text=True, capture_output=True)
        print(run.stdout + run.stderr, flush=True)
        if run.returncode:
            failed.append(name)
    if failed:
        raise SystemExit(f"corr_tile_bench: failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()
