#!/usr/bin/env python3
"""Smoke run of the PyTorch port (raft_tpu_torch) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's eight CUDA kernel sources from
``raft_tpu_torch/csrc`` (one ``nvcc`` each, all at once), holds each
kernel against its plain PyTorch version at the golden and Sintel feature
shapes (the GRU with x whole and
as parts, the step kernel at both depths, the corr backward against
autograd through the plain lookup) and at the sparse family's shapes (the
corr forward and backward at its fork lookup, C = 128, 192 and 256 with no
per-level rescale; ``msda_fwd`` and ``msda_bwd`` at the decoder's and the
dense encoder's shapes), checks RAFT-large against the committed goldens
through three routes (on-demand correlation with the step kernel, with the
motion and GRU kernels, and the all-pairs engine), serves five Sintel-size
pairs (436x1024, iters=32) on the default path and two on the
``update_impl="chain"`` path through the port's ``FlowPredictor``, checks
RAFT-small against its goldens through the corr kernel at radius 3 (corr_fwd
and corr_bwd are first held against their plain versions at r=3, C=128 on
both forced paths), serves it five Sintel-size pairs and times its lookup
(r=3, C=128, 55x128) on coherent and incoherent flows, runs RAFT's serving
entry points on RAFT-large at the Sintel shape (early exit at B=2 at
bench.py's (0.1, 2) and at a tol where the two samples exit at different
iterations, ``iters_used`` against the plain run's update norms and each
sample against the plain run to its ``iters_used``; a stream of one cold
pair and four warm frames through ``encode_dispatch`` and
``refine_dispatch``, held against the pair call with the same
``flow_init``, one warm frame profiled; a 4-slot step-granular table with
requests at iters 12 and 32 admitted at different chunks, each against
``dispatch_batch(iters=k)``; in the early-exit and step phases corr_fwd
and update_step at both depths held against their plain versions on the
phase's own state at B=2 and B=4), printing each of these phases' wall
seconds, serves
SparseRAFT at full OursConfig widths through ``load_predictor("random",
model_family="sparse")`` (352x480, B=8 at the defaults and B=4 with
``encoder_iterations=2``), holds those forwards against the plain route
and the tiny JAX-made fixture's flow against JAX's, holds one RAFT train
step (B=2, 184x248, iters=4) and one SparseRAFT train step (B=2, 352x480,
dropout 0) through the kernels against the same steps through the plain
versions, trains RAFT-large for 7 steps at the chairs defaults (B=8,
368x496, iters=12) and SparseRAFT at 352x480 (B=8 at the defaults, 7
steps; B=4 with ``encoder_iterations=2``, 3 steps; ``sparse_lambda=0.1``)
through the port's ``train`` on synthetic batches, counting kernel
launches on every path, times each kernel beside its plain version, its
bound and a cuDNN yardstick where one exists (the kernels that multiply in
3xTF32 on the tensor cores, the conv tile's and the corr kernels', at a
third of the TF32 rate, with their f32 SIMT bound and achieved TFLOP/s
beside it; their SASS is checked for tensor-core TF32 MMAs after the
build), holds the corr kernels against their plain versions on coherent
and incoherent flows with each of their two paths forced (the shared query
tile and the per-query warp path), times them on both kinds of flow at the
Sintel and chairs shapes (also queued behind a sleep, ``ms_q``) and prints the share of their (tile, level)
blocks on the shared path there and in the serve and train phases, holds
the MSDA kernels against their plain versions on the decoder's and the
encoder's incoherent inputs and on the encoder's coherent one (its
reference points and the sampling heads' initial offsets) at the
forward's default slots a group and with its groups forced to one slot
and to a warp, times them there queued behind a sleep (device time,
``ms_q*``), profiles one Sintel pair (RAFT-large and RAFT-small),
one sparse forward, one RAFT and one sparse train step, and prints one
JSON line of kernel numbers. RAFT-large inference under the bf16
mixed-precision policy (phase ``mixed``): the bf16 forms of corr_fwd (on
the Sintel and chairs shapes, coherent and incoherent flows, each path
forced, bfloat16 maps and windows and float32 maps with bfloat16 products)
and update_step (both depths, at the Sintel shape and on the served
model's own B=2 state) against their plain versions and their SASS for
bf16 tensor-core MMAs, the step-granular refine in chunks against
dispatch_batch and a warm frame from encoded maps against the pair call,
the goldens through three routes (the all-pairs
pyramid stored in bfloat16, the bf16 corr form, and the bf16 corr form on
``update_impl="chain"``) against
``assets/golden/cpu_reference.json``'s band, five Sintel pairs served at
iters=32 with both bf16 forms once an iteration (ms/pair beside the float32
path's), one pair profiled, and both forms timed (``corr_fwd_bf16`` and
``update_step_bf16`` rows, the latter beside cuDNN's bf16 convolutions).
On ``update_impl="chain"`` under the policy (phase ``mixed chain``): the
bf16 forms of motion_fwd and sepconv_gru against their plain versions on
Sintel inputs and on the served B=2 state, with the float32 forms on the
same values as the control, two Sintel pairs beside the step route's
ms/pair, both forms timed (rows ``motion_fwd_bf16`` and
``sepconv_gru_bf16``, beside their bf16 bound and cuDNN's bf16
convolutions). RAFT-small under the policy (phase ``mixed small``): its
goldens on both engines (the bf16 corr form at r=3, C=128, and the
pyramid stored in bfloat16) against the JAX package's own aggregate
(``SMALL_MIXED_GT_CPU``), five Sintel pairs beside float32 RAFT-small's.
RAFT-large training under the policy (phase ``mixed train``): the bf16
corr backward against its plain version at the chairs (B=8) and Sintel
shapes (C=256 r=4, C=128 r=3), coherent and incoherent flows, and with
rescale 0, in its three operand combinations (bf16 maps with float32 or
bf16 products, float32 maps with bf16 products), bf16 and float32
cotangents, each path forced, its boxes of one chunk, of more chunks than
its ring and ragged ones counted, its SASS (bf16 MMAs only) and ptxas
report (no spills) read, and timed beside the float32 form (row
``corr_bwd_bf16``); one train step through the kernels
against the plain route with ``mixed_precision=True`` and with
``corr_mxu_dtype="bfloat16"``; seven chairs-size steps through ``train()``
under the policy on the float32 run's weights and batches (each step's
loss beside the float32 one's; corr_fwd_bf16, corr_bwd_bf16 and
update_step_bf16 12 a step), one of them profiled; on the chain (phase
``mixed chain train``) a B=2 train step against the plain route and
seven chairs-size steps beside the step route's (motion_fwd_bf16 and
sepconv_gru_bf16 12 a step).
The last line is ``{"ok": true, "device":
{...}}``. Any failed check exits non-zero before that line; without a CUDA
card it exits non-zero at once.
"""

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4                    # kernel vs plain: the two sum in another order
GOLDEN_PARITY_BAR = 2e-3      # tests/test_golden.py
GOLDEN_GT_BAR = 1e-2
SINTEL_HW = (436, 1024)
SINTEL_ITERS = 32
SERVE_PAIRS = 5
CHAIN_PAIRS = 2
TIMED_LAUNCHES = 30
# cycles of torch.cuda._sleep ahead of queued_ms's launches: about 10 ms,
# longer than the host takes to queue 30 launches of a wrapper
QUEUE_CYCLES = 20_000_000
# The train phase: chairs defaults (TrainConfig), 2 warm-up and 5 timed
# steps; the kernel-vs-plain train step at a size the plain lookup holds.
TRAIN_B, TRAIN_HW, TRAIN_ITERS = 8, (368, 496), 12
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
CMP_B, CMP_HW, CMP_ITERS = 2, (184, 248), 4
LOSS_REL, NORM_REL, PARAM_BAR, BN_BAR = 1e-5, 1e-4, 1e-6, 1e-5
GRAD_REL = 1e-4               # per parameter, of its largest plain gradient
# The two routes' gradients are compared against the plain route's own
# spread: between two plain runs (the lookup's gradient is summed with float
# atomics in no fixed order on both routes), and between the plain run and
# one whose lookup and step outputs are moved by PERTURB relative noise,
# the scale of the kernels' own difference from the plain versions
# (corr_fwd up to 2e-5 on values of order 1, update_step 1.5e-6; ReLUs near
# 0, the L1 loss's sign and sums that nearly cancel turn such differences
# into larger ones in some gradients). A check passes within SPREAD_MARGIN
# times that spread, or its fixed bar where that is larger.
PERTURB = 1e-5
SPREAD_MARGIN = 4.0
# Adam's first update is lr * g / (|g| + eps), eps = 1e-8: where a gradient
# entry is within a few eps of zero, float rounding of g flips or scales
# the update by up to 2 lr. PARAM_BAR applies to the entries whose plain
# gradient is above ADAM_EXACT = 10 eps; the others are held to 2 lr.
ADAM_EXACT = 1e-7
CORR_BWD_REL = 1e-4           # max|kernel - plain| / max|plain|
# step_against_plain's bars in float32: the fixed bars above, the
# backward kernels in situ and the BN statistics against the spread of two
# plain runs, the rest against the plain route's move under PERTURB
STEP_BARS = dict(loss=LOSS_REL, norm=NORM_REL, grad=GRAD_REL,
                 param=PARAM_BAR, bn=BN_BAR, perturb=PERTURB, base="spread")
# The sparse family at bench.py's configuration (352x480, B=8) and at
# scripts/tpu_extras_bench.py's dense-encoder one (B=4, encoder_iterations
# 2): one warm-up, then SPARSE_TIMED forwards.
SPARSE_HW = (352, 480)
SPARSE_RUNS = (("defaults", 8, 0), ("encoder_iterations=2", 4, 2))
SPARSE_TIMED = 3
# the token levels at 352x480: strides 8, 16, 32 of both images
SPARSE_LEVELS = [(44, 60), (22, 30), (11, 15)] * 2
# kernel route vs plain route: max|diff| of flow_up within the larger of
# these; only where that fails, within SPREAD_MARGIN times the plain
# route's own move under PERTURB relative noise on the lookups' and the
# MSDA cores' outputs (reported as the fallback it is)
SPARSE_FLOW_PX, SPARSE_FLOW_REL = 1e-3, 1e-4
# The sparse family's training at the fork's training resolution
# (352x480, train_standard.sh:6, as scripts/tpu_extras_bench.py's
# sparse_train), sparse_lambda 0.1, AdamW, random weights: B=8 at the
# defaults (2 warm-up and 5 timed steps) and B=4 with encoder_iterations=2
# (1 and 2); the kernel-vs-plain step at B=2 with dropout 0.
SPARSE_TRAIN_RUNS = (("defaults", 8, 0, 2, 5),
                     ("encoder_iterations=2", 4, 2, 1, 2))
SPARSE_LAMBDA = 0.1
SPARSE_CMP_B = 2
DEVICE = "cuda"               # the train helpers' device
# Published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, dense TF32 on the tensor cores, and HBM3 bandwidth. The
# conv tile (csrc/conv_phase.cuh) multiplies in 3xTF32, three TF32 products
# for each f32-grade one: its kernels' bound is their f32 operations at a
# third of the TF32 rate (the f32 SIMT bound is printed beside it).
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
TF32X3_FLOPS = TF32_FLOPS / 3
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12           # dense bfloat16 on the tensor cores
# three bf16 passes: corr_bwd_bf16 at mxu "float32", the coefficient split
# into three bfloat16 parts (the map exact in bfloat16)
BF16X3_FLOPS = BF16_FLOPS / 3
CONV_TILE_KERNELS = ("sepconv_gru", "motion_fwd", "update_step")
# Kernels that multiply in 3xTF32 on the tensor cores: the conv tile's, and
# the corr kernels on their shared path (csrc/corr_tile.cuh), whose warp
# path is f32 SIMT: their bound is taken at 165 TFLOP/s, the f32 SIMT one
# printed beside it.
TENSOR_CORE_KERNELS = CONV_TILE_KERNELS + ("corr_fwd", "corr_bwd")
# The forced budgets of the corr kernels' path checks: 0 sends every
# (tile, level) block with a non-empty box to the warp path, FORCE_SHARED
# every block to the shared path.
FORCE_SHARED = 10 ** 8
# The MSDA forward's forced slots a group (msda_cuda.FWD_SLOTS, at most a
# warp): one slot of D/4 lanes per (image, query, head), and a warp.
MSDA_FORCE = {"one_slot": 1, "warp": 32}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(torch, fn, n: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    """Median over ``n`` calls of ``fn``, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def queued_ms(torch, fn, n: int = TIMED_LAUNCHES) -> float:
    """Median over ``n`` calls of ``fn`` between two CUDA events, queued
    behind a sleep on the stream, so that the card never waits for the
    host between them: the device time of a kernel shorter than its
    wrapper's Python, which ``time_ms`` would also hold."""
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


def bound(flops: float, nbytes: float, peak: float = F32_FLOPS):
    """Least time on the card: the larger of operations over ``peak`` (the
    f32 SIMT rate unless given) and bytes over the memory rate. Returns
    (ms, "operations"|"bytes")."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _tensor_core_ops(cuobjdump: str, library: str, dtype: str) -> dict:
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    ops = {}
    for op in re.findall(rf"\b(HG?MMA\.[\w.]*{dtype}[\w.]*)", sass):
        ops[op] = ops.get(op, 0) + 1
    return ops


def tensor_core_tf32_ops(cuobjdump: str, library: str) -> dict:
    """Counts, by opcode, of the tensor-core MMA instructions with TF32
    operands (HMMA, and Hopper's warpgroup HGMMA) in a built library's
    SASS."""
    return _tensor_core_ops(cuobjdump, library, "TF32")


def tensor_core_bf16_ops(cuobjdump: str, library: str) -> dict:
    """The same for bfloat16 operands (the bf16 forms)."""
    return _tensor_core_ops(cuobjdump, library, "BF16")


def ptxas_usage(library: str):
    """Each kernel's registers and spill bytes (stores and loads) from the
    ptxas report that ops/build.py keeps beside a built library."""
    with open(library + ".log") as f:
        log = f.read()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    return regs, spills


def widest_hgmma_n(ops: dict) -> int:
    """The widest N of the warpgroup MMAs (HGMMA.64xNx16...) among ``ops``
    (tensor_core_*_ops), 0 if there is none."""
    ns = [int(m.group(1)) for op in ops
          for m in [re.match(r"HGMMA\.64x(\d+)x", op)] if m]
    return max(ns, default=0)


# The feature shapes at which chip_smoke reports the bf16 tile's waves
# (label, batch, height, width): a Sintel pair and its B=2 and B=4
# batches, and the chairs training batch.
BF16_WAVE_SHAPES = (("sintel B=1", 1, 55, 128), ("sintel B=2", 2, 55, 128),
                    ("sintel B=4", 4, 55, 128), ("chairs B=8", 8, 46, 62))


def bf16_tile_geometry(torch, conv_tile, phases):
    """The bf16 tile's plan of a program (ops/conv_tile.py): each conv's
    block and consumer widths, A route and K stages, and at each of
    BF16_WAVE_SHAPES each phase's tiles and waves over the launch's blocks
    (one an SM, at most the busiest phase's tiles)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = conv_tile.plan(phases)
    convs = [{"conv": p.conv.name, "block_n": p.block_n,
              "wgmma": f"m64n{p.consumer_n}k16", "a": p.routes[0],
              "stages": p.stages} for ph in plans for p in ph]
    waves = {}
    for label, b, h, w in BF16_WAVE_SHAPES:
        blocks = min(sms, max(sum(p.tiles(b, h, w) for p in ph)
                              for ph in plans))
        waves[label] = {"blocks": blocks, "phases": [
            {"convs": "|".join(r["convs"]), "tiles": r["tiles"],
             "waves": round(r["waves"], 3)}
            for r in conv_tile.waves(phases, b, h, w, blocks)]}
    return {"convs": convs, "waves": waves}


def print_tile_geometry(name, geo):
    print(f"  {name} tile: " + ", ".join(
        f"{c['conv']} {c['block_n']} ({c['wgmma']}, A {c['a']}, "
        f"{c['stages']} stages)" for c in geo["convs"]))
    for label, wv in geo["waves"].items():
        print(f"  {name} waves at {label} on {wv['blocks']} blocks: "
              + ", ".join(f"{r['convs']} {r['tiles']} ({r['waves']:.2f})"
                          for r in wv["phases"]))


def conv_tile_rates(ms: float, work) -> dict:
    """A conv-tile kernel's f32 SIMT bound (ms, the rate of the tile before
    3xTF32) and its achieved rate in f32-grade TFLOP/s."""
    return {"bound_ms_f32_simt": bound(*work)[0],
            "tflops": work[0] / ms / 1e9}


def smooth_flow(rng, b, h, w, max_px):
    """A smooth flow field (b, h, w, 2), x first, in feature pixels: per
    image a translation, a rotation and a zoom about the centre drawn from
    ``rng``, scaled so that its largest component is ``max_px``. The flows
    RAFT produces look so to the lookup: neighbouring queries share most of
    their windows."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x, y = xs - (w - 1) / 2, ys - (h - 1) / 2
    radius = max(math.hypot((w - 1) / 2, (h - 1) / 2), 1.0)
    out = np.empty((b, h, w, 2))
    for i in range(b):
        tx, ty, rot, zoom = rng.uniform(-1.0, 1.0, 4)
        out[i, ..., 0] = tx + (zoom * x - rot * y) / radius
        out[i, ..., 1] = ty + (rot * x + zoom * y) / radius
        out[i] *= max_px / np.abs(out[i]).max()
    return out


def lookup_flow(rng, b, h, w, max_px, flow):
    """Flows for timing the lookup: ``"coherent"``, a smooth field up to
    ``max_px`` (``smooth_flow``), or ``"incoherent"``, drawn independently
    for every pixel, uniform in +-``max_px``: the worst case for a tile of
    queries, whose windows then scatter over the level."""
    if flow == "coherent":
        return smooth_flow(rng, b, h, w, max_px)
    return rng.uniform(-max_px, max_px, (b, h, w, 2))


# The lookup's timing inputs, in feature pixels: flows RAFT produces at the
# Sintel shape (+-40 image px) and at the chairs shape (+-32 image px), and
# the independent per-pixel draws of the kernels' earlier rows.
CORR_FLOWS = {"sintel": {"coherent": 5.0, "incoherent": 40.0},
              "chairs": {"coherent": 4.0, "incoherent": 4.0}}


def corr_inputs(torch, sampling, corr, rng, h, w, c=256, levels=4,
                flow="incoherent", b=1, max_px=None):
    dev = torch.device("cuda")
    f1 = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=torch.float32,
                      device=dev)
    f2 = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=torch.float32,
                      device=dev)
    pyramid = corr.build_feature_pyramid(f2, levels)
    # incoherent: independent flows up to 40 feature px (320 image px) move
    # many windows partly or wholly off the image; non-integer by
    # construction
    max_px = CORR_FLOWS["sintel"][flow] if max_px is None else max_px
    coords = (sampling.coords_grid(b, h, w, dev) + torch.tensor(
        lookup_flow(rng, b, h, w, max_px, flow), dtype=torch.float32,
        device=dev))
    return f1, pyramid, coords.contiguous()


def in_range_neighbours(torch, pyramid, coords, radius, rescale=True):
    """In-range integer neighbours of every query's (2r+2)^2 grid, summed
    over the levels (level l around coords / 2^l, or around coords with
    ``rescale=False``, the fork lookup): the dot products the corr kernels
    do on these inputs."""
    steps = torch.arange(2 * radius + 2, device=coords.device)
    neighbours = 0
    for lvl, f2 in enumerate(pyramid):
        cl = coords / (2 ** lvl) if rescale else coords
        xs = torch.floor(cl[..., 0:1]) - radius + steps
        ys = torch.floor(cl[..., 1:2]) - radius + steps
        nx = ((xs >= 0) & (xs < f2.shape[2])).sum(-1)
        ny = ((ys >= 0) & (ys < f2.shape[1])).sum(-1)
        neighbours += int((nx * ny).sum())
    return neighbours


# corr_bwd_bf16's box chunk in pixels (csrc/corr_tile_bf16.cuh, kChunk);
# its ring holds two chunks
BWD_BF16_CHUNK = 64


def box_pixels(torch, pyramid, coords, radius, rescale=True):
    """The pixels of every (tile, level) block's box, the corr kernels' rule
    (csrc/corr_tile.cuh, load_tile): per level each query's (2r+2)^2
    integer neighbours clipped to the level, none for a far or NaN centre;
    a box bounds its 8 x 8 queries' neighbours, 0 pixels if it holds none.
    Returns an int64 tensor (levels x tiles)."""
    b, h, w = coords.shape[:3]
    d, big = 2 * radius + 2, 1 << 30
    ph, pw = -h % 8, -w % 8
    sizes = []
    for lvl, f2 in enumerate(pyramid):
        h2, w2 = f2.shape[1:3]
        f = torch.floor(coords / 2 ** lvl if rescale else coords)
        near = (f.abs() < 1e8).all(-1)
        first = torch.where(near[..., None], f, 0.0).long() - radius
        lo = first.clamp(min=0)
        hi = torch.minimum(first + d - 1,
                           torch.tensor([w2 - 1, h2 - 1], device=f.device))
        keep = (near & (lo <= hi).all(-1))[..., None]
        lo = torch.where(keep, lo, big)
        hi = torch.where(keep, hi, -big)

        def tiled(x, pad, reduce):
            x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                                        value=pad)
            x = x.reshape(b, 2, (h + ph) // 8, 8, (w + pw) // 8, 8)
            return reduce(reduce(x, 5), 3)

        lo = tiled(lo, big, lambda x, dim: x.amin(dim))
        hi = tiled(hi, -big, lambda x, dim: x.amax(dim))
        extent = (hi - lo + 1).clamp(min=0)
        sizes.append((extent[:, 0] * extent[:, 1]).reshape(-1))
    return torch.stack(sizes)


def corr_work(torch, f1, pyramid, coords, radius, rescale=True):
    """Operations and bytes of one lookup on these inputs: a dot product
    of C channels for each in-range integer neighbour, 8 operations for
    each bilinear output; every input read once, the output written once."""
    b, h, w, c = f1.shape
    win = 2 * radius + 1
    outputs = b * h * w * len(pyramid) * win * win
    flops = (2 * c * in_range_neighbours(torch, pyramid, coords, radius,
                                         rescale)
             + 8 * outputs)
    nbytes = 4 * (f1.numel() + sum(f.numel() for f in pyramid)
                  + coords.numel() + outputs)
    return flops, nbytes


def corr_bwd_work(torch, f1, pyramid, coords, radius, rescale=True):
    """Operations and bytes of one backward on these inputs: two
    multiply-adds of C channels (df1 and df2) for each in-range neighbour,
    8 operations for each of the (2r+2)^2 coefficients of a query and
    level; f1, the levels, coords and the cotangent read once, df1 and the
    df2 levels written once."""
    b, h, w, c = f1.shape
    win = 2 * radius + 1
    queries = b * h * w * len(pyramid)
    flops = (4 * c * in_range_neighbours(torch, pyramid, coords, radius,
                                         rescale)
             + 8 * queries * (2 * radius + 2) ** 2)
    nbytes = 4 * (2 * f1.numel() + 2 * sum(f.numel() for f in pyramid)
                  + coords.numel() + queries * win * win)
    return flops, nbytes


def gru_inputs(torch, gru_module, rng, h, w):
    dev = torch.device("cuda")
    c = gru_module.convz1.out_channels
    cx = gru_module.convz1.in_channels - c
    hid = torch.tensor(np.tanh(rng.standard_normal((1, h, w, c))),
                       dtype=torch.float32, device=dev)
    x = torch.tensor(np.maximum(rng.standard_normal((1, h, w, cx)), 0),
                     dtype=torch.float32, device=dev)
    return hid, x


def gru_work(hid, x, packed):
    """Six 5-tap convolutions (z, r, q per half) as f32 multiply-adds plus
    about 20 operations per hidden element and half for the gates and the
    blend; h, x and the packed weights read once, h' written once."""
    m = hid.shape[0] * hid.shape[1] * hid.shape[2]
    c, cx = hid.shape[-1], x.shape[-1]
    flops = 2 * (2 * m * 5 * (c + cx) * 3 * c + 20 * m * c)
    nbytes = 4 * (2 * hid.numel() + x.numel()
                  + sum(t.numel() for t in packed))
    return flops, nbytes


def gru_library(torch, convs):
    """The same cell through cuDNN (F.conv2d, z and r merged into one
    convolution per half), NCHW: the yardstick, never called by the port."""
    F = torch.nn.functional
    halves = []
    for (wz, bz), (wr, br), (wq, bq), pad in ((*convs[:3], (0, 2)),
                                              (*convs[3:], (2, 0))):
        halves.append((torch.cat([wz, wr]), torch.cat([bz, br]), wq, bq, pad))

    def cell(h, x):
        for w_zr, b_zr, w_q, b_q, pad in halves:
            z, r = torch.sigmoid(
                F.conv2d(torch.cat([h, x], 1), w_zr, b_zr, padding=pad)
            ).chunk(2, dim=1)
            q = torch.tanh(F.conv2d(torch.cat([r * h, x], 1), w_q, b_q,
                                    padding=pad))
            h = (1 - z) * h + z * q
        return h
    return cell


def conv_flops(m, convs):
    """A multiply-add per weight and pixel, plus bias and activation per
    output, for convolutions given as (weight, bias) pairs."""
    return sum(2 * m * (w.numel() + w.shape[0]) for w, _ in convs)


def n_bytes(*tensors):
    return 4 * sum(t.numel() for t in tensors)


def motion_work(flow, corr, packed, convs):
    """The five convolutions on these inputs; corr, flow and the packed
    weights read once, [motion | flow] written once."""
    m = corr.shape[0] * corr.shape[1] * corr.shape[2]
    return (conv_flops(m, convs),
            n_bytes(corr, flow, *packed) + 4 * m * 128)


def step_work(net, inp, corr, flow, packed, convs):
    """Motion convolutions, the GRU cell (gru_work) and, at 'mgf', the flow
    head; every input and packed weight read once, h2 (and delta) written
    once."""
    motion, gru, head = convs
    m = net.shape[0] * net.shape[1] * net.shape[2]
    c = net.shape[-1]
    flops = conv_flops(m, motion)
    flops += 2 * m * sum(w.numel() for w, _ in gru) + 2 * 20 * m * c
    weights = [t for group in packed if group is not None for t in group]
    nbytes = n_bytes(net, inp, corr, flow, *weights) + 4 * m * c
    if head is not None:
        flops += conv_flops(m, head)
        nbytes += 4 * m * 2
    return flops, nbytes


def motion_library(torch, convs):
    """The five motion convolutions through cuDNN, NCHW in and out."""
    F = torch.nn.functional
    (wc1, bc1), (wc2, bc2), (wf1, bf1), (wf2, bf2), (wo, bo) = convs

    def run(flow, corr):
        cor = F.relu(F.conv2d(F.relu(F.conv2d(corr, wc1, bc1)), wc2, bc2,
                              padding=1))
        flo = F.relu(F.conv2d(F.relu(F.conv2d(flow, wf1, bf1, padding=3)),
                              wf2, bf2, padding=1))
        out = F.relu(F.conv2d(torch.cat([cor, flo], 1), wo, bo, padding=1))
        return torch.cat([out, flow], 1)
    return run


def step_library(torch, convs):
    """One refine iteration through cuDNN, NCHW: the motion convolutions,
    the cuDNN GRU cell of gru_library and (at 'mgf') the flow head."""
    F = torch.nn.functional
    motion = motion_library(torch, convs[0])
    cell = gru_library(torch, convs[1])
    head = convs[2]

    def run(net, inp, corr, flow):
        h2 = cell(net, torch.cat([inp, motion(flow, corr)], 1))
        if head is None:
            return h2
        (w1, b1), (w2, b2) = head
        return h2, F.conv2d(F.relu(F.conv2d(h2, w1, b1, padding=1)), w2, b2,
                            padding=1)
    return run


def update_inputs(torch, rng, h, w, cc=324):
    """net, inp, corr and flow at one feature shape, on the card."""
    dev = torch.device("cuda")

    def put(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)
    return (put(np.tanh(rng.standard_normal((1, h, w, 128)))),
            put(np.maximum(rng.standard_normal((1, h, w, 128)), 0)),
            put(rng.standard_normal((1, h, w, cc))),
            put(rng.uniform(-20.0, 20.0, (1, h, w, 2))))


def nchw(t):
    return t.permute(0, 3, 1, 2).contiguous()


def reset_counts(counters):
    """Every launch counter to 0, and the corr kernels' path counts."""
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
        if hasattr(mod, "reset_path_counts"):
            mod.reset_path_counts()


def shared_share(counts) -> float:
    """The share of (tile, level) blocks on the shared path, from a
    (shared, warp) pair of ``corr_cuda.path_counts()``."""
    return counts[0] / max(1, counts[0] + counts[1])


def print_path_shares(corr_cuda, label, kinds=("fwd", "bwd")):
    """The corr kernels' path counts since the last reset, one line."""
    counts = corr_cuda.path_counts()
    print(f"corr path shares [{label}]: " + "; ".join(
        f"corr_{k} shared path {counts[k][0]} of {sum(counts[k])} (tile, "
        f"level) blocks ({100 * shared_share(counts[k]):.1f}%)"
        for k in kinds))
    return {k: shared_share(counts[k]) for k in kinds}


def corr_against_plain(torch, corr_cuda, f1, pyr, coords, g, radius, want,
                       want_d, what, err):
    """corr_fwd and corr_bwd on these inputs against their plain outputs
    ``want`` and ``want_d``: fails beyond TOL or CORR_BWD_REL (of the
    largest plain gradient). Updates ``err``; returns the backward's
    relative error and the (shared, warp) block counts of both kernels."""
    corr_cuda.reset_path_counts()
    with torch.inference_mode():
        got = corr_cuda.windowed_correlation_cuda(f1, pyr, coords, radius)
    got_d = corr_cuda.windowed_correlation_bwd_cuda(f1, pyr, coords, g,
                                                    radius)
    torch.cuda.synchronize()
    counts = corr_cuda.path_counts()
    d = float((got - want).abs().max())
    plain = (want_d[0], *want_d[1])
    diffs = [float((a - b).abs().max())
             for a, b in zip((got_d[0], *got_d[1]), plain)]
    rel = max(e / float(b.abs().max()) for e, b in zip(diffs, plain))
    err["corr_fwd"] = max(err["corr_fwd"], d)
    err["corr_bwd"] = max(err["corr_bwd"], *diffs)
    print(f"corr {what} [shared fwd {100 * shared_share(counts['fwd']):.1f}%"
          f", bwd {100 * shared_share(counts['bwd']):.1f}% of blocks]: "
          f"corr_fwd max|kernel - plain| = {d:.3e} (bar {TOL:g}), corr_bwd "
          f"/ max|plain| = {rel:.3e} (bar {CORR_BWD_REL:g})")
    if not (d <= TOL and rel <= CORR_BWD_REL):
        fail(f"a corr kernel disagrees with its plain version at {what}")
    return rel, counts


def lookup_cases(feat):
    """(label, B, h, w, flows) of the corr kernels' checks and timings: the
    golden and Sintel feature shapes at B=1 and the chairs train shape at
    B=8 (TRAIN_B), each with its CORR_FLOWS."""
    chairs = (TRAIN_B, TRAIN_HW[0] // 8, TRAIN_HW[1] // 8)
    return ([(label, 1, h, w, CORR_FLOWS["sintel"])
             for label, (h, w) in feat.items()]
            + [("chairs", *chairs, CORR_FLOWS["chairs"])])


def check_corr_paths(torch, corr_cuda, corr, sampling, rng, radius, feat,
                     err, c=256, cases=None):
    """corr_fwd and corr_bwd against their plain versions at the golden,
    Sintel and chairs lookup shapes (lookup_cases, or ``cases``), C=``c``,
    on coherent and incoherent flows, with each path forced (budget 0: the
    warp path on every block with a non-empty box; FORCE_SHARED: the
    shared path on every block). Updates ``err``; returns the worst
    corr_bwd error relative to the largest plain gradient."""
    worst_rel = 0.0
    default = corr_cuda.TILE_BUDGET
    try:
        for label, b, h, w, flows in cases or lookup_cases(feat):
            for flow, max_px in flows.items():
                f1, pyr, coords = corr_inputs(torch, sampling, corr, rng, h,
                                              w, c=c, flow=flow, b=b,
                                              max_px=max_px)
                g = torch.randn(b, h, w, len(pyr) * (2 * radius + 1) ** 2,
                                device="cuda")
                with torch.inference_mode():
                    want = corr_cuda.windowed_correlation_fused_plain(
                        f1, pyr, coords, radius)
                want_d = corr_cuda.windowed_correlation_bwd_plain(
                    f1, pyr, coords, g, radius)
                for path, budget in (("warp", 0), ("shared", FORCE_SHARED)):
                    corr_cuda.TILE_BUDGET = budget
                    rel, counts = corr_against_plain(
                        torch, corr_cuda, f1, pyr, coords, g, radius, want,
                        want_d, f"{label} B={b} {h}x{w} C={c} r={radius} "
                        f"{flow}, {path} path forced", err)
                    worst_rel = max(worst_rel, rel)
                    forced = {"warp": 1, "shared": 0}[path]
                    if not all(counts[k][forced] > counts[k][1 - forced]
                               for k in ("fwd", "bwd")):
                        fail(f"the {path} path was not taken: {counts}")
    finally:
        corr_cuda.TILE_BUDGET = default
    return worst_rel


def corr_timings(torch, corr_cuda, corr, sampling, rng, radius, feat, err,
                 c=256, cases=None):
    """corr_fwd and corr_bwd at the Sintel (B=1, 55x128) and chairs (B=8,
    46x62) lookup shapes (or ``cases``, as lookup_cases gives them) on
    coherent and incoherent flows (CORR_FLOWS), C=``c``, 4 levels, at the
    default budget: each timed input first held
    against the plain version (corr_against_plain, which updates ``err``),
    then ms a launch (time_ms, and queued_ms under ms_q), the bounds on the work these inputs need (3xTF32 and
    f32 SIMT), and the share of (tile, level) blocks on the shared path;
    at the Sintel shape also the plain version's ms and the work. Returns
    ({"fwd": {"<shape> <flow>": {...}}, "bwd": {...}}, the worst corr_bwd
    error relative to the largest plain gradient)."""
    out = {"fwd": {}, "bwd": {}}
    worst_rel = 0.0
    for shape, b, h, w, flows in cases or lookup_cases(feat):
        if shape == "golden":
            continue
        for flow, max_px in flows.items():
            f1, pyr, coords = corr_inputs(torch, sampling, corr, rng, h, w,
                                          c=c, flow=flow, b=b, max_px=max_px)
            g = torch.randn(b, h, w, len(pyr) * (2 * radius + 1) ** 2,
                            device="cuda")
            with torch.inference_mode():
                want = corr_cuda.windowed_correlation_fused_plain(
                    f1, pyr, coords, radius)
            want_d = corr_cuda.windowed_correlation_bwd_plain(
                f1, pyr, coords, g, radius)
            rel, counts = corr_against_plain(
                torch, corr_cuda, f1, pyr, coords, g, radius, want, want_d,
                f"{shape} B={b} {h}x{w} C={c} r={radius} {flow}, timed "
                f"input", err)
            worst_rel = max(worst_rel, rel)
            runs = {"fwd": (lambda: corr_cuda.windowed_correlation_cuda(
                                f1, pyr, coords, radius),
                            lambda: corr_cuda.windowed_correlation_fused_plain(
                                f1, pyr, coords, radius),
                            corr_work(torch, f1, pyr, coords, radius)),
                    "bwd": (lambda: corr_cuda.windowed_correlation_bwd_cuda(
                                f1, pyr, coords, g, radius),
                            lambda: corr_cuda.windowed_correlation_bwd_plain(
                                f1, pyr, coords, g, radius),
                            corr_bwd_work(torch, f1, pyr, coords, radius))}
            for kind, (run, plain, work) in runs.items():
                row = {"ms": time_ms(torch, run),
                       "ms_q": queued_ms(torch, run),
                       "bound_ms": bound(*work, peak=TF32X3_FLOPS)[0],
                       "bound_ms_f32_simt": bound(*work)[0],
                       "shared_share": shared_share(counts[kind]),
                       "shape": f"B={b} {h}x{w} C={c} L=4 r={radius}, "
                                f"flows up to {max_px:g} feature px"}
                if shape == "sintel":
                    row["plain_ms"] = time_ms(torch, plain, n=10)
                    row["work"] = work
                out[kind][f"{shape} {flow}"] = row
    return out, worst_rel


def read_counts(counters):
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def serve_pairs(torch, predictor, padder, frames, counters):
    """Serve ``frames`` (after the first, a warm-up) through ``predictor``,
    with every launch counter set to 0 just before. Returns (ms per pair,
    {kernel: launches})."""
    predictor(*frames[0])
    torch.cuda.synchronize()
    reset_counts(counters)
    times = []
    for im1, im2 in frames[1:]:
        t0 = time.perf_counter()
        _, flow_up = predictor(im1, im2)
        times.append(1e3 * (time.perf_counter() - t0))
        flow = padder.unpad(flow_up)
        if flow.shape != (*SINTEL_HW, 2) or not np.isfinite(flow).all():
            fail(f"Sintel flow has shape {flow.shape} or non-finite values")
    return times, read_counts(counters)


def check_launches(launches, pairs, want_per_pair, unit="pair"):
    """Every counter against ``want_per_pair`` (0 for a kernel it does not
    name)."""
    for name, n in launches.items():
        want = want_per_pair.get(name, 0) * pairs
        print(f"  {name}: {n} launches ({n / pairs:g} per {unit})")
        if n != want:
            fail(f"{name} launched {n} times, expected {want}")


def profile_pair(torch, predictor, im1, im2, top: int = 10,
                 label="profile", per_iteration="update_step_kernel"):
    """One pair under torch.profiler: device time by kernel name and the
    share of the (profiled, so inflated) wall time the device was busy.
    ``per_iteration``: the kernel that must launch once a refine iteration
    (RAFT-small has no step kernel: its lookup)."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor(im1, im2)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = defaultdict(lambda: [0.0, 0])
    events = device_events(torch, prof)
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    device_ms = sum(t for t, _ in by_name.values())
    if not device_ms:
        print(f"{label}: the profiler recorded no device time (not "
              f"measured)")
        return
    busy = busy_ms(events)
    print_overlaps(label, events, device_ms, busy)
    steps = sum(n for name, (_, n) in by_name.items()
                if per_iteration in name)
    if steps != SINTEL_ITERS:
        fail(f"the profiled pair launched {per_iteration} {steps} times, "
             f"expected {SINTEL_ITERS}")
    cudnn_convs = sum(n for name, (_, n) in by_name.items()
                      if "fprop" in name)
    print(f"{label}: {per_iteration} launched {steps} times; "
          f"{cudnn_convs} cuDNN convolution launches; "
          f"{sum(n for _, n in by_name.values())} device launches in all")
    print(f"{label}: one Sintel pair, device busy {busy:.2f} ms of "
          f"{wall_ms:.2f} ms wall under the profiler "
          f"({100 * busy / wall_ms:.1f}%), device time {device_ms:.2f} ms, "
          f"{len(by_name)} kernel names")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        print(f"  {ms:8.3f} ms {100 * ms / device_ms:5.1f}% {n:5d}x  "
              f"{name[:90]}")


@contextlib.contextmanager
def plain_route(corr_cuda, step_cuda, motion_cuda, gru_cuda, msda,
                perturb=None, scale=PERTURB):
    """Every kernel's dispatcher replaced by its plain version (autograd
    through plain PyTorch), for the duration: the reference the kernel
    route is held against on the card. ``perturb``: a generator; the
    lookup's, the step's (or the chain's motion and GRU), and the MSDA
    core's outputs are then multiplied by
    1 + ``scale`` * N(0, 1) from it (in float32, a bfloat16 output rounded
    back)."""
    def noisy(out):
        if perturb is None:
            return out
        x = out.float()
        return (x * (1 + scale * x.new_empty(x.shape).normal_(
            generator=perturb))).to(out.dtype)

    swaps = {
        (corr_cuda, "windowed_correlation_fused"):
            lambda f1, pyr, c, r, scale=True, rescale=True: noisy(
                corr_cuda.windowed_correlation_fused_plain(f1, pyr, c, r,
                                                           scale, rescale)),
        (corr_cuda, "windowed_correlation_bf16"):
            lambda f1, pyr, c, r, scale=True, rescale=True, out_dtype=None,
            mxu_dtype="bfloat16": noisy(
                corr_cuda.windowed_correlation_fused_plain(
                    f1, pyr, c, r, scale, rescale, mxu_dtype, out_dtype)),
        (msda, "ms_deform_attn"):
            lambda v, shapes, loc, aw: noisy(
                msda.ms_deform_attn_plain(v, shapes, loc, aw)),
        (step_cuda, "fused_step"):
            lambda net, inp, corr, flow, convs, packed: noisy(
                step_cuda.fused_step_plain(net, inp, corr, flow, convs)),
        (motion_cuda, "motion_encoder"):
            lambda flow, corr, convs, packed: noisy(
                motion_cuda.motion_encoder_plain(flow, corr, convs)),
        (gru_cuda, "sepconv_gru"):
            lambda h, x, convs, packed: noisy(
                gru_cuda.sepconv_gru_plain(h, x, convs))}
    saved = {key: getattr(*key) for key in swaps}
    try:
        for (mod, attr), fn in swaps.items():
            setattr(mod, attr, fn)
        yield
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


@contextlib.contextmanager
def plain_backward(pkg):
    """The kernel route with only the backward kernels (corr_bwd, its bf16
    form, msda_bwd) replaced by autograd through their plain versions: the
    backward kernels in situ."""
    swaps = {(pkg.corr_cuda, "windowed_correlation_bwd_cuda"):
             pkg.corr_cuda.windowed_correlation_bwd_plain,
             (pkg.corr_cuda, "windowed_correlation_bwd_bf16_cuda"):
             pkg.corr_cuda.windowed_correlation_bwd_plain,
             (pkg.msda_cuda, "ms_deform_attn_bwd_cuda"):
             pkg.msda.ms_deform_attn_bwd_plain}
    saved = {key: getattr(*key) for key in swaps}
    try:
        for (mod, attr), fn in swaps.items():
            setattr(mod, attr, fn)
        yield
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


def synthetic_batch(torch, batch, hw, gen):
    """A training batch made on the card: random frames, the second the
    first moved by (dx, dy) = (-3, 2) px, the matching flow, all valid."""
    h, w = hw
    img1 = 255.0 * torch.rand((batch, h, w, 3), generator=gen,
                              device=DEVICE)
    flow = torch.empty((batch, h, w, 2), device=DEVICE)
    flow[..., 0], flow[..., 1] = -3.0, 2.0
    return {"image1": img1, "image2": torch.roll(img1, (2, -3), (1, 2)),
            "flow": flow, "valid": torch.ones((batch, h, w), device=DEVICE)}


class DeviceLoader:
    """``n`` synthetic batches made on the card from ``seed``; records the
    host clock at each pull, after the device has finished the work queued
    so far (so the gaps are whole train steps)."""

    def __init__(self, torch, n, batch, hw, seed):
        self.torch, self.n, self.batch, self.hw = torch, n, batch, hw
        self.gen = torch.Generator(device=DEVICE).manual_seed(seed)
        self.pulls = []

    def __iter__(self):
        for _ in range(self.n):
            self.torch.cuda.synchronize()
            self.pulls.append(time.perf_counter())
            yield synthetic_batch(self.torch, self.batch, self.hw, self.gen)


def cancelled_by_norm(name):
    """The encoders' conv biases but the final projection's feed a norm
    (fnet's instance norms, cnet's batch norms on batch statistics), which
    subtracts them again: their gradient is rounding noise, which Adam's
    first step turns into a move of up to the rate in either direction."""
    return re.fullmatch(r"[fc]net\.(conv1|layer\d\.\d\.(conv\d|downsample"
                        r"\.0))\.bias", name) is not None


def sparse_cancelled_by_norm(name):
    """SparseRAFT's biases whose gradient is rounding noise: those of every
    conv of the two trunks and of the FPN merge, each in front of a norm
    (instance norms in CNNEncoder, batch norms on batch statistics in
    CNNDecoder), and those a softmax cancels: the self-attention's key
    bias (a constant over the keys) and the context embedding's last bias
    (a constant over the keypoints)."""
    return re.fullmatch(r"cnn_(en|de)coder\.(trunk\.(conv1|down_layer\d\.\d\."
                        r"(conv\d|downsample\.0))|up_(top1|lateral1|smooth1))"
                        r"\.bias|decoder\.\d+\.self_attn\.key\.bias"
                        r"|context_embed\.\d+\.layers\.2\.bias",
                        name) is not None


def step_against_plain(torch, pkg, label, make_model, tcfg, batch,
                       cancelled, bars=None, control=None, **step_kw):
    """One train step from the weights ``make_model()`` gives, on one
    batch, through the kernels; through the kernels with the backward
    kernels replaced by autograd through their plain versions; and through
    the plain versions three times (twice as they are, once perturbed): the
    loss (and the sparse loss), grad_norm, every parameter's (clipped)
    gradient, every updated parameter and the batch-norm statistics.
    ``cancelled(name)``: the parameters whose gradient a following norm
    cancels (left out of the gradient check). ``bars``: STEP_BARS (float32,
    the default) or STEP_BARS_BF16. ``control``: a second ``make_model``
    (the same weights without a precision lever) whose plain route the
    kernel route's gradients are also compared with and printed; with
    ``bars["control"]`` that reading must lie above the gradient bar.
    Returns the kernel route's launches and a list of the checks that
    failed."""
    bars = STEP_BARS if bars is None else bars
    lr = pkg.make_schedule(tcfg)(0)

    def step(make_model=make_model):
        model = make_model()
        state = pkg.create_train_state(model.to(DEVICE), tcfg)
        metrics = pkg.make_train_step(tcfg, **step_kw)(state, batch)
        # p.grad keeps the clipped gradient the update used
        return (metrics, model.state_dict(),
                {n: p.grad for n, p in model.named_parameters()})

    reset_counts(pkg.counters)
    kernel = step()
    launches = read_counts(pkg.counters)
    with plain_backward(pkg):
        kernel_plain_bwd = step()
    mods = (pkg.corr_cuda, pkg.step_cuda, pkg.motion_cuda, pkg.gru_cuda,
            pkg.msda)
    with plain_route(*mods):
        plain, again = step(), step()
    with plain_route(*mods, perturb=torch.Generator(
            device=DEVICE).manual_seed(4), scale=bars["perturb"]):
        perturbed = step()

    def compare(a, b):
        """Worst differences of step a against step b: the gradients
        (relative to each parameter's largest), the parameters where the
        gradient is above ADAM_EXACT and elsewhere, the BN statistics; each
        (value, parameter)."""
        worst = {k: (0.0, "") for k in ("grad", "param", "near0", "bn")}
        for name, want in b[1].items():
            if name.endswith("num_batches_tracked"):
                continue
            diff = (a[1][name] - want).abs()
            if "running" in name:
                worst["bn"] = max(worst["bn"], (float(diff.max()), name))
                continue
            if name not in b[2]:        # downsample.1, an alias of norm3
                continue
            g = b[2][name]
            if not cancelled(name):
                rel = float((a[2][name] - g).abs().max() / g.abs().max())
                worst["grad"] = max(worst["grad"], (rel, name))
            exact = g.abs() >= ADAM_EXACT
            for kind, where in (("param", exact), ("near0", ~exact)):
                if bool(where.any()):
                    worst[kind] = max(worst[kind],
                                      (float(diff[where].max()), name))
        return worst

    problems = []
    for key, bar in (("loss", bars["loss"]), ("sparse_loss", bars["loss"]),
                     ("grad_norm", bars["norm"])):
        if key not in plain[0]:
            continue
        a, b = kernel[0][key], plain[0][key]
        rel = abs(a - b) / abs(b)
        if bars["base"] == "moved":     # the perturbed plain route's move
            bar = max(bar, SPREAD_MARGIN * abs(perturbed[0][key] - b)
                      / abs(b))
        print(f"{label} kernel vs plain: {key} {a:.7g} vs {b:.7g}, "
              f"relative difference {rel:.3e} (bar {bar:.3g})")
        if not (math.isfinite(a) and rel <= bar):
            problems.append(f"{label} {key}")
    spread = compare(again, plain)
    moved = compare(perturbed, plain)
    base = spread if bars["base"] == "spread" else moved
    base_label = ("plain vs plain" if bars["base"] == "spread" else
                  f"plain vs plain perturbed by {bars['perturb']:g}")

    def check(what, got, base, bar, base_label):
        limit = max(bar, SPREAD_MARGIN * base[0])
        print(f"{label} {what}: {got[0]:.3e} ({got[1]}); {base_label} "
              f"{base[0]:.3e} ({base[1]}); bar {limit:.3g}")
        if not got[0] <= limit:
            problems.append(f"{label} {what}")
        return limit

    insitu = compare(kernel_plain_bwd, kernel)
    moved_label = f"plain vs plain perturbed by {bars['perturb']:g}"
    check("backward kernels in situ (kernel route, its backward vs "
          "autograd through the plain versions), gradients max|diff| / "
          "max|plain|", insitu["grad"], base["grad"], bars["grad"],
          base_label)
    got = compare(kernel, plain)
    limit = check("kernel vs plain, gradients max|diff| / max|plain| (the "
                  "conv biases a norm cancels left out)", got["grad"],
                  moved["grad"], bars["grad"], moved_label)
    if control is not None:
        with plain_route(*mods):
            ctrl = compare(kernel, step(control))["grad"]
        gate = bars.get("control", False)
        print(f"{label} control, kernel route vs the plain route without "
              f"the lever, gradients max|diff| / max|plain|: {ctrl[0]:.3e} "
              f"({ctrl[1]}); " + (f"must exceed the bar {limit:.3g}" if gate
                                  else f"(the bar {limit:.3g}; not a gate)"))
        if gate and not ctrl[0] > limit:
            problems.append(f"{label} control within the gradient bar")
    check(f"kernel vs plain, parameters after one AdamW update at lr "
          f"{lr:.3g} where |gradient| >= {ADAM_EXACT:g}", got["param"],
          moved["param"], bars["param"], moved_label)
    check("kernel vs plain, parameters elsewhere", got["near0"], (0.0, ""),
          2 * lr, "bound 2 lr")
    check("kernel vs plain, BN running statistics", got["bn"], base["bn"],
          bars["bn"], base_label)
    if any(r[0]["skipped_steps"] for r in (kernel, plain)):
        problems.append(f"the kernel-vs-plain {label} was skipped")
    return launches, problems


def train_against_plain(torch, pkg, weights):
    """RAFT's train step (B=2, 184x248, iters=4, chairs defaults) from the
    fixture weights against the plain versions (``step_against_plain``)."""
    tcfg = pkg.TrainConfig(batch_size=CMP_B, image_size=CMP_HW,
                           iters=CMP_ITERS, num_steps=100)
    batch = synthetic_batch(torch, CMP_B, CMP_HW,
                            torch.Generator(device=DEVICE).manual_seed(1))

    def make_model():
        model = pkg.RAFT(pkg.RAFTConfig(alternate_corr=True))
        model.load_state_dict(weights)
        return model

    return step_against_plain(torch, pkg, "train step", make_model, tcfg,
                              batch, cancelled_by_norm, alternate_corr=True)


def sparse_train_against_plain(torch, pkg):
    """SparseRAFT's train step at full OursConfig widths with dropout 0
    (B=2, 352x480, ``sparse_lambda=0.1``), random weights from seed 1,
    against the plain versions (``step_against_plain``)."""
    tcfg = pkg.TrainConfig(model_family="sparse", batch_size=SPARSE_CMP_B,
                           image_size=SPARSE_HW, num_steps=100,
                           sparse_lambda=SPARSE_LAMBDA)
    batch = synthetic_batch(torch, SPARSE_CMP_B, SPARSE_HW,
                            torch.Generator(device=DEVICE).manual_seed(6))

    def make_model():
        return pkg.SparseRAFT(pkg.OursConfig(dropout=0.0)).init_weights(
            torch.Generator().manual_seed(1))

    return step_against_plain(torch, pkg, "sparse train step", make_model,
                              tcfg, batch, sparse_cancelled_by_norm)


def train_full_size(torch, pkg, weights_path, mcfg=None, label="f32",
                    update_impl="step"):
    """RAFT-large (``mcfg``, float32 by default) through
    ``raft_tpu_torch.train.train`` at the chairs defaults (B=8, 368x496,
    iters=12, lr 4e-4 one-cycle, AdamW, clip 1.0, gamma 0.8, batch norm
    training) from the fixture weights, on synthetic batches made on the
    card (the same batches for every config), on ``update_impl``, 2
    warm-up and 5 timed steps,
    with every launch counter set to 0 just before. Returns (state, tcfg,
    ms per timed step, launches, peak MiB, every step's loss)."""
    mcfg = pkg.RAFTConfig() if mcfg is None else mcfg
    steps = TRAIN_WARMUP + TRAIN_TIMED
    tcfg = pkg.TrainConfig(batch_size=TRAIN_B, image_size=TRAIN_HW,
                           iters=TRAIN_ITERS, num_steps=steps)
    loader = DeviceLoader(torch, steps, TRAIN_B, TRAIN_HW, seed=2)
    logged = []

    class Logger:
        def push(self, metrics, lr):
            logged.append((metrics, lr))

    torch.cuda.reset_peak_memory_stats()
    reset_counts(pkg.counters)
    state = pkg.train(tcfg, mcfg, dataloader=loader,
                      restore_ckpt=weights_path, device=DEVICE,
                      logger=Logger(), update_impl=update_impl)
    torch.cuda.synchronize()
    end = time.perf_counter()
    launches = read_counts(pkg.counters)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    ms = [1e3 * (b - a) for a, b in zip(loader.pulls,
                                         loader.pulls[1:] + [end])]
    if state.step != steps or len(logged) != steps:
        fail(f"train() [{label}] took {state.step} steps, expected {steps}")
    print(f"train [{label}]:")
    for n, (m, lr) in enumerate(logged):
        print(f"  step {n}: loss {m['loss']:.5f}, grad_norm "
              f"{m['grad_norm']:.4f}, epe {m['epe']:.4f}, lr {lr:.4g}, "
              f"{ms[n]:.1f} ms{' (warm-up)' if n < TRAIN_WARMUP else ''}")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and not m["skipped_steps"]):
            fail(f"train step {n} [{label}] was not finite or was skipped")
    start = pkg.load_npz(weights_path)
    still = [n for n, p in state.model.named_parameters()
             if torch.equal(p.detach().cpu(), start[n])]
    if still:
        fail(f"{len(still)} parameters did not change in training "
             f"[{label}]: {still[:3]}")
    block = state.model.update_block
    bf16 = mcfg.mixed_precision
    for module, pack in (
            (block.encoder, pkg.motion_cuda.pack_weights_bf16 if bf16
             else pkg.motion_cuda.pack_weights),
            (block.gru, pkg.gru_cuda.pack_weights_bf16 if bf16
             else pkg.gru_cuda.pack_weights)):
        cached = (module.packed_weights_bf16() if bf16
                  else module.packed_weights())
        if not all(torch.equal(a, b) for a, b in
                   zip(cached, pack(module.convs()))):
            fail("a packed-weight cache was not refreshed after the "
                 "optimizer's updates")
    return (state, tcfg, ms[TRAIN_WARMUP:], launches, peak_mib,
            [m["loss"] for m, _ in logged])


def sparse_train_full_size(torch, pkg, label, batch, enc, warmup, timed):
    """SparseRAFT f32 at full OursConfig widths (``encoder_iterations``
    ``enc``, dropout 0.1) through ``raft_tpu_torch.train.train`` at
    352x480 with ``sparse_lambda=0.1``, random weights from the config's
    seed, on shifted frames made on the card, ``warmup`` + ``timed`` steps
    with every launch counter set to 0 just before. Returns (state, ms per
    timed step, launches, peak MiB)."""
    steps = warmup + timed
    tcfg = pkg.TrainConfig(model_family="sparse", batch_size=batch,
                           image_size=SPARSE_HW, num_steps=steps,
                           sparse_lambda=SPARSE_LAMBDA)
    cfg = pkg.OursConfig(encoder_iterations=enc)
    loader = DeviceLoader(torch, steps, batch, SPARSE_HW, seed=7)
    logged = []

    class Logger:
        def push(self, metrics, lr):
            logged.append((metrics, lr))

    torch.cuda.reset_peak_memory_stats()
    reset_counts(pkg.counters)
    state = pkg.train(tcfg, cfg, dataloader=loader, device=DEVICE,
                      logger=Logger())
    torch.cuda.synchronize()
    end = time.perf_counter()
    launches = read_counts(pkg.counters)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    ms = [1e3 * (b - a) for a, b in zip(loader.pulls,
                                         loader.pulls[1:] + [end])]
    if state.step != steps or len(logged) != steps:
        fail(f"sparse train() [{label}] took {state.step} steps, expected "
             f"{steps}")
    for n, (m, lr) in enumerate(logged):
        print(f"  step {n}: loss {m['loss']:.5f}, sparse_loss "
              f"{m['sparse_loss']:.5f}, grad_norm {m['grad_norm']:.4f}, epe "
              f"{m['epe']:.4f}, lr {lr:.4g}, {ms[n]:.1f} ms"
              f"{' (warm-up)' if n < warmup else ''}")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and not m["skipped_steps"]):
            fail(f"sparse train step {n} [{label}] was not finite")
    start = pkg.SparseRAFT(cfg).init_weights(
        torch.Generator().manual_seed(tcfg.seed)).state_dict()
    still = [n for n, p in state.model.named_parameters()
             if torch.equal(p.detach().cpu(), start[n])]
    if still:
        fail(f"{len(still)} SparseRAFT parameters did not change in "
             f"training: {still[:3]}")
    return state, tcfg, ms[warmup:], launches, peak_mib


# Categories of a train step's device time (profile_train_step), in order
# of precedence: a kernel belongs to the first whose marker names the
# kernel or one of the profiler ranges around its launch.
TRAIN_SPLIT = (
    ("forward kernels (corr_fwd, update_step)",
     ("corr_fwd_kernel", "corr_fwd_bf16_kernel", "update_step_kernel",
      "update_step_bf16_kernel")),
    ("step kernel's plain recompute (backward)", ("RecomputeFnBackward",)),
    ("corr_bwd (backward)", ("WindowedCorrelationFnBackward",)),
    ("optimizer, clipping and guard",
     ("Optimizer.", "train_step.guard_and_clip")),
    ("encoders (forward)", ("raft.encoders",)),
    ("encoders, heads, upsampling, loss (backward)",
     ("autograd::engine::evaluate_function",)))
DEFAULT_SPLIT = "heads, upsampling, loss (forward)"
# The same time by kernel name alone, a check on the split above.
NAME_SPLIT = (("corr_fwd, update_step (forward kernels)",
               ("corr_fwd_kernel", "corr_fwd_bf16_kernel",
                "update_step_kernel", "update_step_bf16_kernel")),
              ("corr_bwd", ("corr_bwd_kernel", "corr_bwd_bf16_kernel")),
              ("cuDNN convolutions and GEMMs",
               ("xmma", "cudnn", "conv", "gemm", "wgrad", "dgrad")),
              ("optimizer (multi-tensor kernels)", ("multi_tensor",)))


def device_events(torch, prof):
    """The profile's device activity (kernels, copies, sets), without the
    ranges the profiler mirrors onto the device's timeline (user
    annotations, which carry the name of a host range)."""
    host = {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in host]


def busy_ms(events) -> float:
    """The time the device was busy: the union of the events' spans, so
    that events which overlap (copies beside kernels, kernels on other
    streams) count once. The sum of their durations, the device time the
    shares below divide, can exceed it."""
    total, end = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def overlaps(events, top: int = 3):
    """Where device events ran at once: the streams the events ran on, and
    the overlapped time by (earlier, later) kernel name, largest first.
    Each event is set against the one with the latest end before it; the
    sum of durations less busy_ms is the exact overlapped total."""
    from collections import defaultdict

    streams = sorted({e.device_resource_id for e in events})
    pairs = defaultdict(lambda: [0.0, 0])
    last = None
    for e in sorted(events, key=lambda e: e.time_range.start):
        if last is not None and e.time_range.start < last.time_range.end:
            key = (last.name, e.name)
            pairs[key][0] += (min(e.time_range.end, last.time_range.end)
                              - e.time_range.start) / 1e3
            pairs[key][1] += 1
        if last is None or e.time_range.end > last.time_range.end:
            last = e
    return streams, sorted(pairs.items(), key=lambda kv: -kv[1][0])[:top]


def print_overlaps(label, events, device_ms, busy):
    streams, pairs = overlaps(events)
    print(f"{label}: {device_ms - busy:.3f} ms of device time overlaps "
          f"other device events; streams {streams}")
    for (first, then), (ms, n) in pairs:
        print(f"  {ms:8.3f} ms {n:5d}x  {first[:60]}  ||  {then[:60]}")


def profile_train_step(torch, step_fn, state, batch, label="train profile",
                       top: int = 8):
    """One train step under torch.profiler: device time split by
    TRAIN_SPLIT (else DEFAULT_SPLIT) from the host ranges around each
    kernel's launch, by kernel name (NAME_SPLIT), and the ``top`` kernels
    by device time. Returns the split by host ranges, and under "busy_ms",
    "wall_ms" and "launches" the device's busy time, the profiled wall and
    the device events."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = device_events(torch, prof)
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    if not device_ms:
        print(f"{label}: the profiler recorded no device time "
              "(not measured)")
        return {}
    busy = busy_ms(events)
    print_overlaps(label, events, device_ms, busy)
    print(f"{label}: one step at B={TRAIN_B} {TRAIN_HW[0]}x"
          f"{TRAIN_HW[1]} iters={TRAIN_ITERS}: device busy {busy:.2f} ms of "
          f"{wall_ms:.2f} ms wall under the profiler "
          f"({100 * busy / wall_ms:.1f}%), device time {device_ms:.2f} ms, "
          f"{len(events)} device events")
    kernel_names = {e.name for e in events}
    split = defaultdict(lambda: [0.0, 0])

    def visit(evt, rank):
        for i, (_, marks) in enumerate(TRAIN_SPLIT[:rank]):
            if any(m in evt.name for m in marks):
                rank = i
                break
        for k in evt.kernels:
            if k.name not in kernel_names:      # a mirrored host range
                continue
            cat = rank
            if any(m in k.name for m in TRAIN_SPLIT[0][1]):
                cat = 0
            split[cat][0] += k.duration / 1e3
            split[cat][1] += 1
        for child in evt.cpu_children:
            visit(child, rank)

    for evt in prof.events():
        if evt.cpu_parent is None and \
                evt.device_type == torch.autograd.DeviceType.CPU:
            visit(evt, len(TRAIN_SPLIT))
    print(f"  by the host ranges around each launch "
          f"({sum(t for t, _ in split.values()):.2f} ms attributed):")
    out = {}
    for cat, (ms, n) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        name = TRAIN_SPLIT[cat][0] if cat < len(TRAIN_SPLIT) else \
            DEFAULT_SPLIT
        out[name] = ms
        print(f"  {ms:9.3f} ms {100 * ms / device_ms:5.1f}% {n:6d}x  {name}")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        cat = next((c for c, marks in NAME_SPLIT
                    if any(m in e.name.lower() for m in marks)),
                   "elementwise, norms, reductions, copies")
        by_name[cat][0] += e.time_range.elapsed_us() / 1e3
        by_name[cat][1] += 1
    print("  by kernel name:")
    for cat, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.3f} ms {100 * ms / device_ms:5.1f}% {n:6d}x  {cat}")
    kernels = defaultdict(lambda: [0.0, 0])
    for e in events:
        kernels[e.name][0] += e.time_range.elapsed_us() / 1e3
        kernels[e.name][1] += 1
    print(f"  top {top} device operations:")
    for name, (ms, n) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:9.3f} ms {100 * ms / device_ms:5.1f}% {n:6d}x  "
              f"{name[:90]}")
    out.update(busy_ms=busy, wall_ms=wall_ms, launches=len(events))
    return out


def msda_inputs(torch, rng, b, lq, d, m=8, p=4, levels=SPARSE_LEVELS):
    """value, locations over [-0.1, 1.1] and softmaxed weights at one MSDA
    shape, on the card."""
    dev = torch.device("cuda")
    s = sum(h * w for h, w in levels)
    nl = len(levels)

    def put(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)
    value = put(rng.standard_normal((b, s, m, d)))
    loc = put(rng.uniform(-0.1, 1.1, (b, lq, m, nl, p, 2)))
    aw = torch.softmax(put(rng.standard_normal((b, lq, m, nl * p))), -1)
    return value, loc, aw.reshape(b, lq, m, nl, p).contiguous()


def msda_coherent_inputs(torch, rng, b, d, m=8, p=4, levels=SPARSE_LEVELS):
    """What the dense encoder samples: every token a query at its reference
    point (``DeformableTransformerEncoder.get_reference_points``) plus the
    sampling heads' initial offsets (``_directional_bias``, in pixels of
    each level, as ``MSDeformAttn`` scales them) with 0.5 px of seeded
    noise; value and softmaxed weights as ``msda_inputs``. On the card."""
    from raft_tpu_torch.models.deformable import (
        DeformableTransformerEncoder, _directional_bias)

    dev = torch.device("cuda")
    nl = len(levels)
    ref = DeformableTransformerEncoder.get_reference_points(levels, dev)
    lq = ref.shape[1]

    def put(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)
    off = (put(_directional_bias(m, nl, p)).view(1, 1, m, nl, p, 2)
           + put(rng.normal(0.0, 0.5, (b, lq, m, nl, p, 2))))
    norm = put([[w, h] for h, w in levels]).view(1, 1, 1, nl, 1, 2)
    loc = (ref[:, :, None, :, None, :] + off / norm).contiguous()
    value = put(rng.standard_normal((b, lq, m, d)))
    aw = torch.softmax(put(rng.standard_normal((b, lq, m, nl * p))), -1)
    return value, loc, aw.reshape(b, lq, m, nl, p).contiguous()


def msda_against_plain(torch, msda, msda_cuda, value, loc, aw, g, what,
                       err):
    """msda_fwd and msda_bwd on these inputs against their plain versions:
    fails beyond TOL, or CORR_BWD_REL of the largest plain gradient for
    each of the three gradients. Updates ``err``; returns the backward's
    worst relative error."""
    with torch.inference_mode():
        got = msda_cuda.ms_deform_attn_cuda(value, SPARSE_LEVELS, loc, aw)
        want = msda.ms_deform_attn_plain(value, SPARSE_LEVELS, loc, aw)
    got_d = msda_cuda.ms_deform_attn_bwd_cuda(value, SPARSE_LEVELS, loc, aw,
                                              g)
    want_d = msda.ms_deform_attn_bwd_plain(value, SPARSE_LEVELS, loc, aw, g)
    torch.cuda.synchronize()
    d = float((got - want).abs().max())
    diffs = [float((a - b).abs().max()) for a, b in zip(got_d, want_d)]
    rels = [e / float(b.abs().max()) for e, b in zip(diffs, want_d)]
    err["msda_fwd"] = max(err["msda_fwd"], d)
    err["msda_bwd"] = max(err["msda_bwd"], *diffs)
    print(f"msda {what}: msda_fwd max|kernel - plain| = {d:.3e} (bar "
          f"{TOL:g}); msda_bwd / max|plain| d_value {rels[0]:.3e}, d_loc "
          f"{rels[1]:.3e}, d_aw {rels[2]:.3e} (bar {CORR_BWD_REL:g})")
    if not (d <= TOL and max(rels) <= CORR_BWD_REL):
        fail(f"an MSDA kernel disagrees with its plain version at {what}")
    return max(rels)


def msda_timings(torch, msda, msda_cuda, rng, shapes, err):
    """msda_fwd and msda_bwd at the decoder's and the encoder's shapes on
    the incoherent input of ``msda_inputs`` and at the encoder's on the
    coherent one of ``msda_coherent_inputs``: each input held against the
    plain versions at the forward's default slots and with each of
    MSDA_FORCE's (msda_against_plain, which updates ``err``), the forward
    timed at each and the backward once by ``queued_ms``
    (device time); the incoherent inputs at the default slots also by
    ``time_ms`` (the rows' ``ms``, as before) with the plain version's ms
    and the work. Returns ({"fwd": {input: row}, "bwd": {...}}, the worst
    msda_bwd error relative to the largest plain gradient)."""
    out = {"fwd": {}, "bwd": {}}
    worst = 0.0
    cases = [(f"{label} incoherent", b, lq, d) for label, (b, lq, d)
             in shapes.items()] + [("encoder coherent", *shapes["encoder"])]
    default = msda_cuda.FWD_SLOTS
    try:
        for key, b, lq, d in cases:
            if key == "encoder coherent":
                value, loc, aw = msda_coherent_inputs(torch, rng, b, d)
            else:
                value, loc, aw = msda_inputs(torch, rng, b, lq, d)
            g = torch.randn(b, lq, 8 * d, device="cuda")
            shape = f"B={b} Lq={lq} M=8 D={d} L=6 P=4"
            rows = {"fwd": {"shape": shape}, "bwd": {"shape": shape}}
            for path, forced in (("default", default), *MSDA_FORCE.items()):
                msda_cuda.FWD_SLOTS = forced
                slots = msda_cuda.fwd_slots(d)
                rel = msda_against_plain(
                    torch, msda, msda_cuda, value, loc, aw, g,
                    f"{key} {shape}, {path} ({slots} slots a group)", err)
                worst = max(worst, rel)
                suffix = "" if path == "default" else f"_{path}"
                with torch.inference_mode():
                    rows["fwd"][f"ms_q{suffix}"] = queued_ms(
                        torch, lambda: msda_cuda.ms_deform_attn_cuda(
                            value, SPARSE_LEVELS, loc, aw))
                if path == "default":
                    rows["bwd"]["ms_q"] = queued_ms(
                        torch, lambda: msda_cuda.ms_deform_attn_bwd_cuda(
                            value, SPARSE_LEVELS, loc, aw, g))
                    rows["fwd"]["slots"] = slots
            msda_cuda.FWD_SLOTS = default
            if key.endswith("incoherent"):
                with torch.inference_mode():
                    rows["fwd"]["ms"] = time_ms(
                        torch, lambda: msda_cuda.ms_deform_attn_cuda(
                            value, SPARSE_LEVELS, loc, aw))
                    rows["fwd"]["plain_ms"] = time_ms(
                        torch, lambda: msda.ms_deform_attn_plain(
                            value, SPARSE_LEVELS, loc, aw), n=10)
                rows["bwd"]["ms"] = time_ms(
                    torch, lambda: msda_cuda.ms_deform_attn_bwd_cuda(
                        value, SPARSE_LEVELS, loc, aw, g))
                rows["bwd"]["plain_ms"] = time_ms(
                    torch, lambda: msda.ms_deform_attn_bwd_plain(
                        value, SPARSE_LEVELS, loc, aw, g), n=10)
            rows["fwd"]["work"] = msda_work(torch, value, SPARSE_LEVELS, loc,
                                            aw)
            rows["bwd"]["work"] = msda_bwd_work(torch, value, SPARSE_LEVELS,
                                                loc, aw)
            for kind in ("fwd", "bwd"):
                rows[kind]["bound_ms"], rows[kind]["bound_by"] = bound(
                    *rows[kind]["work"])
                out[kind][key] = rows[kind]
    finally:
        msda_cuda.FWD_SLOTS = default
    return out, worst


def msda_corners(torch, value, levels, loc):
    """The in-range corners of every sample on these inputs, and the
    distinct value rows (pixel, head) they touch."""
    b, s, m, d = value.shape
    corners, rows = 0, []
    start = 0
    bi = torch.arange(b, device=loc.device).view(b, 1, 1, 1)
    mi = torch.arange(m, device=loc.device).view(1, 1, m, 1)
    for lvl, (h, w) in enumerate(levels):
        px = loc[:, :, :, lvl, :, 0] * w - 0.5
        py = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(px).long(), torch.floor(py).long()
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = x0 + dx, y0 + dy
                ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                corners += int(ok.sum())
                pix = start + y * w + x
                rows.append(((bi * s + pix) * m + mi)[ok])
        start += h * w
    return corners, int(torch.unique(torch.cat(rows)).numel())


def msda_work(torch, value, levels, loc, aw):
    """Operations and bytes of one MSDA call on these inputs: 2 D
    operations for each in-range corner and 12 for each sample's corner
    weights; the locations and weights read once, the output written once,
    and each distinct value row (pixel, head) that an in-range corner
    touches read once."""
    b, s, m, d = value.shape
    lq = loc.shape[1]
    corners, distinct = msda_corners(torch, value, levels, loc)
    flops = 2 * d * corners + 12 * aw.numel()
    nbytes = 4 * (loc.numel() + aw.numel() + b * lq * m * d + distinct * d)
    return flops, nbytes


def msda_bwd_work(torch, value, levels, loc, aw):
    """Operations and bytes of one MSDA backward on these inputs: 4 D
    operations for each in-range corner (the cotangent's dot with the
    corner, the value gradient's product and add) and 32 for each sample
    (corner weights, the weight and location gradients); the locations,
    weights and cotangent read once, each distinct value row that an
    in-range corner touches read once, and the three gradients written
    once (d_value whole: the kernel writes every element)."""
    b, s, m, d = value.shape
    lq = loc.shape[1]
    corners, distinct = msda_corners(torch, value, levels, loc)
    flops = 4 * d * corners + 32 * aw.numel()
    nbytes = 4 * (2 * loc.numel() + 2 * aw.numel() + b * lq * m * d
                  + distinct * d + value.numel())
    return flops, nbytes


def sparse_corr_inputs(torch, rng, b, h, w, c):
    """The fork lookup at one token level: fmap1, a 2-level pooled pyramid
    of fmap2 and the half-pixel centres, on the card."""
    from raft_tpu_torch.models import corr

    dev = torch.device("cuda")
    f1 = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=torch.float32,
                      device=dev)
    pyr = corr.build_feature_pyramid(torch.tensor(
        rng.standard_normal((b, h, w, c)), dtype=torch.float32, device=dev),
        2)
    ys = torch.arange(h, device=dev) + 0.5
    xs = torch.arange(w, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    centers = torch.stack([gx, gy], -1)[None].expand(b, h, w, 2).contiguous()
    return f1, pyr, centers


def sparse_frames(batch, seed):
    """``batch`` seeded 352x480 pairs in [0, 255], the second frame the
    first moved by (5, -3) px."""
    rng = np.random.default_rng(seed)
    img1 = rng.uniform(0, 255, (batch, *SPARSE_HW, 3)).astype(np.float32)
    return img1, np.roll(img1, (-3, 5), axis=(1, 2))


def serve_sparse(torch, predictor, frames, counters):
    """One warm-up forward of the batch, then SPARSE_TIMED forwards with
    every launch counter set to 0 just before. Returns (ms per forward,
    {kernel: launches}, the last flow_up)."""
    predictor.predict_batch(*frames)
    torch.cuda.synchronize()
    reset_counts(counters)
    times = []
    for _ in range(SPARSE_TIMED):
        t0 = time.perf_counter()
        _, flow_up = predictor.predict_batch(*frames)
        times.append(1e3 * (time.perf_counter() - t0))
    launches = read_counts(counters)
    want = (frames[0].shape[0], *SPARSE_HW, 2)
    if flow_up.shape != want or not np.isfinite(flow_up).all():
        fail(f"sparse flow has shape {flow_up.shape} (expected {want}) or "
             f"non-finite values")
    return times, launches, flow_up


def sparse_against_plain(torch, pkg, predictor, frames, flow_kernel, label):
    """The kernel route's flow_up against the plain route's (every
    dispatcher its plain version) on the same batch, and the plain route's
    own move under PERTURB relative noise. Returns a problem or None."""
    mods = (pkg.corr_cuda, pkg.step_cuda, pkg.motion_cuda, pkg.gru_cuda,
            pkg.msda)
    with plain_route(*mods):
        _, plain = predictor.predict_batch(*frames)
    with plain_route(*mods, perturb=torch.Generator(
            device=DEVICE).manual_seed(5)):
        _, moved = predictor.predict_batch(*frames)
    scale = float(np.abs(plain).max())
    got = float(np.abs(flow_kernel - plain).max())
    spread = float(np.abs(moved - plain).max())
    bar = max(SPARSE_FLOW_PX, SPARSE_FLOW_REL * scale)
    print(f"sparse [{label}] kernel vs plain route: flow_up max|diff| "
          f"{got:.3e} px (max|flow| {scale:.3f} px; bar {bar:.3g}); plain vs "
          f"plain perturbed by {PERTURB:g}: {spread:.3e}")
    if got <= bar:
        return None
    limit = SPREAD_MARGIN * spread
    print(f"sparse [{label}] kernel vs plain route: above the bar; held to "
          f"{SPREAD_MARGIN:g} x the plain route's spread instead, "
          f"{limit:.3g} px: {'pass' if got <= limit else 'FAIL'}")
    return None if got <= limit else f"sparse [{label}] kernel vs plain"


# Categories of a sparse forward's or train step's (or a stream frame's)
# device time by kernel name, in order of precedence (profile_by_name).
SPARSE_SPLIT = (
    ("msda_fwd", ("msda_fwd_kernel",)),
    ("msda_bwd", ("msda_bwd_kernel",)),
    ("corr_fwd", ("corr_fwd_kernel",)),
    ("corr_bwd", ("corr_bwd_kernel",)),
    ("update_step", ("update_step_kernel",)),
    ("batch, group and layer norms", ("norm", "bn_fw", "bn_bw")),
    ("cuDNN convolutions (implicit GEMM and FFT)",
     ("fprop", "dgrad", "wgrad", "fft", "pointwise_mult_and_sum_complex",
      "convolve", "cudnn", "winograd")),
    ("host-to-device copies", ("memcpy htod",)),
    ("device-to-host copies", ("memcpy dtoh",)))
SPARSE_KERNELS = ("msda_fwd_kernel", "corr_fwd_kernel", "msda_bwd_kernel",
                  "corr_bwd_kernel")


def profile_by_name(torch, run, label, what, top: int = 10,
                    kernels=SPARSE_KERNELS):
    """``run()`` under torch.profiler: device busy share of the (profiled,
    so inflated) wall time, the shares of the device time of ``kernels``
    (the corr and MSDA kernels), the top device operations by time and the
    split by SPARSE_SPLIT. Returns the kernels' shares."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = defaultdict(lambda: [0.0, 0])
    events = device_events(torch, prof)
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    device_ms = sum(t for t, _ in by_name.values())
    if not device_ms:
        print(f"{label}: the profiler recorded no device time (not "
              f"measured)")
        return {}
    busy = busy_ms(events)
    print_overlaps(label, events, device_ms, busy)
    shares = {}
    for kernel in kernels:
        ms = sum(t for name, (t, _) in by_name.items() if kernel in name)
        n = sum(c for name, (_, c) in by_name.items() if kernel in name)
        shares[kernel] = ms / device_ms
        print(f"{label}: {kernel}: {n} launches, {ms:.3f} ms, "
              f"{100 * ms / device_ms:.1f}% of device time")
    print(f"{label}: {what}: device busy {busy:.2f} ms of "
          f"{wall_ms:.2f} ms wall under the profiler "
          f"({100 * busy / wall_ms:.1f}%), device time {device_ms:.2f} ms, "
          f"{sum(n for _, n in by_name.values())} device launches, "
          f"{len(by_name)} kernel names")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        print(f"  {ms:8.3f} ms {100 * ms / device_ms:5.1f}% {n:5d}x  "
              f"{name[:90]}")
    split = defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in by_name.items():
        cat = next((c for c, marks in SPARSE_SPLIT
                    if any(m in name.lower() for m in marks)),
                   "elementwise, softmax, reductions, GEMMs of the tokens")
        split[cat][0] += ms
        split[cat][1] += n
    print(f"{label} by kernel name:")
    for cat, (ms, n) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:8.3f} ms {100 * ms / device_ms:5.1f}% {n:5d}x  {cat}")
    return shares


def sparse_fixture_check(torch, pkg, counters):
    """The tiny fixture's weights and pair (assets/golden/sparse_tiny.npz)
    through load_predictor on the card, by the kernel route and by the
    plain route, against JAX's stored flow: max|diff| within 1e-4 of
    max(1, max|JAX|), the CPU slice test's bar. Returns a problem or
    None."""
    pred = pkg.load_predictor(pkg.SPARSE_GOLDEN, model_family="sparse")
    with np.load(pkg.SPARSE_GOLDEN) as z:
        img1, img2 = (z[k].astype(np.float32) for k in ("image1", "image2"))
        want = z["flow_up"]
    bar = 1e-4 * max(1.0, float(np.abs(want).max()))
    reset_counts(counters)
    _, kernel = pred(img1, img2)
    launches = read_counts(counters)
    mods = (pkg.corr_cuda, pkg.step_cuda, pkg.motion_cuda, pkg.gru_cuda,
            pkg.msda)
    with plain_route(*mods):
        _, plain = pred(img1, img2)
    cfg = pred.model.config
    check_launches(launches, 1, {
        "corr_fwd": 2 * cfg.num_feature_levels,
        "msda_fwd": cfg.outer_iterations + 2 * cfg.encoder_iterations},
        unit="forward")
    problem = None
    for route, flow in (("kernel", kernel), ("plain", plain)):
        d = float(np.abs(flow - want).max())
        print(f"sparse fixture ({cfg.base_channel}-channel tiny config, "
              f"{img1.shape[0]}x{img1.shape[1]}) [{route} route] vs JAX: "
              f"max|diff| {d:.3e} px, EPE "
              f"{float(np.sqrt(((flow - want) ** 2).sum(-1)).mean()):.3e} "
              f"(bar {bar:.3g})")
        if not d <= bar:
            problem = f"sparse fixture [{route} route] vs JAX"
    return problem


def sparse_corr_times(torch, corr_cuda, rng, sparse_corr, radius, err,
                      backward=False):
    """corr_fwd (or with ``backward`` corr_bwd, for a random cotangent) at
    the fork lookup's three token levels (B=8 at 352x480), each timed
    input first held against the plain version (TOL, or CORR_BWD_REL of
    the largest plain gradient; updates ``err``): the kernel's and the
    plain version's ms a launch, the bounds (3xTF32 and f32 SIMT) and the
    share of (tile, level) blocks on the shared path, keyed by C, for the
    kernel's row."""
    out = {"ms_sparse": {}, "plain_ms_sparse": {}, "bound_ms_sparse": {},
           "bound_ms_f32_simt_sparse": {}, "shared_share_sparse": {}}
    kind = "bwd" if backward else "fwd"
    for c, (h, w) in sparse_corr.items():
        f1, pyr, centers = sparse_corr_inputs(torch, rng, SPARSE_RUNS[0][1],
                                              h, w, c)
        if backward:
            g = torch.randn(*centers.shape[:3],
                            len(pyr) * (2 * radius + 1) ** 2, device="cuda")
            args = (f1, pyr, centers, g, radius)
            kernel = corr_cuda.windowed_correlation_bwd_cuda
            plain = corr_cuda.windowed_correlation_bwd_plain
            work = corr_bwd_work(torch, f1, pyr, centers, radius, False)
        else:
            args = (f1, pyr, centers, radius)
            kernel = corr_cuda.windowed_correlation_cuda
            plain = corr_cuda.windowed_correlation_fused_plain
            work = corr_work(torch, f1, pyr, centers, radius, False)
        corr_cuda.reset_path_counts()
        got = kernel(*args, rescale=False)
        want = plain(*args, rescale=False)
        torch.cuda.synchronize()
        if backward:
            pairs = list(zip((got[0], *got[1]), (want[0], *want[1])))
            d = max(float((a - b).abs().max()) for a, b in pairs)
            off = max(float((a - b).abs().max()) / float(b.abs().max())
                      for a, b in pairs)
            bar = CORR_BWD_REL
        else:
            d = off = float((got - want).abs().max())
            bar = TOL
        err[f"corr_{kind}"] = max(err[f"corr_{kind}"], d)
        print(f"corr_{kind} fork lookup C={c}, timed input: "
              f"{'/ max|plain| ' if backward else 'max|kernel - plain| '}"
              f"= {off:.3e} (bar {bar:g})")
        if not off <= bar:
            fail(f"corr_{kind} disagrees with its plain version at the "
                 f"fork lookup's timed input, C={c}: {off:.3e}")
        out["shared_share_sparse"][str(c)] = shared_share(
            corr_cuda.path_counts()[kind])
        out["ms_sparse"][str(c)] = time_ms(
            torch, lambda: kernel(*args, rescale=False))
        out["plain_ms_sparse"][str(c)] = time_ms(
            torch, lambda: plain(*args, rescale=False), n=10)
        out["bound_ms_sparse"][str(c)] = bound(*work, peak=TF32X3_FLOPS)[0]
        out["bound_ms_f32_simt_sparse"][str(c)] = bound(*work)[0]
    return out


# -- RAFT-small and RAFT's serving entry points ------------------------------
SMALL_WEIGHTS = os.path.join(REPO, "assets", "golden", "weights_small.npz")
SMALL_C = 128                 # RAFT-small's fnet width, its lookup's C
EARLY_EXIT = (0.1, 2)         # bench.py:552-553's defaults
# The golden weights are made from a seed, not trained: the refine does
# not converge, and each sample's mean update norm stays near 0.04 px an
# iteration (0.043-0.045 for the frame with itself, 0.041-0.043 for the
# moved one after the first two iterations, at the Sintel shape). At
# EARLY_EXIT both exit at the earliest (iters_used 3); EE_SPLIT lies between
# the two, so the moved pair exits while the other keeps updating.
EE_SPLIT = (0.042, 2)
EE_SEED = 5
EE_SHIFTS = ((0, 0), (24, -40))   # a frame with itself; a 3 x 5 feature px move
STREAM_WARM_FRAMES, STREAM_WARM_ITERS = 4, 6    # bench.py:1410
STREAM_PX = 1e-3              # refine from encoded maps vs the pair call
STEP_SLOTS, STEP_CHUNK = 4, 4
# (name, admitted before chunk, slot, iters) of the step-granular phase
STEP_REQUESTS = (("a", 0, 0, 12), ("b", 2, 2, 32))


def phase_seconds(name, t0):
    print(f"phase [{name}]: {time.perf_counter() - t0:.1f} s wall")


def max_diff(pairs):
    """The largest max|a - b| over (a, b) pairs of arrays or tensors."""
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in pairs)


def small_goldens(torch, pkg, counters):
    """RAFT-small's goldens through the corr kernel at r=3 (corr_impl
    auto), to tests/test_golden.py's bars; corr_fwd once a refine
    iteration."""
    pred = pkg.load_predictor(SMALL_WEIGHTS, small=True, iters=12)
    if not pred.alternate_corr:
        fail("corr_impl='auto' did not pick the kernel engine for "
             "RAFT-small on the card")
    with open(os.path.join(REPO, "assets", "golden", "manifest.json")) as f:
        pairs = json.load(f)["small"]["pairs"]
    gt_mean = float(np.mean([p["epe_vs_gt"] for p in pairs]))
    reset_counts(counters)
    res = pkg.validate_golden_small(pred)
    launches = read_counts(counters)
    print(f"golden small [corr kernel r=3, cuDNN update block]: parity EPE "
          f"{res['golden_small_parity_epe']:.3e} (bar "
          f"{GOLDEN_PARITY_BAR:g}), GT EPE {res['golden_small_gt_epe']:.4f} "
          f"(manifest {gt_mean:.4f})")
    if not res["golden_small_parity_epe"] < GOLDEN_PARITY_BAR:
        fail("RAFT-small golden parity")
    if not abs(res["golden_small_gt_epe"] - gt_mean) < GOLDEN_GT_BAR:
        fail("RAFT-small golden GT EPE")
    check_launches(launches, len(pairs), {"corr_fwd": 12})


def exit_iters(norms, tol, patience):
    """Each sample's iters_used by the early exit's rule, from its update
    norms (B, iters - 1) of a plain run: consec resets when a norm is not
    below ``tol``, used ticks while the sample is not done, done once
    consec reaches ``patience``; the final iteration adds one."""
    used = []
    for row in norms:
        consec, done, n = 0, False, 0
        for v in row:
            if done:
                break
            consec = consec + 1 if v < tol else 0
            n += 1
            done = consec >= patience
        used.append(n + 1)
    return used


def iteration_against_plain(torch, pkg, model, carry, what, err):
    """One refine iteration's kernels on a serving phase's own state at its
    batch (``carry``, a refine_init carry on the on-demand engine):
    corr_fwd at the carry's coords1 against its plain version, then
    update_step at both depths on that lookup against fused_step_plain,
    each within TOL times max(1, max|plain|): a state's correlations reach
    about 1e3 (the step table's empty slots hold zero frames), where
    float32 spaces its values 1.2e-4 apart. Updates ``err``. Its launches
    are comparisons, made outside the phase's counted run."""
    f1, pyr = carry["corr"]
    radius = model.config.radius
    block = model.update_block
    convs = (block.encoder.convs(), block.gru.convs(),
             block.flow_head.convs())
    packed = (block.encoder.packed_weights(), block.gru.packed_weights(),
              block.flow_head.packed_weights())
    net, inp = carry["net"], carry["inp"]
    coords = carry["coords1"].contiguous()
    flow = (carry["coords1"] - carry["coords0"]).contiguous()
    with torch.inference_mode():
        cor = pkg.corr_cuda.windowed_correlation_cuda(f1, pyr, coords,
                                                      radius)
        checks = [("corr_fwd", "", cor,
                   pkg.corr_cuda.windowed_correlation_fused_plain(
                       f1, pyr, coords, radius))]
        for depth, depth_convs, depth_packed in (
                ("mg", convs[:2] + (None,), packed[:2] + (None,)),
                ("mgf", convs, packed)):
            got = pkg.step_cuda.fused_step_cuda(net, inp, cor, flow,
                                                depth_packed)
            want = pkg.step_cuda.fused_step_plain(net, inp, cor, flow,
                                                  depth_convs)
            if depth == "mg":
                got, want = (got,), (want,)
            for i, (a, b) in enumerate(zip(got, want)):
                checks.append(("update_step",
                               f" '{depth}' {('h2', 'delta')[i]}", a, b))
        torch.cuda.synchronize()
    for name, part, a, b in checks:
        d = float((a - b).abs().max())
        top = float(b.abs().max())
        bar = TOL * max(1.0, top)
        err[name] = max(err[name], d)
        print(f"{name}{part} on the {what} state (B={net.shape[0]} "
              f"{net.shape[1]}x{net.shape[2]}): max|kernel - plain| = "
              f"{d:.3e}, max|plain| {top:.3g} (bar {bar:.3g})")
        if not d <= bar:
            fail(f"{name}{part} disagrees with its plain version on the "
                 f"{what} state: {d:.3e}")


def ee_frames(padder):
    """The early-exit phase's batch, from EE_SEED: one frame paired with
    its roll by each of EE_SHIFTS, padded. Returns (images1, images2)."""
    rng = np.random.default_rng(EE_SEED)
    base = rng.uniform(0, 255, (*SINTEL_HW, 3)).astype(np.float32)
    pairs = [padder.pad(base, np.roll(base, s, axis=(0, 1)))
             for s in EE_SHIFTS]
    return np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])


def early_exit_phase(torch, pkg, model, padder, counters, err):
    """RAFT-large, B=len(EE_SHIFTS) at the Sintel shape, iters=32, early
    exit at EARLY_EXIT and at EE_SPLIT through dispatch_batch(iters=).
    First each sample's update norms over a plain run of the same batch
    (the step entry points, one iteration a chunk) give its expected
    iters_used (exit_iters); each run's iters_used must equal them, and at
    EE_SPLIT the samples must exit at different iterations. Each sample's
    flow is held against the plain run to its iters_used, and the
    iteration's kernels against their plain versions on this batch's
    state. Returns the launches of the EARLY_EXIT run."""
    im1, im2 = ee_frames(padder)
    plain = pkg.FlowPredictor(model, iters=SINTEL_ITERS)
    carry = plain.step_carry_dispatch(im1, im2)
    budget = np.full(len(im1), SINTEL_ITERS, np.int32)
    norms = []
    with torch.inference_mode():
        for _ in range(SINTEL_ITERS - 1):
            prev = carry["coords1"]
            carry, _ = plain.step_dispatch(carry, budget, 1)
            d = carry["coords1"] - prev
            norms.append(torch.sqrt((d * d).sum(-1).mean(dim=(1, 2))))
        norms = torch.stack(norms, 1).cpu().numpy()
    for shift, row in zip(EE_SHIFTS, norms):
        print(f"early exit: shift {shift} px, plain run's mean update norm "
              f"by iteration: {' '.join(f'{v:.4g}' for v in row)}")
    launches = None
    for ee in (EARLY_EXIT, EE_SPLIT):
        pred = pkg.FlowPredictor(model, iters=SINTEL_ITERS, early_exit=ee)
        pred.dispatch_batch(im1, im2, iters=SINTEL_ITERS)
        torch.cuda.synchronize()
        reset_counts(counters)
        t0 = time.perf_counter()
        low, up, used = (t.cpu().numpy() for t in pred.dispatch_batch(
            im1, im2, iters=SINTEL_ITERS))
        ms = 1e3 * (time.perf_counter() - t0)
        counts = read_counts(counters)
        check_launches(counts, 1, {"corr_fwd": SINTEL_ITERS,
                                   "update_step": SINTEL_ITERS},
                       unit="batch")
        launches = launches or counts
        worst = 0.0
        for k in sorted(set(used.tolist())):
            klow, kup = (t.cpu().numpy() for t in plain.dispatch_batch(
                im1, im2, iters=k))
            for i in np.flatnonzero(used == k):
                worst = max(worst, max_diff([(low[i], klow[i]),
                                             (up[i], kup[i])]))
        expected = exit_iters(norms, *ee)
        print(f"early exit: RAFT-large B={len(im1)} "
              f"{im1.shape[1]}x{im1.shape[2]}, iters={SINTEL_ITERS}, "
              f"early_exit={ee}: iters_used {used.tolist()} (from the plain "
              f"run's norms {expected}), {ms:.2f} ms for the batch; "
              f"max|early exit - plain run to iters_used| = {worst:.3e} px "
              f"(bar {TOL:g})")
        if used.tolist() != expected:
            fail(f"early exit at {ee}: iters_used {used.tolist()}, the "
                 f"plain run's norms give {expected}")
        if not np.isfinite(up).all() or not worst <= TOL:
            fail("an early-exited sample disagrees with the plain run to "
                 "its iters_used")
    if len(set(used.tolist())) < 2:
        fail(f"early exit at {EE_SPLIT}: every sample exited at iteration "
             f"{used[0]}, so no sample was frozen while another updated")
    carry = plain.step_carry_dispatch(im1, im2)
    carry["coords1"] = carry["coords0"] + torch.from_numpy(low).cuda()
    iteration_against_plain(torch, pkg, model, carry, "early exit", err)
    return launches


def stream_phase(torch, pkg, model, padder, rng, counters):
    """A stream at the Sintel shape: one cold pair (two encodes, a cold
    refine at iters=32), then STREAM_WARM_FRAMES warm frames (one encode,
    forward_interpolate of the previous flow_low on the host, a warm refine
    at warm_iters), run twice, the second timed and counted. Each pair's or
    frame's time ends with its flow_low and flow_up on the host, as the
    serve phase's pairs do; forward_interpolate's own host time is printed
    beside it. The first warm frame's refine from encoded maps is held
    against the pair call with the same flow_init at iters=32, and that
    frame is profiled once more (profile_by_name). Returns the launches."""
    pred = pkg.FlowPredictor(model, iters=SINTEL_ITERS,
                             warm_iters=STREAM_WARM_ITERS)
    base = rng.uniform(0, 255, (*SINTEL_HW, 3)).astype(np.float32)
    seq = padder.pad(*[np.roll(base, (2 * t, -3 * t), axis=(0, 1))
                       for t in range(STREAM_WARM_FRAMES + 2)])

    def warm_frame(t, low, fm):
        """Frame t after flow_low ``low`` and frame t-1's map ``fm``:
        (flow_low, flow_up) on the host, frame t's map, the flow_init and
        forward_interpolate's ms."""
        fm_next = pred.encode_dispatch(seq[t][None])
        t0 = time.perf_counter()
        init = pkg.forward_interpolate(low)[None]
        interp = 1e3 * (time.perf_counter() - t0)
        low, up = pred.refine_dispatch(seq[t - 1][None], fm, fm_next,
                                       flow_init=init, warm=True)
        return (low[0].cpu().numpy(), up[0].cpu().numpy(), fm_next, init,
                interp)

    def run():
        t0 = time.perf_counter()
        fm_prev = pred.encode_dispatch(seq[0][None])
        fm = pred.encode_dispatch(seq[1][None])
        low, up = pred.refine_dispatch(seq[0][None], fm_prev, fm)
        low, up = low[0].cpu().numpy(), up[0].cpu().numpy()
        cold = 1e3 * (time.perf_counter() - t0)
        warm, interps, first = [], [], None
        for t in range(2, len(seq)):
            t0 = time.perf_counter()
            prev = (low, fm)
            low, up, fm, init, interp = warm_frame(t, low, fm)
            warm.append(1e3 * (time.perf_counter() - t0))
            interps.append(interp)
            if not np.isfinite(up).all():
                fail(f"the stream's warm frame {t} has non-finite flow")
            if first is None:
                first = (t, prev, fm, init)
        return cold, warm, interps, first

    run()
    torch.cuda.synchronize()
    reset_counts(counters)
    cold, warm, interps, (t, (low, fa), fb, init) = run()
    launches = read_counts(counters)
    per_stream = SINTEL_ITERS + STREAM_WARM_FRAMES * STREAM_WARM_ITERS
    check_launches(launches, 1, {"corr_fwd": per_stream,
                                 "update_step": per_stream}, unit="stream")
    a, b = seq[t - 1], seq[t]
    maps = pred.refine_dispatch(a[None], fa, fb, flow_init=init, warm=True,
                                iters=SINTEL_ITERS)
    pair = pred(a, b, flow_init=init[0])
    d = max_diff([(m[0].cpu().numpy(), p) for m, p in zip(maps, pair)])
    print(f"stream: RAFT-large {a.shape[0]}x{a.shape[1]}, one cold pair "
          f"(iters={SINTEL_ITERS}) {cold:.2f} ms, {STREAM_WARM_FRAMES} warm "
          f"frames (warm_iters={STREAM_WARM_ITERS}, one encode each): median "
          f"{statistics.median(warm):.2f} ms/frame (all "
          f"{', '.join(f'{t:.2f}' for t in warm)}), of which "
          f"forward_interpolate on the host median "
          f"{statistics.median(interps):.2f} ms (all "
          f"{', '.join(f'{t:.2f}' for t in interps)}); refine from encoded "
          f"maps vs the pair call with flow_init: max|diff| = {d:.3e} px "
          f"(bar {STREAM_PX:g})")
    if not d < STREAM_PX:
        fail("the stream's refine from encoded maps disagrees with the "
             "pair call")
    profile_by_name(torch, lambda: warm_frame(t, low, fa), "stream profile",
                    f"one warm frame (warm_iters={STREAM_WARM_ITERS})",
                    kernels=("corr_fwd_kernel", "update_step_kernel"))
    return launches


def step_phase(torch, pkg, model, frames, counters, err):
    """A STEP_SLOTS-slot table at the Sintel shape: the STEP_REQUESTS
    admitted before their chunks, stepped in chunks of STEP_CHUNK, each
    finalised once its budget (iters - 1) is spent; each flow against the
    monolithic dispatch_batch(iters=k), and the iteration's kernels
    against their plain versions on the table's last state. Returns the
    launches."""
    pred = pkg.FlowPredictor(model, iters=SINTEL_ITERS)
    zeros = np.zeros((STEP_SLOTS, *frames[0][0].shape), np.float32)
    carry = pred.step_carry_dispatch(zeros, zeros)
    torch.cuda.synchronize()
    remaining = np.zeros(STEP_SLOTS, np.int32)
    pairs = {name: frames[1 + i] for i, (name, *_) in
             enumerate(STEP_REQUESTS)}
    results, chunk, finals = {}, 0, 0
    reset_counts(counters)
    t0 = time.perf_counter()
    while len(results) < len(STEP_REQUESTS):
        for name, at, slot, iters in STEP_REQUESTS:
            if at == chunk:
                im1, im2 = pairs[name]
                carry = pred.step_admit_dispatch(im1[None], im2[None],
                                                 [slot], carry)
                remaining[slot] = iters - 1
        carry, rem = pred.step_dispatch(carry, remaining, STEP_CHUNK)
        remaining = np.maximum(remaining - STEP_CHUNK, 0)
        chunk += 1
        for name, at, slot, iters in STEP_REQUESTS:
            if at < chunk and name not in results and not remaining[slot]:
                low, up = pred.step_finalize_dispatch(carry)
                finals += 1
                results[name] = (low[slot].cpu().numpy(),
                                 up[slot].cpu().numpy())
                if not np.array_equal(rem.cpu().numpy(), remaining):
                    fail(f"step_dispatch's remaining {rem.tolist()} is not "
                         f"the host's {remaining.tolist()}")
    ms = 1e3 * (time.perf_counter() - t0)
    launches = read_counts(counters)
    per_launch = STEP_CHUNK * chunk + finals
    check_launches(launches, 1, {"corr_fwd": per_launch,
                                 "update_step": per_launch}, unit="table")
    worst = 0.0
    for name, at, slot, iters in STEP_REQUESTS:
        im1, im2 = pairs[name]
        want = [t[0].cpu().numpy() for t in pred.dispatch_batch(
            im1[None], im2[None], iters=iters)]
        worst = max(worst, max_diff(zip(results[name], want)))
    print(f"step-granular: {STEP_SLOTS} slots "
          f"{zeros.shape[1]}x{zeros.shape[2]}, requests at iters "
          f"{[r[3] for r in STEP_REQUESTS]} admitted before chunks "
          f"{[r[1] for r in STEP_REQUESTS]}, chunks of {STEP_CHUNK}: "
          f"{chunk} chunks and {finals} finalizes in {ms:.2f} ms; max|step "
          f"- monolithic dispatch_batch(iters=k)| = {worst:.3e} px (bar "
          f"{TOL:g})")
    if not worst <= TOL:
        fail("a step-granular request disagrees with the monolithic "
             "forward")
    iteration_against_plain(torch, pkg, model, carry, "step table", err)
    return launches

# -- the bf16 mixed-precision policy ----------------------------------------

BF16_EPS = 2.0 ** -7          # bfloat16 epsilon
# the bf16 corr form against its plain version: TOL of max(1, max|plain|)
# for float32 windows, BF16_EPS of it for bfloat16 windows (one rounding of
# values that agree to float32 noise); the bf16 step: 8 BF16_EPS of it for
# h2, the JAX package's bar for its bf16 paths (tests/test_step_pallas.py),
# and 8 BF16_EPS of max|plain| for delta, whose updates are far below 1 px
STEP_BF16_REL = 8 * BF16_EPS
# the step-granular refine under the policy: MIXED_ITERS iterations in
# chunks of MIXED_CHUNK against dispatch_batch (bar TOL); a warm frame at
# the predictor's iters (one image a pass through the encoder, where the
# pair call's sees two) against the pair call within STEP_BF16_REL of
# max(1, max|flow|)
MIXED_ITERS = 8
MIXED_CHUNK = 4
# the mixed goldens: the CPU reference's GT EPE within MIXED_BAND (the
# band assets/golden/cpu_reference.json's _comment sets for chip drift at a
# matched policy), its parity EPE plus MIXED_BAND at most
MIXED_BAND = 0.02


def bf16_corr_work(torch, f1, pyramid, coords, radius):
    """corr_work's operations with bfloat16 maps and windows (2 bytes an
    element)."""
    flops, _ = corr_work(torch, f1, pyramid, coords, radius)
    b, h, w, _ = f1.shape
    outputs = b * h * w * len(pyramid) * (2 * radius + 1) ** 2
    return flops, (2 * (f1.numel() + sum(f.numel() for f in pyramid))
                   + 4 * coords.numel() + 2 * outputs)


def bf16_step_work(net, inp, corr, flow, packed, convs):
    """step_work's operations with every activation and weight matrix in
    bfloat16 (biases float32)."""
    flops, _ = step_work(net, inp, corr, flow, packed, convs)
    m = net.shape[0] * net.shape[1] * net.shape[2]
    weights = [t for group in packed if group is not None for t in group]
    nbytes = (2 * (net.numel() + inp.numel() + corr.numel() + flow.numel())
              + sum(t.numel() * t.element_size() for t in weights)
              + 2 * m * net.shape[-1] + (2 * m * 2 if convs[2] else 0))
    return flops, nbytes


def bf16_lookup_checks(torch, corr_cuda, corr, sampling, rng, radius, feat,
                       err):
    """The bf16 form of corr_fwd against its plain version at the Sintel
    (B=1) and chairs (B=8) lookup shapes, C=256, and RAFT-small's lookup
    at Sintel (C=128, r=3), on coherent and incoherent flows, with each
    path forced, for bfloat16 and float32 maps and windows: bfloat16 both
    is the mixed policy's lookup, float32 both corr_mxu_dtype="bfloat16"
    alone. Updates ``err``."""
    default = corr_cuda.TILE_BUDGET
    cases = [(label, b, h, w, flows, 256, radius)
             for label, b, h, w, flows in lookup_cases(feat) if label != "golden"]
    h, w = feat["sintel"]
    cases.append(("sintel", 1, h, w, CORR_FLOWS["sintel"], SMALL_C, 3))
    try:
        for label, b, h, w, flows, c, r in cases:
            for flow, max_px in flows.items():
                f1, pyr, coords = corr_inputs(torch, sampling, corr, rng, h,
                                              w, c=c, flow=flow, b=b,
                                              max_px=max_px)
                for maps, out in (("bfloat16", "bfloat16"),
                                  ("float32", "float32")):
                    dt, odt = getattr(torch, maps), getattr(torch, out)
                    f1m, pyrm = f1.to(dt), tuple(p.to(dt) for p in pyr)
                    with torch.inference_mode():
                        want = corr_cuda.windowed_correlation_fused_plain(
                            f1m, pyrm, coords, r, mxu_dtype="bfloat16",
                            out_dtype=odt).float()
                    top = float(want.abs().max())
                    bar = (BF16_EPS if out == "bfloat16" else TOL) * max(
                        1.0, top)
                    for path, budget in (("warp", 0),
                                         ("shared", FORCE_SHARED)):
                        corr_cuda.TILE_BUDGET = budget
                        corr_cuda.reset_path_counts()
                        with torch.inference_mode():
                            got = corr_cuda.windowed_correlation_bf16_cuda(
                                f1m, pyrm, coords, r, out_dtype=odt)
                        torch.cuda.synchronize()
                        counts = corr_cuda.path_counts()["fwd"]
                        d = float((got.float() - want).abs().max())
                        err["corr_fwd_bf16"] = max(err["corr_fwd_bf16"], d)
                        print(f"corr_fwd_bf16 {label} B={b} {h}x{w} C={c} "
                              f"r={r} {flow}, {maps} maps, {out} "
                              f"windows, {path} path forced [shared "
                              f"{100 * shared_share(counts):.1f}%]: "
                              f"max|kernel - plain| = {d:.3e}, max|plain| "
                              f"{top:.3g} (bar {bar:.3g})")
                        if not d <= bar or got.dtype != odt:
                            fail(f"corr_fwd_bf16 disagrees with its plain "
                                 f"version at {label} C={c} r={r} {flow}, "
                                 f"{maps} maps, {path} path: {d:.3e}")
                        forced = {"warp": 1, "shared": 0}[path]
                        if not counts[forced] > counts[1 - forced]:
                            fail(f"the {path} path was not taken: {counts}")
    finally:
        corr_cuda.TILE_BUDGET = default


def bf16_step_checks(torch, step_cuda, block, inputs, what, err):
    """The bf16 form of update_step at both depths against its plain
    version on bfloat16 ``inputs`` (net, inp, corr, flow); bar STEP_BF16_REL
    of max(1, max|plain|) for h2 (tanh-bounded, JAX's bar) and of
    max|plain| for delta (the flow update, far below 1 px). Updates
    ``err``."""
    convs = (block.encoder.convs(), block.gru.convs(),
             block.flow_head.convs())
    packed = step_cuda.pack_bf16(convs)
    net = inputs[0]
    for depth in ("mg", "mgf"):
        c = convs if depth == "mgf" else convs[:2] + (None,)
        p = packed if depth == "mgf" else packed[:2] + (None,)
        with torch.inference_mode():
            got = step_cuda.fused_step_cuda(*inputs, p)
            want = step_cuda.fused_step_plain(*inputs, c)
        torch.cuda.synchronize()
        if depth == "mg":
            got, want = (got,), (want,)
        for part, a, b in zip(("h2", "delta"), got, want):
            d = float((a.float() - b.float()).abs().max())
            top = float(b.float().abs().max())
            bar = STEP_BF16_REL * (max(1.0, top) if part == "h2" else top)
            err["update_step_bf16"] = max(err["update_step_bf16"], d)
            print(f"update_step_bf16 '{depth}' {part} on {what} (B="
                  f"{net.shape[0]} {net.shape[1]}x{net.shape[2]}): "
                  f"max|kernel - plain| = {d:.3e}, max|plain| {top:.3g} "
                  f"(bar {bar:.3g})")
            if not d <= bar or a.dtype != torch.bfloat16:
                fail(f"update_step_bf16 '{depth}' {part} disagrees with its "
                     f"plain version on {what}: {d:.3e}")


def mixed_goldens(torch, pkg, weights, counters):
    """RAFT-large under the bf16 policy against the goldens through three
    routes, the all-pairs pyramid stored in bfloat16 (corr_impl="fixed")
    and the bf16 corr form (corr_impl="auto"), both with the bf16 step,
    and the bf16 corr form with the bf16 chain (update_impl="chain"): the
    GT EPE within MIXED_BAND of the CPU reference's, the parity EPE at
    most its own plus MIXED_BAND, and every refine iteration through the
    bf16 forms (no float32 form launched). Returns {route: results}."""
    with open(os.path.join(REPO, "assets", "golden",
                           "cpu_reference.json")) as f:
        ref = json.load(f)
    gt_ref = ref["policy_mixed_gt_epe_cpu"]
    parity_bar = ref["policy_mixed_parity_epe_cpu"] + MIXED_BAND
    with open(os.path.join(REPO, "assets", "golden", "manifest.json")) as f:
        pairs = len(json.load(f)["pairs"])
    out = {}
    for route, impl, update_impl, per_pair in (
            ("all-pairs bf16 storage + update_step_bf16", "fixed", "step",
             {"update_step_bf16": 12}),
            ("corr_fwd_bf16 + update_step_bf16", "auto", "step",
             {"corr_fwd_bf16": 12, "update_step_bf16": 12}),
            ("corr_fwd_bf16 + motion_fwd_bf16 + sepconv_gru_bf16", "auto",
             "chain", {"corr_fwd_bf16": 12, "motion_fwd_bf16": 12,
                       "sepconv_gru_bf16": 12})):
        pred = pkg.load_predictor(weights, iters=12, mixed_precision=True,
                                  corr_impl=impl, update_impl=update_impl)
        reset_counts(counters)
        res = pkg.validate_golden(pred)
        launches = read_counts(counters)
        out[route] = res
        print(f"golden mixed [{route}]: parity EPE "
              f"{res['golden_parity_epe']:.4f} (bar {parity_bar:.4f}), GT EPE "
              f"{res['golden_gt_epe']:.4f} (CPU reference {gt_ref:.4f}, "
              f"band {MIXED_BAND})")
        if not res["golden_parity_epe"] <= parity_bar:
            fail(f"mixed golden parity through {route}")
        if not abs(res["golden_gt_epe"] - gt_ref) < MIXED_BAND:
            fail(f"mixed golden GT EPE through {route}")
        check_launches(launches, pairs, per_pair)
    return out


def mixed_serving_checks(torch, pkg, mixed, carry, ims, counters):
    """The serving entry points under the policy on the card: the B=2 slot
    table ``carry`` (step_carry_dispatch of ``ims``) refined in chunks
    (step_dispatch, step_finalize_dispatch) against dispatch_batch at
    MIXED_ITERS, and one warm frame (encode_dispatch of each image,
    refine_dispatch from the maps with a forward_interpolate'd flow_init,
    at the predictor's iters) against the pair call with that flow_init;
    both forms once an iteration in each."""
    im1, im2 = ims
    k = MIXED_ITERS
    reset_counts(counters)
    chunked, rem = mixed.step_dispatch(carry, [k - 1] * len(im1), MIXED_CHUNK)
    chunked, rem = mixed.step_dispatch(chunked, rem, k - 1 - MIXED_CHUNK)
    got = mixed.step_finalize_dispatch(chunked)
    torch.cuda.synchronize()
    check_launches(read_counts(counters), 1, {"corr_fwd_bf16": k,
                                              "update_step_bf16": k},
                   unit="chunked refine")
    want = mixed.dispatch_batch(im1, im2, iters=k)
    d = max_diff((a.cpu(), b.cpu()) for a, b in zip(got, want))
    print(f"mixed step-granular: B={len(im1)} slots, {k - 1} iterations in "
          f"chunks of {MIXED_CHUNK} and a finalize vs dispatch_batch("
          f"iters={k}): max|diff| = {d:.3e} px (bar {TOL:g})")
    if not d <= TOL or got[1].dtype != torch.float32:
        fail("the mixed step-granular refine disagrees with dispatch_batch")
    init = pkg.forward_interpolate(want[0][0].cpu().numpy())[None]
    k = mixed.iters          # the pair call's count
    reset_counts(counters)
    fm1, fm2 = (mixed.encode_dispatch(im[:1]) for im in (im1, im2))
    warm = mixed.refine_dispatch(im1[:1], fm1, fm2, flow_init=init,
                                 warm=True, iters=k)
    torch.cuda.synchronize()
    check_launches(read_counts(counters), 1, {"corr_fwd_bf16": k,
                                              "update_step_bf16": k},
                   unit="warm frame")
    pair = mixed(im1[0], im2[0], flow_init=init[0])
    d = max_diff((a[0].cpu(), b) for a, b in zip(warm, pair))
    bar = STEP_BF16_REL * max(1.0, float(np.abs(pair[1]).max()))
    print(f"mixed warm frame: bfloat16 maps {tuple(fm1.shape)}, refine_dispatch"
          f"(warm, iters={k}) vs the pair call with the same flow_init: "
          f"max|diff| = {d:.3e} px (bar {bar:.3g})")
    if fm1.dtype != torch.bfloat16 or not d <= bar:
        fail("the mixed warm frame disagrees with the pair call")


def mixed_phase(torch, pkg, weights, padder, frames, rng, feat, radius,
                counters, err, f32_times):
    """RAFT-large inference under the bf16 mixed-precision policy: the bf16
    forms of corr_fwd and update_step against their plain versions (and on
    the served model's own B=2 state), the serving entry points
    (mixed_serving_checks), the goldens through two routes, five
    Sintel pairs served at iters=32 with both bf16 forms once an iteration
    (ms/pair beside the float32 path's of this run), one pair profiled, and
    the two forms timed. Returns the kernels' JSON rows."""
    cuobjdump = os.path.join(os.path.dirname(pkg.build.nvcc()), "cuobjdump")
    paths = pkg.build.build(("corr_fwd_bf16", "update_step"))
    sass = {}
    for name, lib in (("corr_fwd_bf16", "corr_fwd_bf16"),
                      ("update_step_bf16", "update_step")):
        ops = tensor_core_bf16_ops(cuobjdump, paths[lib])
        sass[name] = sum(ops.values())
        print(f"  {lib} SASS, tensor-core BF16 MMAs: {ops}")
        if not ops:
            fail(f"{lib} has no tensor-core BF16 MMA in its SASS")
        if lib == "update_step" and widest_hgmma_n(ops) <= 64:
            fail(f"{lib}'s bf16 tile has no warpgroup MMA wider than 64x64x16")
    # the bf16 lookup multiplies in bf16 only, and keeps its registers
    tf32 = tensor_core_tf32_ops(cuobjdump, paths["corr_fwd_bf16"])
    regs, spills = ptxas_usage(paths["corr_fwd_bf16"])
    print(f"  corr_fwd_bf16 SASS, tensor-core TF32 MMAs: {tf32}; ptxas: "
          f"{len(regs)} kernels, registers {min(regs)}-{max(regs)} a thread, "
          f"spill bytes {sum(spills)}")
    if tf32 or sum(spills):
        fail("corr_fwd_bf16 must hold no TF32 MMA and spill nothing")
    corr_cuda, step_cuda = pkg.corr_cuda, pkg.step_cuda
    bf16_lookup_checks(torch, corr_cuda, pkg.corr, pkg.sampling, rng, radius,
                       feat, err)
    mixed = pkg.load_predictor(weights, iters=SINTEL_ITERS,
                               mixed_precision=True)
    if not mixed.alternate_corr:
        fail("corr_impl='auto' did not pick the kernel engine on the card")
    block = mixed.model.update_block
    h, w = feat["sintel"]
    bf = torch.bfloat16
    sintel_inputs = tuple(t.to(bf) for t in update_inputs(torch, rng, h, w))
    bf16_step_checks(torch, step_cuda, block, sintel_inputs, "Sintel inputs",
                     err)
    # the served model's own B=2 state: the corr form at its coords, then
    # the step on that lookup
    carry = mixed.step_carry_dispatch(np.stack([frames[1][0], frames[2][0]]),
                                      np.stack([frames[1][1], frames[2][1]]))
    with torch.inference_mode():
        f1, pyr = carry["corr"]
        coords = carry["coords1"].contiguous()
        cor = corr_cuda.windowed_correlation_bf16_cuda(f1, pyr, coords, radius,
                                                       out_dtype=bf)
        want = corr_cuda.windowed_correlation_fused_plain(
            f1, pyr, coords, radius, mxu_dtype="bfloat16", out_dtype=bf)
    d = float((cor.float() - want.float()).abs().max())
    bar = BF16_EPS * max(1.0, float(want.float().abs().max()))
    err["corr_fwd_bf16"] = max(err["corr_fwd_bf16"], d)
    print(f"corr_fwd_bf16 on the served B=2 state: max|kernel - plain| = "
          f"{d:.3e} (bar {bar:.3g})")
    if not d <= bar:
        fail(f"corr_fwd_bf16 disagrees with its plain version on the served "
             f"state: {d:.3e}")
    flow = (carry["coords1"] - carry["coords0"]).to(bf).contiguous()
    bf16_step_checks(torch, step_cuda, block,
                     (carry["net"], carry["inp"], cor, flow),
                     "the served state", err)
    mixed_serving_checks(torch, pkg, mixed, carry, (
        np.stack([frames[1][0], frames[2][0]]),
        np.stack([frames[1][1], frames[2][1]])), counters)

    goldens = mixed_goldens(torch, pkg, weights, counters)
    torch.cuda.reset_peak_memory_stats()
    times, launches = serve_pairs(torch, mixed, padder, frames, counters)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    shares = print_path_shares(corr_cuda, f"serve mixed: {SERVE_PAIRS} "
                               f"Sintel pairs", ("fwd",))
    ms, f32_ms = statistics.median(times), statistics.median(f32_times)
    print(f"serve mixed: RAFT-large bf16 policy, {SERVE_PAIRS} Sintel pairs "
          f"{SINTEL_HW[0]}x{SINTEL_HW[1]}, iters={SINTEL_ITERS}, B=1: median "
          f"{ms:.2f} ms/pair (all {', '.join(f'{t:.2f}' for t in times)}); "
          f"float32 path {f32_ms:.2f} ms/pair in this run ({f32_ms / ms:.2f}x)"
          f"; peak memory {peak_mib:.1f} MiB")
    check_launches(launches, SERVE_PAIRS, {"corr_fwd_bf16": SINTEL_ITERS,
                                           "update_step_bf16": SINTEL_ITERS})
    profile_pair(torch, mixed, *frames[1], label="profile mixed",
                 per_iteration="update_step_bf16_kernel")

    # the two forms timed on the Sintel shape: the corr form on coherent
    # and incoherent flows (bfloat16 maps and windows; the row's numbers
    # are the incoherent input's, as the float32 row's), and on coherent
    # ones at the chairs shape (B=8) and at RAFT-small's lookup (C=128,
    # r=3); the step at both depths beside cuDNN's bf16 convolutions of the
    # same iteration
    rows = []
    corr_by = {}
    chairs = (TRAIN_B, TRAIN_HW[0] // 8, TRAIN_HW[1] // 8)
    for key, (b, hh, ww), c, r, flow_kind, max_px in (
            ("incoherent", (1, h, w), 256, radius, "incoherent",
             CORR_FLOWS["sintel"]["incoherent"]),
            ("coherent", (1, h, w), 256, radius, "coherent",
             CORR_FLOWS["sintel"]["coherent"]),
            ("chairs coherent", chairs, 256, radius, "coherent",
             CORR_FLOWS["chairs"]["coherent"]),
            ("r=3 coherent", (1, h, w), SMALL_C, 3, "coherent",
             CORR_FLOWS["sintel"]["coherent"])):
        f1, pyr, coords = corr_inputs(torch, pkg.sampling, pkg.corr, rng, hh,
                                      ww, c=c, flow=flow_kind, b=b,
                                      max_px=max_px)
        f1, pyr = f1.to(bf), tuple(p.to(bf) for p in pyr)
        corr_cuda.reset_path_counts()
        with torch.inference_mode():
            run = (lambda f1=f1, pyr=pyr, coords=coords, r=r: (
                corr_cuda.windowed_correlation_bf16_cuda(
                    f1, pyr, coords, r, out_dtype=bf)))
            got = run()
            share = shared_share(corr_cuda.path_counts()["fwd"])
            want = corr_cuda.windowed_correlation_fused_plain(
                f1, pyr, coords, r, mxu_dtype="bfloat16", out_dtype=bf)
            d = float((got.float() - want.float()).abs().max())
            bar = BF16_EPS * max(1.0, float(want.float().abs().max()))
            err["corr_fwd_bf16"] = max(err["corr_fwd_bf16"], d)
            if not d <= bar:
                fail(f"corr_fwd_bf16 disagrees with its plain version at "
                     f"its timed input {key}: {d:.3e}")
            work = bf16_corr_work(torch, f1, pyr, coords, r)
            bound_ms, bound_by = bound(*work, peak=BF16_FLOPS)
            corr_by[key] = {
                "ms": time_ms(torch, run), "ms_q": queued_ms(torch, run),
                "plain_ms": time_ms(torch, lambda: (
                    corr_cuda.windowed_correlation_fused_plain(
                        f1, pyr, coords, r, mxu_dtype="bfloat16",
                        out_dtype=bf)), n=10),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "shared_share": share,
                "shape": f"B={b} {hh}x{ww} C={c} L=4 r={r}, bfloat16 maps "
                         f"and windows, {flow_kind} flows up to {max_px:g} "
                         f"feature px"}
    main_row = corr_by["incoherent"]
    rows.append({
        "name": "corr_fwd_bf16", "route": "cuda",
        "source": "raft_tpu_torch/csrc/corr_fwd_bf16.cu",
        "replaces": "raft_tpu/ops/corr_pallas.py:206", "path": "mixed",
        "launches": launches["corr_fwd_bf16"],
        "launches_per_pair": launches["corr_fwd_bf16"] / SERVE_PAIRS,
        "max_abs_err": err["corr_fwd_bf16"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": None,
        "ms_q": main_row["ms_q"], "shape": main_row["shape"],
        "by_input": corr_by, "shared_share_serve": shares["fwd"],
        "sass_bf16_mma": sass["corr_fwd_bf16"], "registers": [min(regs), max(regs)],
        "spill_bytes": sum(spills)})
    lib_inputs = tuple(nchw(t) for t in sintel_inputs)
    step = {}
    for depth in ("mg", "mgf"):
        convs = (block.encoder.convs(), block.gru.convs(),
                 block.flow_head.convs() if depth == "mgf" else None)
        packed = step_cuda.pack_bf16(convs)
        bf_convs = [None if group is None else
                    [(wt.to(bf), b.to(bf)) for wt, b in group]
                    for group in convs]
        lib = step_library(torch, bf_convs)
        with torch.inference_mode():
            work = bf16_step_work(*sintel_inputs, packed, convs)
            bound_ms, bound_by = bound(*work, peak=BF16_FLOPS)
            run = (lambda: step_cuda.fused_step_cuda(*sintel_inputs,
                                                          packed))
            kernel_ms = time_ms(torch, run)
            step[depth] = dict(
                ms=kernel_ms, ms_q=queued_ms(torch, run),
                plain_ms=time_ms(torch, lambda: step_cuda.fused_step_plain(
                    *sintel_inputs, convs), n=10),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=time_ms(torch, lambda: lib(*lib_inputs)),
                tflops=work[0] / kernel_ms / 1e9)
    for d in step.values():
        d["bound_share_q"] = d["bound_ms"] / d["ms_q"]
    geo = bf16_tile_geometry(torch, pkg.conv_tile,
                             pkg.conv_tile.step_phases(128, 128, 324, True))
    rows.append({
        "name": "update_step_bf16", "route": "cuda",
        "source": "raft_tpu_torch/csrc/update_step.cu",
        "replaces": "raft_tpu/ops/step_pallas.py:127", "path": "mixed",
        "launches": launches["update_step_bf16"],
        "launches_per_pair": launches["update_step_bf16"] / SERVE_PAIRS,
        "max_abs_err": err["update_step_bf16"], **step["mgf"],
        "depth": "mgf", **{f"{k}_mg": v for k, v in step["mg"].items()},
        "shape": f"B=1 {h}x{w}, C=128, Cc=324, bfloat16",
        "sass_bf16_mma": sass["update_step_bf16"], "tile": geo})
    for r in rows:
        extra = (f", queued {r['ms_q']:.4f} ms" if "ms_q" in r else "")
        print(f"{r['name']}: {r['ms']:.4f} ms a launch{extra}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, bf16 tensor cores "
              f"and HBM), plain {r['plain_ms']:.4f} ms, library "
              + ("none" if r["library_ms"] is None
                 else f"{r['library_ms']:.4f} ms (cuDNN bf16)"))
    for depth in ("mgf", "mg"):
        d = step[depth]
        print(f"update_step_bf16 '{depth}': {d['ms']:.4f} ms a launch, queued "
              f"{d['ms_q']:.4f} ms, bound {d['bound_ms']:.4f} ms, "
              f"{100 * d['bound_share_q']:.1f}% of the bound reached (queued), "
              f"plain {d['plain_ms']:.4f} ms, library {d['library_ms']:.4f} ms "
              f"(cuDNN bf16), {d['tflops']:.2f} TFLOP/s")
    print_tile_geometry("update_step_bf16 'mgf'", geo)
    for key, row in corr_by.items():
        print(f"corr_fwd_bf16 {key} ({row['shape']}): {row['ms']:.4f} "
              f"ms a launch (time_ms), queued {row['ms_q']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); shared path on "
              f"{100 * row['shared_share']:.1f}% of (tile, level)s; plain "
              f"{row['plain_ms']:.4f} ms")
    rows[0]["goldens"] = goldens
    rows[0]["ms_per_pair_mixed"] = ms
    rows[0]["ms_per_pair_f32"] = f32_ms
    return rows


# -- the bf16 chain: motion_fwd and sepconv_gru in bfloat16 -------------------

# The bf16 chain forms against their plain versions: max|kernel - plain|
# within STEP_BF16_REL of max(1, max|plain|) (the motion encoder's 126
# features; its flow channels bit for bit), and |kernel - plain| / |plain|
# (2-norms) within CHAIN_BF16_NORM, which the control, the float32 form on
# the same values, must exceed. The largest difference cannot tell a bf16
# form from a float32 one (read on the CPU at the Sintel shape with the
# golden weights and the plain versions: a float32 encoder lies 0.9 bf16
# eps of max(1, max|bf16|) from the bf16 one, the GRU 1.1, against the
# bar's 8); the 2-norm can: another summation order at the same rounding
# points (float64 sums) reads 1.8e-4 (motion) and 5.8e-5 (GRU), the
# float32 control 4.8e-3 and 4.7e-3. Set before the first card run.
CHAIN_BF16_NORM = 1e-3
# RAFT-small's golden aggregates under the bf16 policy from the JAX package
# on the CPU (all-pairs engine, iters=12), which chip_smoke cannot import:
#     JAX_PLATFORMS=cpu python scripts/golden_small_mixed_reference.py
SMALL_MIXED_GT_CPU = 9.206369558970133
SMALL_MIXED_PARITY_CPU = 0.11138821144898732


def size_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bf16_motion_work(flow, corr, packed, convs):
    """motion_work's operations with the bytes of the bf16 form: corr,
    flow and the packed weights read once (bfloat16 matrices, float32
    biases), the bfloat16 [motion | flow] written once."""
    flops, _ = motion_work(flow, corr, packed, convs)
    m = corr.shape[0] * corr.shape[1] * corr.shape[2]
    return flops, size_bytes(corr, flow, *packed) + 2 * m * 128


def bf16_gru_work(hid, parts, packed):
    """gru_work's operations with the bytes of the bf16 form: h, the x
    parts and the packed weights read once, h' written once."""
    m = hid.shape[0] * hid.shape[1] * hid.shape[2]
    c, cx = hid.shape[-1], sum(p.shape[-1] for p in parts)
    flops = 2 * (2 * m * 5 * (c + cx) * 3 * c + 20 * m * c)
    return flops, size_bytes(hid, *parts, *packed) + size_bytes(hid)


def rel_norm(a, b) -> float:
    """|a - b| / |b|, 2-norms, in float32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def bf16_chain_checks(torch, pkg, block, inputs, what, err):
    """The bf16 forms of motion_fwd and sepconv_gru (x as the chain's parts
    and whole) against their plain versions on bfloat16 ``inputs`` (net,
    inp, corr, flow), beside the control, the float32 forms on the same
    values: max|kernel - plain| within STEP_BF16_REL of max(1,
    max|plain|), the 2-norm within CHAIN_BF16_NORM, the control's 2-norm
    above it; the flow channels bit for bit. Updates ``err``; returns the
    readings."""
    motion_cuda, gru_cuda = pkg.motion_cuda, pkg.gru_cuda
    net, inp, cor, flow = inputs
    enc, gru = block.encoder, block.gru
    with torch.inference_mode():
        mot = motion_cuda.motion_encoder_cuda(flow, cor,
                                              enc.packed_weights_bf16())
        plain = motion_cuda.motion_encoder_plain(flow, cor, enc.convs())
        ctrl = motion_cuda.motion_encoder_cuda(flow.float(), cor.float(),
                                               enc.packed_weights())
        cases = [("motion_fwd_bf16", "features", mot[..., :126],
                  plain[..., :126], ctrl[..., :126])]
        for label, x in (("x parts", (inp, plain)),
                         ("x whole", torch.cat([inp, plain], -1))):
            xf = (tuple(t.float() for t in x) if isinstance(x, tuple)
                  else x.float())
            cases.append((
                "sepconv_gru_bf16", label,
                gru_cuda.sepconv_gru_cuda(net, x, gru.packed_weights_bf16()),
                gru_cuda.sepconv_gru_plain(net, x, gru.convs()),
                gru_cuda.sepconv_gru_cuda(net.float(), xf,
                                          gru.packed_weights())))
    torch.cuda.synchronize()
    if mot.dtype != torch.bfloat16 or not torch.equal(mot[..., 126:], flow):
        fail(f"motion_fwd_bf16 did not pass the bfloat16 flow through bit "
             f"for bit on {what}")
    readings = {}
    for name, label, got, want, control in cases:
        top = float(want.float().abs().max())
        bar = STEP_BF16_REL * max(1.0, top)
        d = float((got.float() - want.float()).abs().max())
        dc = float((control - want.float()).abs().max())
        rel, rel_c = rel_norm(got, want), rel_norm(control, want)
        err[name] = max(err[name], d)
        b, h, w = net.shape[:3]
        print(f"{name} {label} on {what} (B={b} {h}x{w}): max|kernel - "
              f"plain| = {d:.3e} (bar {bar:.3g}; the float32 control "
              f"{dc:.3e}), |kernel - plain| / |plain| = {rel:.3e} (bar "
              f"{CHAIN_BF16_NORM:g}; the control {rel_c:.3e} must exceed "
              f"it)")
        if not (d <= bar and rel <= CHAIN_BF16_NORM < rel_c
                and got.dtype == torch.bfloat16):
            fail(f"{name} {label} disagrees with its plain version on "
                 f"{what}, or the control does not exceed the bar")
        readings[f"{name} {label} {what}"] = dict(
            max_abs=d, bar=bar, rel_norm=rel, control_max_abs=dc,
            control_rel_norm=rel_c)
    return readings


def chain_bf16_rows(torch, pkg, block, inputs, launches, pairs, err):
    """The two bf16 chain forms timed at the Sintel shape on bfloat16
    ``inputs`` (net, inp, corr, flow), each beside its plain version, its
    bf16 bound and cuDNN's bf16 convolutions of the same work (the
    yardstick), as the kernels line's rows."""
    motion_cuda, gru_cuda = pkg.motion_cuda, pkg.gru_cuda
    net, inp, cor, flow = inputs
    bf = torch.bfloat16
    enc, gru = block.encoder, block.gru
    m_packed, g_packed = enc.packed_weights_bf16(), gru.packed_weights_bf16()
    motion_lib = motion_library(torch, [(w.to(bf), b.to(bf))
                                        for w, b in enc.convs()])
    cell = gru_library(torch, [(w.to(bf), b.to(bf)) for w, b in gru.convs()])
    rows = []
    with torch.inference_mode():
        parts = (inp, motion_cuda.motion_encoder_plain(flow, cor,
                                                       enc.convs()))
        flo_c, cor_c, net_c = nchw(flow), nchw(cor), nchw(net)
        x_c = nchw(torch.cat(parts, -1))
        h, w = net.shape[1:3]
        for name, source, replaces, run, plain, lib, work in (
                ("motion_fwd_bf16", "raft_tpu_torch/csrc/motion_fwd.cu",
                 "raft_tpu/ops/motion_pallas.py:165",
                 lambda: motion_cuda.motion_encoder_cuda(flow, cor, m_packed),
                 lambda: motion_cuda.motion_encoder_plain(flow, cor,
                                                          enc.convs()),
                 lambda: motion_lib(flo_c, cor_c),
                 bf16_motion_work(flow, cor, m_packed, enc.convs())),
                ("sepconv_gru_bf16", "raft_tpu_torch/csrc/sepconv_gru.cu",
                 "raft_tpu/ops/gru_pallas.py:245",
                 lambda: gru_cuda.sepconv_gru_cuda(net, parts, g_packed),
                 lambda: gru_cuda.sepconv_gru_plain(net, parts, gru.convs()),
                 lambda: cell(net_c, x_c),
                 bf16_gru_work(net, parts, g_packed))):
            bound_ms, bound_by = bound(*work, peak=BF16_FLOPS)
            ms, ms_q = time_ms(torch, run), queued_ms(torch, run)
            rows.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "path": "mixed chain",
                "launches": launches[name],
                "launches_per_pair": launches[name] / pairs,
                "max_abs_err": err[name], "ms": ms, "ms_q": ms_q,
                "plain_ms": time_ms(torch, plain, n=10),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": time_ms(torch, lib),
                "bound_share_q": bound_ms / ms_q,
                "tflops_q": work[0] / ms_q / 1e9, "flops": work[0],
                "bytes": work[1],
                "shape": f"B=1 {h}x{w}, C=128, Cc={cor.shape[-1]}, "
                         f"bfloat16"})
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms a launch, queued "
              f"{r['ms_q']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['flops'] / 1e9:.2f} GFLOP at 989 "
              f"TFLOP/s, {r['bytes'] / 1e6:.2f} MB at 3.35 TB/s), "
              f"{100 * r['bound_share_q']:.1f}% of the bound reached, "
              f"{r['tflops_q']:.2f} TFLOP/s; plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms (cuDNN bf16)")
    return rows


def mixed_chain_phase(torch, pkg, weights, padder, frames, rng, feat,
                      radius, counters, err, step_ms):
    """RAFT-large inference under the bf16 policy on update_impl="chain":
    the bf16 forms of motion_fwd and sepconv_gru (SASS for bf16
    tensor-core MMAs) against their plain versions on Sintel inputs and on
    the served model's own B=2 state (bf16_chain_checks), CHAIN_PAIRS
    Sintel pairs served at iters=32 (corr_fwd_bf16 and both forms 32 a
    pair, no float32 form), ms/pair beside the step route's median mixed
    pair of this run (``step_ms``), one chain pair profiled, and both
    forms timed. Returns their rows."""
    t0 = time.perf_counter()
    cuobjdump = os.path.join(os.path.dirname(pkg.build.nvcc()), "cuobjdump")
    paths = pkg.build.build(("motion_fwd", "sepconv_gru"))
    sass = {}
    for name, lib in (("motion_fwd_bf16", "motion_fwd"),
                      ("sepconv_gru_bf16", "sepconv_gru")):
        ops = tensor_core_bf16_ops(cuobjdump, paths[lib])
        sass[name] = sum(ops.values())
        print(f"  {lib} SASS, tensor-core BF16 MMAs: {ops}")
        if not ops:
            fail(f"{lib} has no tensor-core BF16 MMA in its SASS")
        if widest_hgmma_n(ops) <= 64:
            fail(f"{lib}'s bf16 tile has no warpgroup MMA wider than 64x64x16")
    chain = pkg.load_predictor(weights, iters=SINTEL_ITERS,
                               mixed_precision=True, update_impl="chain")
    block = chain.model.update_block
    h, w = feat["sintel"]
    bf = torch.bfloat16
    sintel = tuple(t.to(bf) for t in update_inputs(torch, rng, h, w))
    readings = bf16_chain_checks(torch, pkg, block, sintel, "Sintel inputs",
                                 err)
    carry = chain.step_carry_dispatch(np.stack([frames[1][0], frames[2][0]]),
                                      np.stack([frames[1][1], frames[2][1]]))
    with torch.inference_mode():
        f1, pyr = carry["corr"]
        cor = pkg.corr_cuda.windowed_correlation_bf16_cuda(
            f1, pyr, carry["coords1"].contiguous(), radius, out_dtype=bf)
    flow = (carry["coords1"] - carry["coords0"]).to(bf).contiguous()
    readings.update(bf16_chain_checks(
        torch, pkg, block, (carry["net"], carry["inp"], cor, flow),
        "the served state", err))
    phase_seconds("mixed chain: kernels against plain", t0)
    t0 = time.perf_counter()
    times, launches = serve_pairs(torch, chain, padder,
                                  frames[:CHAIN_PAIRS + 1], counters)
    ms, step = statistics.median(times), step_ms
    print(f"serve mixed chain: RAFT-large bf16 policy on "
          f"update_impl='chain', {CHAIN_PAIRS} Sintel pairs "
          f"{SINTEL_HW[0]}x{SINTEL_HW[1]}, iters={SINTEL_ITERS}, B=1: median "
          f"{ms:.2f} ms/pair (all {', '.join(f'{t:.2f}' for t in times)}); "
          f"the step route under the policy {step:.2f} ms/pair in this run")
    check_launches(launches, CHAIN_PAIRS, {"corr_fwd_bf16": SINTEL_ITERS,
                                           "motion_fwd_bf16": SINTEL_ITERS,
                                           "sepconv_gru_bf16": SINTEL_ITERS})
    profile_pair(torch, chain, *frames[1], label="profile mixed chain",
                 per_iteration="sepconv_gru_bf16_kernel")
    rows = chain_bf16_rows(torch, pkg, block, sintel, launches, CHAIN_PAIRS,
                           err)
    for r in rows:
        r["sass_bf16_mma"] = sass[r["name"]]
        r["readings"] = {k: v for k, v in readings.items()
                         if k.startswith(r["name"])}
        r["tile"] = bf16_tile_geometry(torch, pkg.conv_tile, (
            pkg.conv_tile.motion_phases(324) if r["name"] == "motion_fwd_bf16"
            else pkg.conv_tile.gru_phases(128, (128, 128))))
        print_tile_geometry(r["name"], r["tile"])
    rows[0].update(ms_per_pair_mixed_chain=ms, ms_per_pair_mixed_step=step)
    phase_seconds("mixed chain: serve and timings", t0)
    return rows


def mixed_small_phase(torch, pkg, padder, frames, counters, f32_times):
    """RAFT-small under the bf16 policy: the small goldens on both engines,
    the bf16 corr form at r=3, C=128 (corr_impl auto; 12 a pair) and the
    all-pairs pyramid stored in bfloat16 (corr_impl fixed), each with the
    GT EPE within MIXED_BAND of the JAX package's own aggregate under the
    policy (SMALL_MIXED_GT_CPU) and the parity EPE at most its own plus
    MIXED_BAND; then SERVE_PAIRS Sintel pairs (corr_fwd_bf16 32 a pair),
    ms/pair beside the float32 RAFT-small pairs of this run
    (``f32_times``), one of them profiled. Returns the readings."""
    with open(os.path.join(REPO, "assets", "golden", "manifest.json")) as f:
        npairs = len(json.load(f)["small"]["pairs"])
    parity_bar = SMALL_MIXED_PARITY_CPU + MIXED_BAND
    out = {}
    for route, impl, per_pair in (
            ("corr_fwd_bf16 r=3", "auto", {"corr_fwd_bf16": 12}),
            ("all-pairs bf16 storage", "fixed", {})):
        pred = pkg.load_predictor(SMALL_WEIGHTS, small=True, iters=12,
                                  mixed_precision=True, corr_impl=impl)
        reset_counts(counters)
        res = pkg.validate_golden_small(pred)
        launches = read_counts(counters)
        out[route] = res
        print(f"golden small mixed [{route}, cuDNN bf16 update block]: "
              f"parity EPE {res['golden_small_parity_epe']:.4f} (bar "
              f"{parity_bar:.4f}), GT EPE {res['golden_small_gt_epe']:.4f} "
              f"(JAX on the CPU {SMALL_MIXED_GT_CPU:.4f}, band {MIXED_BAND})")
        if not res["golden_small_parity_epe"] <= parity_bar:
            fail(f"RAFT-small mixed golden parity through {route}")
        if not abs(res["golden_small_gt_epe"]
                   - SMALL_MIXED_GT_CPU) < MIXED_BAND:
            fail(f"RAFT-small mixed golden GT EPE through {route}")
        check_launches(launches, npairs, per_pair)
    small = pkg.load_predictor(SMALL_WEIGHTS, small=True, iters=SINTEL_ITERS,
                               mixed_precision=True)
    times, launches = serve_pairs(torch, small, padder, frames, counters)
    ms, f32 = statistics.median(times), statistics.median(f32_times)
    print(f"serve small mixed: RAFT-small bf16 policy, {SERVE_PAIRS} Sintel "
          f"pairs, iters={SINTEL_ITERS}, B=1: median {ms:.2f} ms/pair (all "
          f"{', '.join(f'{t:.2f}' for t in times)}); float32 RAFT-small "
          f"{f32:.2f} ms/pair in this run")
    check_launches(launches, SERVE_PAIRS, {"corr_fwd_bf16": SINTEL_ITERS})
    profile_pair(torch, small, *frames[1], label="profile small mixed",
                 per_iteration="corr_fwd_bf16_kernel")
    return {"goldens": out, "ms_per_pair": ms, "ms_per_pair_f32": f32,
            "launches_per_pair": launches["corr_fwd_bf16"] / SERVE_PAIRS}


# -- bf16 mixed-precision training ------------------------------------------

# The bf16 corr backward against its plain version, two readings per
# gradient (df1 and every df2), each max|kernel - plain| / max|plain|:
# - as returned, in the maps' dtype: within one bf16 eps for bfloat16
#   gradients (the two sum in other orders and round once: a flipped
#   rounding is an ulp, between one and two of them an eps of the largest);
# - the float32 sums before that rounding (the kernel's out_dtype=float32,
#   the plain version on float32 copies of the same maps): the largest
#   difference within the first bar of CORR_BWD_BF16_BARS for the
#   combination, and |kernel - plain| / |plain| (2-norms) within the
#   second. A control reading, that 2-norm of the kernel against the plain
#   version at the other mxu_dtype (what a kernel that left out, or added,
#   the bfloat16 rounding of the maps and coefficients would read), must
#   lie above the second bar: the bar tells the two apart.
# Under mxu "float32" the kernel's three bf16 passes (the coefficient split
# into three bfloat16 parts, 24 significant bits) and the plain float32
# sums differ by the order of the sums. Under "bfloat16" both
# round the same float32 coefficients to bfloat16, folded in other orders:
# a coefficient a float32 ulp from a bfloat16 rounding boundary can round
# the other way (about one in 2^16), which moves the gradients it touches by
# its bfloat16 ulp, as much as the control moves every gradient. So the
# largest difference cannot tell the two apart there, and the 2-norm can:
# a few flipped coefficients among millions barely move it. Read on an H100
# over this phase's inputs (csrc/corr_tile_bf16.cuh's three bf16 passes):
# mxu "float32" 3.4e-6 largest, 1.5e-6 2-norm; mxu "bfloat16" up to 1.1e-3
# largest, 5.7e-5 2-norm; the controls' 2-norm 1.66e-3 at least.
CORR_BWD_BF16_BARS = {("bfloat16", "float32"): (1e-4, 1e-5),
                      ("bfloat16", "bfloat16"): (4e-3, 1e-4),
                      ("float32", "bfloat16"): (4e-3, 1e-4)}
# Its operand combinations, (maps, mxu_dtype): the policy's training lookup
# (mixed_precision alone), with corr_mxu_dtype="bfloat16", and that lever
# alone on float32 maps; with each, the cotangent it gets in training (the
# windows' dtype: the maps'), and at the chairs shape both cotangents.
BF16_BWD_COMBOS = (("bfloat16", "float32"), ("bfloat16", "bfloat16"),
                   ("float32", "bfloat16"))
# step_against_plain's bars under the bf16 policy: the plain route's move
# under relative noise of PERTURB_BF16 on the lookup's and the step's
# bfloat16 outputs (which flips about one rounding in twenty by an ulp, as
# the kernels' other summation orders do) sets every limit, times
# SPREAD_MARGIN, with floors of LOSS_REL_BF16 and NORM_REL_BF16 (relative),
# GRAD_REL_BF16 of each parameter's largest plain gradient (8 bf16 eps, the
# JAX package's bar for its bf16 paths), PARAM_BAR and BN_BAR_BF16. The
# mixed step's kernel route reads 4.2% of a parameter's largest gradient
# (fnet.layer3.0.downsample.0.weight; the forward kernels' roundings, over
# four iterations; its backward kernels in situ 0.9%) on an H100. The
# control, the plain route of the float32 model, must lie above the
# gradient bar (38.8% there): a kernel route that ignored the policy fails.
# Under corr_mxu_dtype="bfloat16" alone the lever moves the gradients less
# (1.5%) than the perturbed plain route's spread, so its step check holds
# the route to the plain route only; the lever's own numerics are held at
# the kernels (CORR_BWD_BF16_BARS and the corr_fwd_bf16 checks).
PERTURB_BF16 = 2.0 ** -12
LOSS_REL_BF16, NORM_REL_BF16, GRAD_REL_BF16, BN_BAR_BF16 = (
    1e-4, 1e-3, 8 * BF16_EPS, 1e-3)
STEP_BARS_BF16 = dict(loss=LOSS_REL_BF16, norm=NORM_REL_BF16,
                      grad=GRAD_REL_BF16, param=PARAM_BAR, bn=BN_BAR_BF16,
                      perturb=PERTURB_BF16, base="moved", control=True)
# JAX's own bf16-versus-float32 loss gap in training, BF16_BACKWARD_AB.json
# (the JAX package on the CPU, 20 steps, B=2, 64x96, corr_mxu_dtype
# "bfloat16" alone against float32): printed beside the port's gap under
# the whole policy on the card, not a gate (the whole policy moves JAX's
# own losses further: scripts/mixed_train_trajectory.py)
JAX_BF16_LOSS_GAP = 0.038


def bf16_corr_bwd_work(torch, f1, pyramid, coords, radius, g):
    """corr_bwd_work's operations with the bytes of these operands: the
    maps read and their gradients written in the maps' dtype, the
    cotangent in its own."""
    flops, _ = corr_bwd_work(torch, f1, pyramid, coords, radius)
    maps = f1.numel() + sum(f.numel() for f in pyramid)
    return flops, (2 * f1.element_size() * maps + 4 * coords.numel()
                   + g.element_size() * g.numel())


def bf16_corr_bwd_phase(torch, corr_cuda, corr, sampling, rng, radius,
                        err):
    """The bf16 corr backward against its plain version at the chairs train
    shape (B=8, 46x62, C=256, r=4) and the Sintel shape (B=1, 55x128, C=256
    r=4, and C=128 r=3), on coherent and incoherent flows (CORR_FLOWS), and
    at both Sintel widths with rescale 0 on coherent ones, for each operand
    combination (BF16_BWD_COMBOS) with its training cotangent, at the
    chairs shape and with rescale 0 also with the other; on coherent flows
    also with each path forced; each against CORR_BWD_BF16_BARS with its
    control, failing after every case is printed. The shared path's boxes
    must include one of a single 64-pixel chunk, one of more chunks than
    the kernel's ring of two stages, and ragged ones (box_pixels). Then each
    combination timed with rescale 1 at the default budget (ms, queued
    ms_q, the bound at 989 TFLOP/s for one bf16 pass and a third of it for
    the three passes of mxu "float32", the shared-path share, the float32
    form's queued time on the same inputs), the plain version too for the
    policy's combination. Updates ``err``; returns {"<shape> <flow>
    <maps>/<mxu>": row}, "max_rel_err", "boxes" and "readings"
    ({"<maps>/<mxu>": [the largest float32-sum reading, the largest
    2-norm one, the smallest control]})."""
    cases = [("chairs", TRAIN_B, TRAIN_HW[0] // 8, TRAIN_HW[1] // 8, 256,
              radius, CORR_FLOWS["chairs"], True),
             ("sintel", 1, 55, 128, 256, radius, CORR_FLOWS["sintel"], True),
             ("sintel r=3", 1, 55, 128, SMALL_C, 3, CORR_FLOWS["sintel"],
              True)]
    cases += [(f"{label} rescale=0", b, h, w, c, r,
               {"coherent": flows["coherent"]}, False)
              for label, b, h, w, c, r, flows, _ in cases[1:]]
    default = corr_cuda.TILE_BUDGET
    rows = {}
    worst = 0.0
    readings = {combo: [0.0, 0.0, math.inf] for combo in BF16_BWD_COMBOS}
    problems = []
    boxes = {"one_chunk": 0, "beyond_ring": 0, "ragged": 0}

    def rel(got, want, norm=False):
        """max|got - want| / max|want| (|got - want| / |want|, 2-norms,
        with ``norm``), the largest over df1 and every df2."""
        def one(a, b):
            d, b = a.float() - b.float(), b.float()
            if norm:
                return float(d.norm() / b.norm())
            return float(d.abs().max() / b.abs().max())
        return max(one(a, b) for a, b in zip((got[0], *got[1]),
                                             (want[0], *want[1])))

    for label, b, h, w, c, r, flows, rescale in cases:
        for flow, max_px in flows.items():
            f1, pyr, coords = corr_inputs(torch, sampling, corr, rng, h, w,
                                          c=c, flow=flow, b=b, max_px=max_px)
            nb = box_pixels(torch, pyr, coords, r, rescale)
            nb = nb[(nb > 0) & (nb <= default)]
            boxes["one_chunk"] += int((nb <= BWD_BF16_CHUNK).sum())
            boxes["beyond_ring"] += int((nb > 2 * BWD_BF16_CHUNK).sum())
            boxes["ragged"] += int((nb % BWD_BF16_CHUNK > 0).sum())
            win = (2 * r + 1) ** 2 * len(pyr)
            g32 = torch.randn(b, h, w, win, device="cuda")
            f32_ms_q = None
            for maps, mxu in BF16_BWD_COMBOS:
                dt = getattr(torch, maps)
                f1m, pyrm = f1.to(dt), tuple(p.to(dt) for p in pyr)
                # the same values in float32: the plain version's sums
                # before the rounding to the maps' dtype
                f1f, pyrf = f1m.float(), tuple(p.float() for p in pyrm)
                other = "float32" if mxu == "bfloat16" else "bfloat16"
                bar32, bar_norm = CORR_BWD_BF16_BARS[(maps, mxu)]
                bar = BF16_EPS if maps == "bfloat16" else bar32
                gdts = ((maps, "float32" if maps == "bfloat16" else
                         "bfloat16") if label == "chairs" or not rescale
                        else (maps,))
                for gdt in gdts:
                    g = g32.to(getattr(torch, gdt))
                    want = corr_cuda.windowed_correlation_bwd_plain(
                        f1m, pyrm, coords, g, r, rescale=rescale,
                        mxu_dtype=mxu)
                    want32 = corr_cuda.windowed_correlation_bwd_plain(
                        f1f, pyrf, coords, g, r, rescale=rescale,
                        mxu_dtype=mxu)
                    ctrl32 = corr_cuda.windowed_correlation_bwd_plain(
                        f1f, pyrf, coords, g, r, rescale=rescale,
                        mxu_dtype=other)
                    paths = [("default", default)]
                    if flow == "coherent" and gdt == maps and rescale:
                        paths += [("warp", 0), ("shared", FORCE_SHARED)]
                    for path, budget in paths:
                        corr_cuda.TILE_BUDGET = budget
                        corr_cuda.reset_path_counts()
                        try:
                            got = corr_cuda.windowed_correlation_bwd_bf16_cuda(
                                f1m, pyrm, coords, g, r, rescale=rescale,
                                mxu_dtype=mxu)
                            got32 = corr_cuda.windowed_correlation_bwd_bf16_cuda(
                                f1m, pyrm, coords, g, r, rescale=rescale,
                                mxu_dtype=mxu, out_dtype=torch.float32)
                        finally:
                            corr_cuda.TILE_BUDGET = default
                        torch.cuda.synchronize()
                        counts = corr_cuda.path_counts()["bwd"]
                        what = (f"{label} B={b} {h}x{w} C={c} r={r} {flow}, "
                                f"{maps} maps, mxu {mxu}, {gdt} cotangent, "
                                f"{path} path")
                        for a, b_ in zip((got[0], *got[1]),
                                         (want[0], *want[1])):
                            err["corr_bwd_bf16"] = max(
                                err["corr_bwd_bf16"],
                                float((a.float() - b_.float()).abs().max()))
                            if a.dtype != dt:
                                fail(f"corr_bwd_bf16 returned {a.dtype} for "
                                     f"{maps} maps")
                        out, sums = rel(got, want), rel(got32, want32)
                        norm = rel(got32, want32, norm=True)
                        ctrl = rel(got32, ctrl32, norm=True)
                        worst = max(worst, out)
                        seen = readings[(maps, mxu)]
                        seen[:] = (max(seen[0], sums), max(seen[1], norm),
                                   min(seen[2], ctrl))
                        print(f"corr_bwd_bf16 {what} [shared "
                              f"{100 * shared_share(counts):.1f}%]: max|"
                              f"kernel - plain| / max|plain| = {out:.3e} = "
                              f"{out / BF16_EPS:.3f} bf16 eps (bar "
                              f"{bar:.3g}); float32 sums {sums:.3e} (bar "
                              f"{bar32:g}), 2-norm {norm:.3e} (bar "
                              f"{bar_norm:g}), control at mxu {other} "
                              f"{ctrl:.3e}")
                        if not (out <= bar and sums <= bar32
                                and norm <= bar_norm < ctrl):
                            problems.append(what)
                        forced = {"warp": 1, "shared": 0}.get(path)
                        if forced is not None and not (
                                counts[forced] > counts[1 - forced]):
                            fail(f"the {path} path was not taken: {counts}")
                if not rescale:
                    continue
                g = g32.to(dt)
                corr_cuda.reset_path_counts()
                run = (lambda: corr_cuda.windowed_correlation_bwd_bf16_cuda(
                    f1m, pyrm, coords, g, r, mxu_dtype=mxu))
                run()
                share = shared_share(corr_cuda.path_counts()["bwd"])
                work = bf16_corr_bwd_work(torch, f1m, pyrm, coords, r, g)
                peak = BF16_FLOPS if mxu == "bfloat16" else BF16X3_FLOPS
                bound_ms, bound_by = bound(*work, peak=peak)
                if f32_ms_q is None:
                    f32_ms_q = queued_ms(torch, lambda: (
                        corr_cuda.windowed_correlation_bwd_cuda(
                            f1, pyr, coords, g32, r)))
                row = {"ms": time_ms(torch, run),
                       "ms_q": queued_ms(torch, run),
                       "f32_form_ms_q": f32_ms_q,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "shared_share": share,
                       "shape": f"B={b} {h}x{w} C={c} L=4 r={r}, {maps} "
                                f"maps and cotangent, mxu {mxu}, flows up "
                                f"to {max_px:g} feature px"}
                if (maps, mxu) == BF16_BWD_COMBOS[0]:
                    row["plain_ms"] = time_ms(torch, lambda: (
                        corr_cuda.windowed_correlation_bwd_plain(
                            f1m, pyrm, coords, g, r, mxu_dtype=mxu)), n=5,
                        warmup=1)
                rows[f"{label} {flow} {maps}/{mxu}"] = row
                print(f"corr_bwd_bf16 {label} {flow} ({row['shape']}): "
                      f"{row['ms']:.4f} ms a launch, queued "
                      f"{row['ms_q']:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({bound_by}); shared path on {100 * share:.1f}% of "
                      f"(tile, level) blocks; the float32 form corr_bwd "
                      f"queued {f32_ms_q:.4f} ms on these inputs"
                      + (f"; plain {row['plain_ms']:.4f} ms"
                         if "plain_ms" in row else ""))
    for (maps, mxu), (sums, norm, ctrl) in readings.items():
        bars = CORR_BWD_BF16_BARS[(maps, mxu)]
        print(f"corr_bwd_bf16 {maps} maps, mxu {mxu}: float32 sums at most "
              f"{sums:.3e} of max|plain| apart (bar {bars[0]:g}), their "
              f"2-norm {norm:.3e} (bar {bars[1]:g}), the control's 2-norm "
              f"at least {ctrl:.3e}")
    print(f"corr_bwd_bf16 shared-path boxes checked: {boxes['one_chunk']} of "
          f"one {BWD_BF16_CHUNK}-pixel chunk, {boxes['beyond_ring']} of more "
          f"than two chunks (the ring's stages), {boxes['ragged']} with a "
          f"ragged last chunk")
    if problems:
        fail("corr_bwd_bf16 disagrees with its plain version, or its bar "
             "does not separate the control, at " + "; ".join(problems))
    if not all(boxes.values()):
        fail(f"corr_bwd_bf16's checks miss a kind of box: {boxes}")
    rows["max_rel_err"] = worst
    rows["boxes"] = boxes
    rows["readings"] = {f"{m}/{x}": v for (m, x), v in readings.items()}
    return rows


def mixed_train_phase(torch, pkg, weights, f32_run, err):
    """RAFT-large training under the bf16 policy: the bf16 corr backward
    against its plain version (bf16_corr_bwd_phase); one train step
    through the kernels against the plain route (B=2, 184x248, iters=4)
    with ``mixed_precision=True`` and, separately,
    ``corr_mxu_dtype="bfloat16"``, each beside its control (the float32
    model's plain route); then ``train()`` at the chairs defaults
    under ``mixed_precision=True`` on the batches and weights of the float32
    run ``f32_run`` (train_full_size's return), each step's loss beside the
    float32 one's, and one mixed step profiled. Returns (the corr_bwd_bf16
    row's timings, launches of the mixed train run, steps, problems)."""
    t0 = time.perf_counter()
    cuobjdump = os.path.join(os.path.dirname(pkg.build.nvcc()), "cuobjdump")
    lib = pkg.build.build(("corr_bwd_bf16",))["corr_bwd_bf16"]
    regs, spills = ptxas_usage(lib)
    print(f"  corr_bwd_bf16 ptxas: {len(regs)} kernels, registers "
          f"{min(regs)}-{max(regs)} a thread, spill bytes {sum(spills)}")
    sass = {"sass_tf32_mma": tensor_core_tf32_ops(cuobjdump, lib),
            "sass_bf16_mma": tensor_core_bf16_ops(cuobjdump, lib)}
    print(f"  corr_bwd_bf16 SASS, tensor-core MMAs: {sass}")
    if (sass["sass_tf32_mma"]
            or not sass["sass_bf16_mma"].get("HMMA.16816.F32.BF16")):
        fail("corr_bwd_bf16's SASS must hold HMMA.16816.F32.BF16 (both mxu "
             "settings multiply in bf16) and no TF32 MMA")
    if sum(spills):
        fail(f"corr_bwd_bf16 spills {sum(spills)} bytes")
    timings = bf16_corr_bwd_phase(torch, pkg.corr_cuda, pkg.corr,
                                  pkg.sampling, np.random.default_rng(12),
                                  4, err)
    timings.update({k: sum(v.values()) for k, v in sass.items()})
    phase_seconds("mixed train: corr_bwd_bf16", t0)
    t0 = time.perf_counter()
    tcfg = pkg.TrainConfig(batch_size=CMP_B, image_size=CMP_HW,
                           iters=CMP_ITERS, num_steps=100)
    batch = synthetic_batch(torch, CMP_B, CMP_HW,
                            torch.Generator(device=DEVICE).manual_seed(1))
    state_dict = pkg.load_npz(weights)
    problems = []
    for label, levers, bars, per_step in (
            ("mixed train step", dict(mixed_precision=True), STEP_BARS_BF16,
             {"corr_fwd_bf16": CMP_ITERS, "corr_bwd_bf16": CMP_ITERS,
              "update_step_bf16": CMP_ITERS}),
            ("mxu-bf16 train step", dict(corr_mxu_dtype="bfloat16"),
             dict(STEP_BARS_BF16, control=False),
             {"corr_fwd_bf16": CMP_ITERS, "corr_bwd_bf16": CMP_ITERS,
              "update_step": CMP_ITERS})):
        def make_model(levers=levers):
            model = pkg.RAFT(pkg.RAFTConfig(alternate_corr=True, **levers))
            model.load_state_dict(state_dict)
            return model

        def make_f32():
            model = pkg.RAFT(pkg.RAFTConfig(alternate_corr=True))
            model.load_state_dict(state_dict)
            return model

        launches, found = step_against_plain(
            torch, pkg, label, make_model, tcfg, batch, cancelled_by_norm,
            bars=bars, control=make_f32, alternate_corr=True)
        check_launches(launches, 1, per_step, unit="step")
        problems += found
    phase_seconds("mixed train: steps against plain", t0)
    t0 = time.perf_counter()
    f32_ms, f32_losses = f32_run[2], f32_run[5]
    state, tcfg, step_ms, launches, peak, losses = train_full_size(
        torch, pkg, weights, pkg.RAFTConfig(mixed_precision=True), "mixed")
    steps = TRAIN_WARMUP + TRAIN_TIMED
    shares = print_path_shares(pkg.corr_cuda, f"train mixed: {steps} chairs "
                               f"steps")
    check_launches(launches, steps, {"corr_fwd_bf16": TRAIN_ITERS,
                                     "corr_bwd_bf16": TRAIN_ITERS,
                                     "update_step_bf16": TRAIN_ITERS},
                   unit="step")
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, f32_losses)]
    for n, (a, b, gap) in enumerate(zip(losses, f32_losses, gaps)):
        print(f"  step {n}: loss mixed {a:.6f}, f32 {b:.6f}, relative gap "
              f"{gap:.3e}")
    ms, f32 = statistics.median(step_ms), statistics.median(f32_ms)
    print(f"train mixed: RAFT-large bf16 policy, B={TRAIN_B} {TRAIN_HW[0]}x"
          f"{TRAIN_HW[1]}, iters={TRAIN_ITERS}, {TRAIN_TIMED} timed steps "
          f"after {TRAIN_WARMUP}: median {ms:.2f} ms/step (all "
          f"{', '.join(f'{t:.2f}' for t in step_ms)}), "
          f"{1e3 * TRAIN_B / ms:.2f} samples/s, float32 {f32:.2f} ms/step "
          f"in this run ({f32 / ms:.2f}x); peak memory {peak:.1f} MiB; loss "
          f"gap to float32 at most {max(gaps):.3e} relative (JAX on the CPU "
          f"with corr_mxu_dtype='bfloat16' alone, BF16_BACKWARD_AB.json: "
          f"{JAX_BF16_LOSS_GAP}; not a gate)")
    profile = profile_train_step(
        torch, pkg.make_train_step(tcfg, alternate_corr=True), state,
        synthetic_batch(torch, TRAIN_B, TRAIN_HW,
                        torch.Generator(device="cuda").manual_seed(3)),
        label="train profile mixed")
    phase_seconds("mixed train: chairs", t0)
    timings.update(ms_per_step_mixed=ms, ms_per_step_f32=f32,
                   loss_gap_max=max(gaps), peak_mib_mixed=peak,
                   shared_share_train=shares["bwd"], profile_mixed=profile,
                   losses_mixed=losses)
    return timings, launches, steps, problems


def mixed_chain_train_phase(torch, pkg, weights, mixed_train):
    """RAFT-large training under the bf16 policy on update_impl="chain":
    one train step through the kernels against the plain route (B=2,
    184x248, iters=4; STEP_BARS_BF16, the float32 model's plain route the
    control that must exceed the gradient bar), then ``train()`` at the
    chairs defaults on the same weights and batches as the step route's
    mixed run (``mixed_train``, mixed_train_phase's timings), each step's
    loss beside that run's, ms/step beside its. corr_fwd_bf16,
    corr_bwd_bf16, motion_fwd_bf16 and sepconv_gru_bf16 12 a step. Returns
    (timings, launches, steps, problems)."""
    t0 = time.perf_counter()
    tcfg = pkg.TrainConfig(batch_size=CMP_B, image_size=CMP_HW,
                           iters=CMP_ITERS, num_steps=100)
    batch = synthetic_batch(torch, CMP_B, CMP_HW,
                            torch.Generator(device=DEVICE).manual_seed(1))
    state_dict = pkg.load_npz(weights)

    def make_model(mixed=True):
        model = pkg.RAFT(pkg.RAFTConfig(alternate_corr=True,
                                        mixed_precision=mixed))
        model.load_state_dict(state_dict)
        return model

    launches, problems = step_against_plain(
        torch, pkg, "mixed chain train step", make_model, tcfg, batch,
        cancelled_by_norm, bars=STEP_BARS_BF16,
        control=lambda: make_model(False), alternate_corr=True,
        update_impl="chain")
    check_launches(launches, 1, {"corr_fwd_bf16": CMP_ITERS,
                                 "corr_bwd_bf16": CMP_ITERS,
                                 "motion_fwd_bf16": CMP_ITERS,
                                 "sepconv_gru_bf16": CMP_ITERS}, unit="step")
    phase_seconds("mixed chain train: step against plain", t0)
    t0 = time.perf_counter()
    _, _, step_ms, launches, peak, losses = train_full_size(
        torch, pkg, weights, pkg.RAFTConfig(mixed_precision=True),
        "mixed chain", update_impl="chain")
    steps = TRAIN_WARMUP + TRAIN_TIMED
    check_launches(launches, steps, {"corr_fwd_bf16": TRAIN_ITERS,
                                     "corr_bwd_bf16": TRAIN_ITERS,
                                     "motion_fwd_bf16": TRAIN_ITERS,
                                     "sepconv_gru_bf16": TRAIN_ITERS},
                   unit="step")
    for n, (a, b) in enumerate(zip(losses, mixed_train["losses_mixed"])):
        print(f"  step {n}: loss mixed chain {a:.6f}, mixed step route "
              f"{b:.6f}, relative gap {abs(a - b) / abs(b):.3e}")
    ms, step = statistics.median(step_ms), mixed_train["ms_per_step_mixed"]
    print(f"train mixed chain: RAFT-large bf16 policy on update_impl="
          f"'chain', B={TRAIN_B} {TRAIN_HW[0]}x{TRAIN_HW[1]}, iters="
          f"{TRAIN_ITERS}, {TRAIN_TIMED} timed steps after {TRAIN_WARMUP}: "
          f"median {ms:.2f} ms/step (all "
          f"{', '.join(f'{t:.2f}' for t in step_ms)}); the step route under "
          f"the policy {step:.2f} ms/step in this run; peak memory "
          f"{peak:.1f} MiB")
    phase_seconds("mixed chain train: chairs", t0)
    return ({"ms_per_step_mixed_chain": ms, "ms_per_step_mixed_step": step,
             "peak_mib_mixed_chain": peak}, launches, steps, problems)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, REPO)
    from types import SimpleNamespace

    from raft_tpu_torch.config import OursConfig, RAFTConfig, TrainConfig
    from raft_tpu_torch.evaluate import (ASSETS_DIR, SPARSE_GOLDEN,
                                         FlowPredictor, load_predictor,
                                         use_float32_math, validate_golden,
                                         validate_golden_small)
    from raft_tpu_torch.models import corr
    from raft_tpu_torch.models.ours import SparseRAFT
    from raft_tpu_torch.models.raft import RAFT
    from raft_tpu_torch.ops import (build, conv_tile, corr_cuda, gru_cuda,
                                    motion_cuda, msda, msda_cuda, sampling,
                                    step_cuda)
    from raft_tpu_torch.optim import make_schedule
    from raft_tpu_torch.parallel.train_step import (create_train_state,
                                                    make_train_step)
    from raft_tpu_torch.train import train
    from raft_tpu_torch.utils.padder import InputPadder
    from raft_tpu_torch.utils.warm_start import forward_interpolate
    from raft_tpu_torch.weights import load_npz

    print(card_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}")
    use_float32_math()
    print(f"TF32: cudnn {torch.backends.cudnn.allow_tf32}, matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    paths = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        with open(path + ".log") as f:
            regs = [ln.split(":", 1)[1].strip() for ln in f
                    if "registers" in ln]
        print(f"  {name}: {os.path.relpath(path, REPO)}; ptxas: "
              f"{regs[0] if regs else 'no report'}")
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = {}
    for name in TENSOR_CORE_KERNELS:
        ops = tensor_core_tf32_ops(cuobjdump, paths[name])
        sass[name] = sum(ops.values())
        print(f"  {name} SASS, tensor-core TF32 MMAs: {ops}")
        if not ops:
            fail(f"{name} has no tensor-core TF32 MMA in its SASS")

    weights = os.path.join(ASSETS_DIR, "golden", "weights.npz")
    kernel_pred = load_predictor(weights, iters=12)        # corr_impl auto
    if not kernel_pred.alternate_corr:
        fail("corr_impl='auto' did not pick the kernel engine on the card")
    block = kernel_pred.model.update_block
    gru_module = block.gru
    packed = gru_module.packed_weights()
    convs = gru_module.convs()
    m_packed, m_convs = block.encoder.packed_weights(), block.encoder.convs()
    h_packed, h_convs = block.flow_head.packed_weights(), block.flow_head.convs()
    step_convs = {"mg": (m_convs, convs, None),
                  "mgf": (m_convs, convs, h_convs)}
    step_packed = {"mg": (m_packed, packed, None),
                   "mgf": (m_packed, packed, h_packed)}
    radius = kernel_pred.model.config.radius
    rng = np.random.default_rng(0)

    # -- kernels against their plain versions ------------------------------
    err = {"corr_fwd": 0.0, "corr_bwd": 0.0, "sepconv_gru": 0.0,
           "motion_fwd": 0.0, "update_step": 0.0, "msda_fwd": 0.0,
           "msda_bwd": 0.0, "corr_fwd_bf16": 0.0, "update_step_bf16": 0.0,
           "corr_bwd_bf16": 0.0, "motion_fwd_bf16": 0.0,
           "sepconv_gru_bf16": 0.0}
    corr_bwd_rel = msda_bwd_rel = 0.0
    feat = {"golden": (24, 32), "sintel": (55, 128)}
    with torch.inference_mode():
        for label, (h, w) in feat.items():
            f1, pyr, coords = corr_inputs(torch, sampling, corr, rng, h, w)
            hid, x = gru_inputs(torch, gru_module, rng, h, w)
            net, inp, cor, flo = update_inputs(torch, rng, h, w)
            mot = motion_cuda.motion_encoder_plain(flo, cor, m_convs)
            parts = (inp, mot)
            checks = [
                ("corr_fwd", "", corr_cuda.windowed_correlation_cuda(
                    f1, pyr, coords, radius),
                 corr_cuda.windowed_correlation_fused_plain(
                     f1, pyr, coords, radius)),
                ("sepconv_gru", " x whole", gru_cuda.sepconv_gru_cuda(
                    hid, x, packed),
                 gru_cuda.sepconv_gru_plain(hid, x, convs)),
                ("sepconv_gru", " x parts", gru_cuda.sepconv_gru_cuda(
                    net, parts, packed),
                 gru_cuda.sepconv_gru_plain(net, parts, convs)),
                ("motion_fwd", "", motion_cuda.motion_encoder_cuda(
                    flo, cor, m_packed), mot)]
            for depth in ("mg", "mgf"):
                got = step_cuda.fused_step_cuda(net, inp, cor, flo,
                                                step_packed[depth])
                want = step_cuda.fused_step_plain(net, inp, cor, flo,
                                                  step_convs[depth])
                if depth == "mg":
                    got, want = (got,), (want,)
                for i, (a, b) in enumerate(zip(got, want)):
                    checks.append(("update_step",
                                   f" '{depth}' {('h2', 'delta')[i]}", a, b))
            torch.cuda.synchronize()
            for name, what, a, b in checks:
                d = float((a - b).abs().max())
                err[name] = max(err[name], d)
                print(f"{name}{what} {label} {h}x{w}: max|kernel - plain| = "
                      f"{d:.3e} (bar {TOL:g})")
                if not d <= TOL:
                    fail(f"{name}{what} disagrees with its plain version at "
                         f"{label}: {d:.3e}")
            if not torch.equal(checks[3][2][..., 126:], flo):
                fail("motion_fwd did not pass the flow through bit for bit")
    # the corr backward against autograd through the plain forward (outside
    # inference mode: the plain version needs autograd)
    for label, (h, w) in feat.items():
        f1, pyr, coords = corr_inputs(torch, sampling, corr, rng, h, w)
        g = torch.randn(1, h, w, len(pyr) * (2 * radius + 1) ** 2,
                        device="cuda")
        got = corr_cuda.windowed_correlation_bwd_cuda(f1, pyr, coords, g,
                                                      radius)
        want = corr_cuda.windowed_correlation_bwd_plain(f1, pyr, coords, g,
                                                        radius)
        torch.cuda.synchronize()
        for what, a, b in zip(["df1"] + [f"df2 level {lv}"
                                         for lv in range(len(pyr))],
                              (got[0], *got[1]), (want[0], *want[1])):
            d = float((a - b).abs().max())
            rel = d / float(b.abs().max())
            err["corr_bwd"] = max(err["corr_bwd"], d)
            corr_bwd_rel = max(corr_bwd_rel, rel)
            print(f"corr_bwd {what} {label} {h}x{w}: max|kernel - plain| = "
                  f"{d:.3e}, / max|plain| = {rel:.3e} (bar {CORR_BWD_REL:g})")
            if not rel <= CORR_BWD_REL:
                fail(f"corr_bwd {what} disagrees with autograd through the "
                     f"plain lookup at {label}: {rel:.3e}")
    corr_bwd_rel = max(corr_bwd_rel, check_corr_paths(
        torch, corr_cuda, corr, sampling, rng, radius, feat, err))
    # RAFT-small's lookup: r=3, C=128 on the shared path's channel list, at
    # its golden and Sintel feature shapes (the same as RAFT-large's)
    small_radius = RAFTConfig(small=True).radius
    corr_bwd_rel = max(corr_bwd_rel, check_corr_paths(
        torch, corr_cuda, corr, sampling, rng, small_radius, feat, err,
        c=SMALL_C, cases=[(label, 1, h, w, CORR_FLOWS["sintel"])
                          for label, (h, w) in feat.items()]))

    # the sparse family's kernels at its full-width shapes: the fork lookup
    # at the three token levels of 352x480 (B=8, 2 levels, no per-level
    # rescale) and MSDA at the decoder's and the dense encoder's shapes
    sparse_corr = {c: (h, w) for c, (h, w) in zip(
        (128, 192, 256), SPARSE_LEVELS[:3])}
    msda_shapes = {"decoder": (SPARSE_RUNS[0][1], 100, 16),
                   "encoder": (SPARSE_RUNS[1][1], sum(
                       h * w for h, w in SPARSE_LEVELS), 8)}
    with torch.inference_mode():
        for c, (h, w) in sparse_corr.items():
            f1, pyr, centers = sparse_corr_inputs(torch, rng,
                                                  SPARSE_RUNS[0][1], h, w, c)
            got = corr_cuda.windowed_correlation_cuda(f1, pyr, centers,
                                                      radius, rescale=False)
            want = corr_cuda.windowed_correlation_fused_plain(
                f1, pyr, centers, radius, rescale=False)
            torch.cuda.synchronize()
            d = float((got - want).abs().max())
            err["corr_fwd"] = max(err["corr_fwd"], d)
            print(f"corr_fwd fork lookup C={c} B={SPARSE_RUNS[0][1]} {h}x{w}"
                  f" (2 levels, rescale=False): max|kernel - plain| = "
                  f"{d:.3e} (bar {TOL:g})")
            if not d <= TOL:
                fail(f"corr_fwd disagrees with its plain version at the "
                     f"fork lookup, C={c}: {d:.3e}")
        for label, (b, lq, d_head) in msda_shapes.items():
            value, loc, aw = msda_inputs(torch, rng, b, lq, d_head)
            got = msda_cuda.ms_deform_attn_cuda(value, SPARSE_LEVELS, loc, aw)
            want = msda.ms_deform_attn_plain(value, SPARSE_LEVELS, loc, aw)
            torch.cuda.synchronize()
            d = float((got - want).abs().max())
            err["msda_fwd"] = max(err["msda_fwd"], d)
            print(f"msda_fwd {label} B={b} Lq={lq} M=8 D={d_head} L=6 P=4: "
                  f"max|kernel - plain| = {d:.3e} (bar {TOL:g})")
            if not d <= TOL:
                fail(f"msda_fwd disagrees with its plain version at the "
                     f"{label} shape: {d:.3e}")
    # the sparse family's backward kernels against autograd through their
    # plain versions (outside inference mode): MSDA at both shapes, the
    # fork lookup at its three token levels; each gradient within
    # CORR_BWD_REL of the largest plain one
    for label, (b, lq, d_head) in msda_shapes.items():
        value, loc, aw = msda_inputs(torch, rng, b, lq, d_head)
        g = torch.randn(b, lq, 8 * d_head, device="cuda")
        got = msda_cuda.ms_deform_attn_bwd_cuda(value, SPARSE_LEVELS, loc,
                                                aw, g)
        want = msda.ms_deform_attn_bwd_plain(value, SPARSE_LEVELS, loc, aw,
                                             g)
        torch.cuda.synchronize()
        for what, a, b_ in zip(("d_value", "d_loc", "d_aw"), got, want):
            d = float((a - b_).abs().max())
            rel = d / float(b_.abs().max())
            err["msda_bwd"] = max(err["msda_bwd"], d)
            msda_bwd_rel = max(msda_bwd_rel, rel)
            print(f"msda_bwd {what} {label} B={b} Lq={lq} M=8 D={d_head} "
                  f"L=6 P=4: max|kernel - plain| = {d:.3e}, / max|plain| = "
                  f"{rel:.3e} (bar {CORR_BWD_REL:g})")
            if not rel <= CORR_BWD_REL:
                fail(f"msda_bwd {what} disagrees with autograd through the "
                     f"plain version at the {label} shape: {rel:.3e}")
    for c, (h, w) in sparse_corr.items():
        f1, pyr, centers = sparse_corr_inputs(torch, rng, SPARSE_RUNS[0][1],
                                              h, w, c)
        g = torch.randn(SPARSE_RUNS[0][1], h, w,
                        len(pyr) * (2 * radius + 1) ** 2, device="cuda")
        got = corr_cuda.windowed_correlation_bwd_cuda(
            f1, pyr, centers, g, radius, rescale=False)
        want = corr_cuda.windowed_correlation_bwd_plain(
            f1, pyr, centers, g, radius, rescale=False)
        torch.cuda.synchronize()
        for what, a, b_ in zip(["df1"] + [f"df2 level {lv}"
                                          for lv in range(len(pyr))],
                               (got[0], *got[1]), (want[0], *want[1])):
            d = float((a - b_).abs().max())
            rel = d / float(b_.abs().max())
            err["corr_bwd"] = max(err["corr_bwd"], d)
            corr_bwd_rel = max(corr_bwd_rel, rel)
            print(f"corr_bwd fork lookup {what} C={c} B={SPARSE_RUNS[0][1]} "
                  f"{h}x{w} (rescale=False): max|kernel - plain| = "
                  f"{d:.3e}, / max|plain| = {rel:.3e} (bar "
                  f"{CORR_BWD_REL:g})")
            if not rel <= CORR_BWD_REL:
                fail(f"corr_bwd {what} disagrees with autograd through the "
                     f"plain lookup at the fork lookup, C={c}: {rel:.3e}")

    # -- goldens through three routes --------------------------------------
    with open(os.path.join(ASSETS_DIR, "golden", "manifest.json")) as f:
        manifest = json.load(f)
    gt_mean = float(np.mean([p["epe_vs_gt"] for p in manifest["pairs"]]))
    chain_pred = load_predictor(weights, iters=12, update_impl="chain")
    allpairs_pred = load_predictor(weights, iters=12, corr_impl="fixed")
    for route, pred in (("corr kernel + step kernel", kernel_pred),
                        ("corr kernel + motion, GRU kernels", chain_pred),
                        ("all-pairs + step kernel", allpairs_pred)):
        res = validate_golden(pred)
        print(f"golden [{route}]: parity EPE "
              f"{res['golden_parity_epe']:.3e} (bar {GOLDEN_PARITY_BAR:g}), "
              f"GT EPE {res['golden_gt_epe']:.4f} (manifest {gt_mean:.4f})")
        if not res["golden_parity_epe"] < GOLDEN_PARITY_BAR:
            fail(f"golden parity through {route}")
        if not abs(res["golden_gt_epe"] - gt_mean) < GOLDEN_GT_BAR:
            fail(f"golden GT EPE through {route}")

    # -- serve Sintel-size pairs on both paths -----------------------------
    padder = InputPadder((*SINTEL_HW, 3), mode="sintel")
    frames = []
    for _ in range(SERVE_PAIRS + 1):
        a = rng.uniform(0, 255, (*SINTEL_HW, 3)).astype(np.float32)
        b = np.roll(a, (3, -5), axis=(0, 1))
        frames.append(padder.pad(a, b))
    padded = frames[0][0].shape
    counters = {"corr_fwd": (corr_cuda, "launches"),
                "corr_bwd": (corr_cuda, "bwd_launches"),
                "update_step": (step_cuda, "launches"),
                "corr_fwd_bf16": (corr_cuda, "bf16_launches"),
                "update_step_bf16": (step_cuda, "bf16_launches"),
                "corr_bwd_bf16": (corr_cuda, "bwd_bf16_launches"),
                "motion_fwd": (motion_cuda, "launches"),
                "sepconv_gru": (gru_cuda, "launches"),
                "motion_fwd_bf16": (motion_cuda, "bf16_launches"),
                "sepconv_gru_bf16": (gru_cuda, "bf16_launches"),
                "msda_fwd": (msda_cuda, "launches"),
                "msda_bwd": (msda_cuda, "bwd_launches")}
    serve = load_predictor(weights, iters=SINTEL_ITERS)
    torch.cuda.reset_peak_memory_stats()
    times, launches = serve_pairs(torch, serve, padder, frames, counters)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"serve [step]: {SERVE_PAIRS} Sintel pairs "
          f"{SINTEL_HW[0]}x{SINTEL_HW[1]} (padded {padded[0]}x{padded[1]}), "
          f"iters={SINTEL_ITERS}, B=1: median "
          f"{statistics.median(times):.2f} ms/pair "
          f"(all {', '.join(f'{t:.2f}' for t in times)}); peak memory "
          f"{peak_mib:.1f} MiB")
    serve_shares = print_path_shares(
        corr_cuda, f"serve step: {SERVE_PAIRS} Sintel pairs", ("fwd",))
    check_launches(launches, SERVE_PAIRS,
                   {"corr_fwd": SINTEL_ITERS, "corr_bwd": 0,
                    "update_step": SINTEL_ITERS, "motion_fwd": 0,
                    "sepconv_gru": 0})
    chain = load_predictor(weights, iters=SINTEL_ITERS, update_impl="chain")
    chain_times, chain_launches = serve_pairs(
        torch, chain, padder, frames[:CHAIN_PAIRS + 1], counters)
    print(f"serve [chain]: {CHAIN_PAIRS} Sintel pairs, iters={SINTEL_ITERS}, "
          f"B=1: median {statistics.median(chain_times):.2f} ms/pair "
          f"(all {', '.join(f'{t:.2f}' for t in chain_times)})")
    check_launches(chain_launches, CHAIN_PAIRS,
                   {"corr_fwd": SINTEL_ITERS, "corr_bwd": 0,
                    "update_step": 0, "motion_fwd": SINTEL_ITERS,
                    "sepconv_gru": SINTEL_ITERS})

    pkg = SimpleNamespace(
        RAFT=RAFT, RAFTConfig=RAFTConfig, TrainConfig=TrainConfig,
        SparseRAFT=SparseRAFT, OursConfig=OursConfig,
        create_train_state=create_train_state,
        make_train_step=make_train_step, make_schedule=make_schedule,
        load_npz=load_npz, train=train, corr_cuda=corr_cuda,
        step_cuda=step_cuda, motion_cuda=motion_cuda, gru_cuda=gru_cuda,
        msda=msda, msda_cuda=msda_cuda, load_predictor=load_predictor,
        SPARSE_GOLDEN=SPARSE_GOLDEN, counters=counters,
        FlowPredictor=FlowPredictor,
        validate_golden_small=validate_golden_small,
        forward_interpolate=forward_interpolate, build=build, corr=corr,
        sampling=sampling, validate_golden=validate_golden,
        conv_tile=conv_tile)

    # -- RAFT-small: goldens, then Sintel-size pairs -----------------------
    t0 = time.perf_counter()
    small_goldens(torch, pkg, counters)
    phase_seconds("golden small", t0)
    t0 = time.perf_counter()
    small = load_predictor(SMALL_WEIGHTS, small=True, iters=SINTEL_ITERS)
    small_times, small_launches = serve_pairs(torch, small, padder, frames,
                                              counters)
    print(f"serve small: RAFT-small f32, {SERVE_PAIRS} Sintel pairs "
          f"{SINTEL_HW[0]}x{SINTEL_HW[1]} (padded {padded[0]}x{padded[1]}), "
          f"iters={SINTEL_ITERS}, B=1: median "
          f"{statistics.median(small_times):.2f} ms/pair "
          f"(all {', '.join(f'{t:.2f}' for t in small_times)})")
    small_shares = print_path_shares(
        corr_cuda, f"serve small: {SERVE_PAIRS} Sintel pairs, r="
        f"{small_radius} C={SMALL_C}", ("fwd",))
    check_launches(small_launches, SERVE_PAIRS, {"corr_fwd": SINTEL_ITERS})
    # its lookup timed at the Sintel shape (the backward too, for the
    # small model's training to come)
    small_ct, timed_rel = corr_timings(
        torch, corr_cuda, corr, sampling, rng, small_radius, feat, err,
        c=SMALL_C, cases=[("sintel", 1, *feat["sintel"],
                           CORR_FLOWS["sintel"])])
    corr_bwd_rel = max(corr_bwd_rel, timed_rel)
    phase_seconds("serve small", t0)

    # -- RAFT's serving entry points on RAFT-large -------------------------
    t0 = time.perf_counter()
    ee_launches = early_exit_phase(torch, pkg, serve.model, padder,
                                   counters, err)
    phase_seconds("early exit", t0)
    t0 = time.perf_counter()
    stream_launches = stream_phase(torch, pkg, serve.model, padder, rng,
                                   counters)
    phase_seconds("stream", t0)
    t0 = time.perf_counter()
    table_launches = step_phase(torch, pkg, serve.model, frames, counters,
                                err)
    phase_seconds("step-granular", t0)

    # -- RAFT-large inference under the bf16 mixed-precision policy ---------
    t0 = time.perf_counter()
    mixed_rows = mixed_phase(torch, pkg, weights, padder, frames, rng, feat,
                             radius, counters, err, times)
    phase_seconds("mixed", t0)
    # -- ... on update_impl="chain", and RAFT-small under the policy --------
    t0 = time.perf_counter()
    chain_rows = mixed_chain_phase(torch, pkg, weights, padder, frames, rng,
                                   feat, radius, counters, err,
                                   mixed_rows[0]["ms_per_pair_mixed"])
    phase_seconds("mixed chain", t0)
    t0 = time.perf_counter()
    mixed_rows[0]["small_mixed"] = mixed_small_phase(
        torch, pkg, padder, frames, counters, small_times)
    phase_seconds("mixed small", t0)

    # -- serve SparseRAFT at full OursConfig widths ------------------------
    sparse_problems = []
    sparse_launches = {}
    sparse_preds = {}
    for label, batch, enc in SPARSE_RUNS:
        cfg = OursConfig(encoder_iterations=enc)
        pred = load_predictor("random", model_family="sparse", config=cfg,
                              seed=1)
        frames_b = sparse_frames(batch, seed=3)
        torch.cuda.reset_peak_memory_stats()
        times, sl, flow_up = serve_sparse(torch, pred, frames_b, counters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        ms = statistics.median(times)
        print(f"serve sparse [{label}]: SparseRAFT f32, OursConfig widths "
              f"(d_model {cfg.d_model}, {cfg.num_feature_levels} levels, "
              f"{cfg.outer_iterations} outer iterations, {cfg.num_keypoints} "
              f"keypoints, encoder_iterations {enc}), random weights from "
              f"seed 1, B={batch} {SPARSE_HW[0]}x{SPARSE_HW[1]}: median "
              f"{ms:.2f} ms/forward (all {', '.join(f'{t:.2f}' for t in times)}"
              f"), {1e3 * batch / ms:.2f} pairs/s; peak memory {peak:.1f} MiB; "
              f"max|flow_up| {float(np.abs(flow_up).max()):.3f} px")
        check_launches(sl, SPARSE_TIMED, {
            "corr_fwd": 2 * cfg.num_feature_levels,
            "msda_fwd": cfg.outer_iterations + 2 * enc}, unit="forward")
        sparse_launches[label] = sl
        sparse_preds[label] = (pred, frames_b)
        problem = sparse_against_plain(torch, pkg, pred, frames_b, flow_up,
                                       label)
        if problem:
            sparse_problems.append(problem)
    problem = sparse_fixture_check(torch, pkg, counters)
    if problem:
        sparse_problems.append(problem)

    # -- train: one step against the plain versions, then full size --------
    cmp_launches, problems = train_against_plain(torch, pkg,
                                                 load_npz(weights))
    check_launches(cmp_launches, 1,
                   {"corr_fwd": CMP_ITERS, "corr_bwd": CMP_ITERS,
                    "update_step": CMP_ITERS, "motion_fwd": 0,
                    "sepconv_gru": 0}, unit="step")
    state, tcfg, step_ms, train_launches, train_peak, f32_losses = \
        train_full_size(torch, pkg, weights)
    train_shares = print_path_shares(
        corr_cuda, f"train: {TRAIN_WARMUP + TRAIN_TIMED} chairs steps")
    steps = TRAIN_WARMUP + TRAIN_TIMED
    ms_step = statistics.median(step_ms)
    print(f"train: RAFT-large f32, B={TRAIN_B} {TRAIN_HW[0]}x{TRAIN_HW[1]}, "
          f"iters={TRAIN_ITERS}, {TRAIN_TIMED} timed steps after "
          f"{TRAIN_WARMUP}: median {ms_step:.2f} ms/step "
          f"(all {', '.join(f'{t:.2f}' for t in step_ms)}), "
          f"{1e3 * TRAIN_B / ms_step:.2f} samples/s; peak memory "
          f"{train_peak:.1f} MiB")
    check_launches(train_launches, steps,
                   {"corr_fwd": TRAIN_ITERS, "corr_bwd": TRAIN_ITERS,
                    "update_step": TRAIN_ITERS, "motion_fwd": 0,
                    "sepconv_gru": 0}, unit="step")

    # -- train RAFT-large under the bf16 mixed-precision policy -------------
    t0 = time.perf_counter()
    mixed_train, mixed_train_launches, mixed_steps, mixed_problems = \
        mixed_train_phase(torch, pkg, weights, (
            state, tcfg, step_ms, train_launches, train_peak, f32_losses),
            err)
    problems += mixed_problems
    phase_seconds("mixed train", t0)
    t0 = time.perf_counter()
    chain_train, chain_train_launches, chain_steps, chain_problems = \
        mixed_chain_train_phase(torch, pkg, weights, mixed_train)
    problems += chain_problems
    phase_seconds("mixed chain train", t0)

    # -- train SparseRAFT: one step against the plain versions, then at
    #    the fork's training resolution ---------------------------------
    sparse_cmp_launches, sparse_step_problems = sparse_train_against_plain(
        torch, pkg)
    problems += sparse_step_problems
    ours = OursConfig()
    per_step = {"corr_fwd": 2 * ours.num_feature_levels,
                "corr_bwd": 2 * ours.num_feature_levels,
                "msda_fwd": ours.outer_iterations,
                "msda_bwd": ours.outer_iterations}
    check_launches(sparse_cmp_launches, 1, per_step, unit="step")
    sparse_train = {}
    for label, batch, enc, warmup, timed in SPARSE_TRAIN_RUNS:
        st, stcfg, sms, sl, speak = sparse_train_full_size(
            torch, pkg, label, batch, enc, warmup, timed)
        ms = statistics.median(sms)
        print(f"train sparse [{label}]: SparseRAFT f32, OursConfig widths "
              f"(dropout {ours.dropout}, encoder_iterations {enc}), "
              f"sparse_lambda {SPARSE_LAMBDA}, random weights from seed "
              f"{stcfg.seed}, B={batch} {SPARSE_HW[0]}x{SPARSE_HW[1]}, "
              f"{timed} timed steps after {warmup}: median {ms:.2f} ms/step "
              f"(all {', '.join(f'{t:.2f}' for t in sms)}), "
              f"{1e3 * batch / ms:.2f} samples/s; peak memory "
              f"{speak:.1f} MiB")
        want = dict(per_step, msda_fwd=ours.outer_iterations + 2 * enc,
                    msda_bwd=ours.outer_iterations + 2 * enc)
        check_launches(sl, warmup + timed, want, unit="step")
        sparse_train[label] = (st, stcfg, sl, warmup + timed)
    # each kernel's launches on the path that runs it
    path_of = {"corr_fwd": ("step", launches, SERVE_PAIRS, "pair"),
               "update_step": ("step", launches, SERVE_PAIRS, "pair"),
               "motion_fwd": ("chain", chain_launches, CHAIN_PAIRS, "pair"),
               "sepconv_gru": ("chain", chain_launches, CHAIN_PAIRS, "pair"),
               "corr_bwd": ("train", train_launches, steps, "step"),
               "msda_fwd": ("sparse", sparse_launches[SPARSE_RUNS[0][0]],
                            SPARSE_TIMED, "forward"),
               "msda_bwd": ("sparse train",
                            sparse_train[SPARSE_TRAIN_RUNS[0][0]][2],
                            sparse_train[SPARSE_TRAIN_RUNS[0][0]][3],
                            "step")}
    sparse_train_counts = sparse_train[SPARSE_TRAIN_RUNS[0][0]][2]
    sparse_train_steps = sparse_train[SPARSE_TRAIN_RUNS[0][0]][3]

    # -- kernel times at the Sintel shape ----------------------------------
    kernels = []

    def entry(name, source, replaces, ms, plain_ms, work, library_ms,
              **extra):
        path, counts, units, unit = path_of[name]
        if name in TENSOR_CORE_KERNELS:
            bound_ms, bound_by = bound(*work, peak=TF32X3_FLOPS)
            extra.update(conv_tile_rates(ms, work))
        else:
            bound_ms, bound_by = bound(*work)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path, "launches": counts[name],
            f"launches_per_{unit}": counts[name] / units,
            "train_launches_per_step": train_launches[name] / steps,
            "sparse_train_launches_per_step":
                sparse_train_counts[name] / sparse_train_steps,
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra})

    # the corr kernels on coherent and incoherent flows at the Sintel and
    # chairs shapes, each timed input held against the plain version. The
    # row's ms, plain ms and bound are at Sintel incoherent, the input of
    # the rows before the shared tile; Sintel coherent is under *_coherent,
    # the chairs shape's incoherent times under *_train_shape as before,
    # and every input under by_input.
    ct, timed_rel = corr_timings(torch, corr_cuda, corr, sampling, rng,
                                 radius, feat, err)
    corr_bwd_rel = max(corr_bwd_rel, timed_rel)
    for kind, name, line, extra in (
            ("bwd", "corr_bwd", 276, {"max_rel_err": corr_bwd_rel,
                                      "shared_share_train": train_shares[
                                          "bwd"]}),
            ("fwd", "corr_fwd", 206, {"shared_share_serve": serve_shares[
                                          "fwd"],
                                      "shared_share_train": train_shares[
                                          "fwd"]})):
        main_row = ct[kind]["sintel incoherent"]
        coherent = ct[kind]["sintel coherent"]
        if kind == "bwd":
            extra.update(
                ms_train_shape=ct["bwd"]["chairs incoherent"]["ms"],
                bound_ms_train_shape=ct["bwd"]["chairs incoherent"][
                    "bound_ms"],
                ms_fwd_train_shape=ct["fwd"]["chairs incoherent"]["ms"],
                bound_ms_fwd_train_shape=ct["fwd"]["chairs incoherent"][
                    "bound_ms"])
        entry(name, f"raft_tpu_torch/csrc/{name}.cu",
              f"raft_tpu/ops/corr_pallas.py:{line}", main_row["ms"],
              main_row["plain_ms"], main_row["work"], None,
              shape=f"sintel incoherent: {main_row['shape']}",
              ms_coherent=coherent["ms"],
              plain_ms_coherent=coherent["plain_ms"],
              bound_ms_coherent=coherent["bound_ms"],
              shape_coherent=f"sintel coherent: {coherent['shape']}",
              sass_tf32_mma=sass[name],
              by_input={k: {f: v for f, v in row.items() if f != "work"}
                        for k, row in ct[kind].items()},
              **extra,
              **sparse_corr_times(torch, corr_cuda, rng, sparse_corr, radius,
                                  err, backward=kind == "bwd"))

    with torch.inference_mode():
        h, w = feat["sintel"]
        net, inp, cor, flo = update_inputs(torch, rng, h, w)
        mot = motion_cuda.motion_encoder_plain(flo, cor, m_convs)
        parts = (inp, mot)
        x = torch.cat(parts, dim=-1)
        cell = gru_library(torch, convs)
        net_c, x_c = nchw(net), nchw(x)
        entry("sepconv_gru", "raft_tpu_torch/csrc/sepconv_gru.cu",
              "raft_tpu/ops/gru_pallas.py:245",
              time_ms(torch, lambda: gru_cuda.sepconv_gru_cuda(
                  net, parts, packed)),
              time_ms(torch, lambda: gru_cuda.sepconv_gru_plain(
                  net, parts, convs)),
              gru_work(net, x, packed),
              time_ms(torch, lambda: cell(net_c, x_c)))

        motion_lib = motion_library(torch, m_convs)
        flo_c, cor_c, inp_c = nchw(flo), nchw(cor), nchw(inp)
        entry("motion_fwd", "raft_tpu_torch/csrc/motion_fwd.cu",
              "raft_tpu/ops/motion_pallas.py:165",
              time_ms(torch, lambda: motion_cuda.motion_encoder_cuda(
                  flo, cor, m_packed)),
              time_ms(torch, lambda: motion_cuda.motion_encoder_plain(
                  flo, cor, m_convs)),
              motion_work(flo, cor, m_packed, m_convs),
              time_ms(torch, lambda: motion_lib(flo_c, cor_c)))

        step = {}
        for depth in ("mg", "mgf"):
            lib = step_library(torch, step_convs[depth])
            step[depth] = dict(
                ms=time_ms(torch, lambda: step_cuda.fused_step_cuda(
                    net, inp, cor, flo, step_packed[depth])),
                plain_ms=time_ms(torch, lambda: step_cuda.fused_step_plain(
                    net, inp, cor, flo, step_convs[depth])),
                work=step_work(net, inp, cor, flo, step_packed[depth],
                               step_convs[depth]),
                library_ms=time_ms(torch, lambda: lib(net_c, inp_c, cor_c,
                                                      flo_c)))
        mg_bound_ms, _ = bound(*step["mg"]["work"], peak=TF32X3_FLOPS)
        entry("update_step", "raft_tpu_torch/csrc/update_step.cu",
              "raft_tpu/ops/step_pallas.py:127", **step["mgf"],
              depth="mgf", ms_mg=step["mg"]["ms"],
              plain_ms_mg=step["mg"]["plain_ms"], bound_ms_mg=mg_bound_ms,
              library_ms_mg=step["mg"]["library_ms"],
              **{f"{k}_mg": v for k, v in conv_tile_rates(
                  step["mg"]["ms"], step["mg"]["work"]).items()})
    # the MSDA kernels at both shapes, on incoherent and coherent inputs,
    # each timed input held against the plain versions at every launch; the
    # rows' ms, plain ms and bound are the incoherent inputs' at the
    # planned launch as before, their queued device times under ms_q*,
    # every input and launch under by_input
    mt, timed_rel = msda_timings(torch, msda, msda_cuda, rng, msda_shapes,
                                 err)
    msda_bwd_rel = max(msda_bwd_rel, timed_rel)
    enc_label = SPARSE_RUNS[1][0]
    enc_train = sparse_train[SPARSE_TRAIN_RUNS[1][0]]
    for kind, name, line, extra in (
            ("fwd", "msda_fwd", 95, {
                "launches_per_forward_encoder": sparse_launches[enc_label][
                    "msda_fwd"] / SPARSE_TIMED}),
            ("bwd", "msda_bwd", 124, {
                "max_rel_err": msda_bwd_rel,
                "launches_per_step_encoder": enc_train[2]["msda_bwd"]
                / enc_train[3]})):
        dec, enc = mt[kind]["decoder incoherent"], mt[kind][
            "encoder incoherent"]
        coh = mt[kind]["encoder coherent"]
        entry(name, f"raft_tpu_torch/csrc/{name}.cu",
              f"raft_tpu/ops/msda_pallas.py:{line}", dec["ms"],
              dec["plain_ms"], dec["work"], None,
              shape=f"decoder: {dec['shape']}", ms_q=dec["ms_q"],
              ms_encoder=enc["ms"], plain_ms_encoder=enc["plain_ms"],
              bound_ms_encoder=enc["bound_ms"],
              bound_by_encoder=enc["bound_by"], ms_q_encoder=enc["ms_q"],
              shape_encoder=f"encoder: {enc['shape']}",
              ms_q_encoder_coherent=coh["ms_q"],
              bound_ms_encoder_coherent=coh["bound_ms"],
              by_input={k: {f: v for f, v in row.items() if f != "work"}
                        for k, row in mt[kind].items()},
              **extra)
    named = {k["name"]: k for k in kernels}
    for kind in ("fwd", "bwd"):
        named[f"corr_{kind}"]["small_r3"] = {
            key.split()[1]: {f: v for f, v in row.items() if f != "work"}
            for key, row in small_ct[kind].items()}
    named["corr_fwd"].update(
        launches_small=small_launches["corr_fwd"],
        launches_per_pair_small=small_launches["corr_fwd"] / SERVE_PAIRS,
        shared_share_small_serve=small_shares["fwd"])
    for name in ("corr_fwd", "update_step"):
        named[name].update(
            launches_early_exit=ee_launches[name],
            launches_stream=stream_launches[name],
            launches_step_granular=table_launches[name])
    for k in kernels:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        tile = (f", f32 SIMT bound {k['bound_ms_f32_simt']:.4f} ms, "
                f"{k['tflops']:.2f} TFLOP/s"
                if k["name"] in TENSOR_CORE_KERNELS else "")
        print(f"{k['name']}: {k['ms']:.4f} ms a launch, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}){tile}, plain "
              f"{k['plain_ms']:.4f} ms, library {lib}")
    mg = named["update_step"]
    print(f"update_step 'mg': {mg['ms_mg']:.4f} ms a launch, bound "
          f"{mg['bound_ms_mg']:.4f} ms, f32 SIMT bound "
          f"{mg['bound_ms_f32_simt_mg']:.4f} ms, {mg['tflops_mg']:.2f} "
          f"TFLOP/s, plain {mg['plain_ms_mg']:.4f} ms, library "
          f"{mg['library_ms_mg']:.4f} ms")
    cb, cf = named["corr_bwd"], named["corr_fwd"]
    for k in (cf, cb):
        for key, row in k["by_input"].items():
            print(f"{k['name']} {key} ({row['shape']}): {row['ms']:.4f} ms "
                  f"a launch, queued {row['ms_q']:.4f} ms, bound {row['bound_ms']:.4f} ms (3xTF32), "
                  f"{row['bound_ms_f32_simt']:.4f} ms (f32 SIMT); shared "
                  f"path on {100 * row['shared_share']:.1f}% of (tile, "
                  f"level) blocks"
                  + (f"; plain {row['plain_ms']:.4f} ms" if "plain_ms" in row
                     else ""))
        for c in sparse_corr:
            print(f"{k['name']} fork lookup C={c}: "
                  f"{k['ms_sparse'][str(c)]:.4f} ms a launch, bound "
                  f"{k['bound_ms_sparse'][str(c)]:.4f} ms (3xTF32), "
                  f"{k['bound_ms_f32_simt_sparse'][str(c)]:.4f} ms (f32 "
                  f"SIMT), plain {k['plain_ms_sparse'][str(c)]:.4f} ms; "
                  f"shared path on "
                  f"{100 * k['shared_share_sparse'][str(c)]:.1f}% of blocks")
        print(f"{k['name']} SASS, tensor-core TF32 MMAs: "
              f"{k['sass_tf32_mma']}")
        for flow, row in k["small_r3"].items():
            print(f"{k['name']} RAFT-small {flow} ({row['shape']}): "
                  f"{row['ms']:.4f} ms a launch, queued {row['ms_q']:.4f} ms,"
                  f" bound {row['bound_ms']:.4f} ms (3xTF32), {row['bound_ms_f32_simt']:.4f} ms (f32 "
                  f"SIMT); plain {row['plain_ms']:.4f} ms; shared path on "
                  f"{100 * row['shared_share']:.1f}% of (tile, level) "
                  f"blocks")
    for name in ("msda_fwd", "msda_bwd"):
        k = named[name]
        print(f"{name} at the encoder shape: {k['ms_encoder']:.4f} ms a "
              f"launch, bound {k['bound_ms_encoder']:.4f} ms "
              f"({k['bound_by_encoder']}), plain {k['plain_ms_encoder']:.4f}"
              f" ms")
        for key, row in k["by_input"].items():
            where = (f"{row['slots']} slots a group; forced: "
                     + ", ".join(f"{p} {row['ms_q_' + p]:.4f}"
                                 for p in MSDA_FORCE)
                     if name == "msda_fwd" else "one path")
            print(f"{name} {key} ({row['shape']}): queued {row['ms_q']:.4f} "
                  f"ms a launch ({where}), bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})")
    profile_pair(torch, serve, *frames[1])
    profile_pair(torch, small, *frames[1], label="profile small",
                 per_iteration="corr_fwd_kernel")
    pred, frames_b = sparse_preds[SPARSE_RUNS[0][0]]
    sparse_shares = profile_by_name(
        torch, lambda: pred.predict_batch(*frames_b), "sparse profile",
        f"one forward at the defaults (B={SPARSE_RUNS[0][1]}, "
        f"{SPARSE_HW[0]}x{SPARSE_HW[1]})")
    if sparse_shares:
        named["msda_fwd"]["device_share_sparse_forward"] = sparse_shares[
            "msda_fwd_kernel"]
        named["corr_fwd"]["device_share_sparse_forward"] = sparse_shares[
            "corr_fwd_kernel"]
    profile_train_step(
        torch, make_train_step(tcfg, alternate_corr=True), state,
        synthetic_batch(torch, TRAIN_B, TRAIN_HW,
                        torch.Generator(device="cuda").manual_seed(3)))
    label, batch = SPARSE_TRAIN_RUNS[0][:2]
    st, stcfg, _, _ = sparse_train[label]
    sparse_step = make_train_step(stcfg)
    sbatch = synthetic_batch(torch, batch, SPARSE_HW,
                             torch.Generator(device="cuda").manual_seed(8))
    train_shares = profile_by_name(
        torch, lambda: sparse_step(st, sbatch), "sparse train profile",
        f"one train step at the defaults (B={batch}, "
        f"{SPARSE_HW[0]}x{SPARSE_HW[1]}, sparse_lambda {SPARSE_LAMBDA})")
    for name in ("msda_fwd", "msda_bwd", "corr_fwd", "corr_bwd"):
        if train_shares:
            named[name]["device_share_sparse_train_step"] = train_shares[
                f"{name}_kernel"]
    if problems:
        fail("kernel and plain train steps disagree: " + "; ".join(problems))
    if sparse_problems:
        fail("sparse checks failed: " + "; ".join(sparse_problems))
    for row in mixed_rows:
        row["train_launches_per_step"] = (
            mixed_train_launches[row["name"]] / mixed_steps)
    for row in chain_rows:
        row["train_launches_per_step"] = (
            chain_train_launches[row["name"]] / chain_steps)
    chain_rows[0].update(chain_train)
    main_bwd = mixed_train["chairs coherent bfloat16/float32"]
    mixed_rows.append({
        "name": "corr_bwd_bf16", "route": "cuda",
        "source": "raft_tpu_torch/csrc/corr_bwd_bf16.cu",
        "replaces": "raft_tpu/ops/corr_pallas.py:276", "path": "mixed train",
        "launches": mixed_train_launches["corr_bwd_bf16"],
        "launches_per_step": mixed_train_launches["corr_bwd_bf16"]
        / mixed_steps,
        "max_abs_err": err["corr_bwd_bf16"],
        "max_rel_err": mixed_train["max_rel_err"], "ms": main_bwd["ms"],
        "plain_ms": main_bwd["plain_ms"], "bound_ms": main_bwd["bound_ms"],
        "bound_by": main_bwd["bound_by"], "library_ms": None,
        "ms_q": main_bwd["ms_q"], "f32_form_ms_q": main_bwd["f32_form_ms_q"],
        "shape": f"chairs coherent: {main_bwd['shape']}",
        "readings": mixed_train["readings"],
        "by_input": {k: v for k, v in mixed_train.items()
                     if isinstance(v, dict) and "ms" in v},
        **{k: v for k, v in mixed_train.items()
           if k in ("ms_per_step_mixed", "ms_per_step_f32", "loss_gap_max",
                    "peak_mib_mixed", "shared_share_train",
                    "profile_mixed", "sass_tf32_mma", "sass_bf16_mma")}})
    print(f"corr_bwd_bf16: {main_bwd['ms']:.4f} ms a launch, queued "
          f"{main_bwd['ms_q']:.4f} ms, bound {main_bwd['bound_ms']:.4f} ms "
          f"({main_bwd['bound_by']}, three bf16 passes at 329.7 TFLOP/s "
          f"and HBM), "
          f"plain {main_bwd['plain_ms']:.4f} ms, library none, the float32 "
          f"form corr_bwd queued {main_bwd['f32_form_ms_q']:.4f} ms on the "
          f"same inputs ({main_bwd['shape']})")
    kernels.extend(mixed_rows + chain_rows)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
