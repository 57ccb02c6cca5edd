#!/usr/bin/env python3
"""Smoke run of the PyTorch port (raft_tpu_torch) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's six CUDA kernels from ``raft_tpu_torch/csrc`` (one
``nvcc`` each, all at once), holds each kernel against its plain PyTorch
version at the golden and Sintel feature shapes (the GRU with x whole and
as parts, the step kernel at both depths, the corr backward against
autograd through the plain lookup) and at the sparse family's shapes (the
corr forward at its fork lookup, C = 128, 192 and 256 with no per-level
rescale; ``msda_fwd`` at the decoder's and the dense encoder's shapes),
checks RAFT-large against the committed goldens through three routes
(on-demand correlation with the step kernel, with the motion and GRU
kernels, and the all-pairs engine), serves five Sintel-size pairs
(436x1024, iters=32) on the default path and two on the
``update_impl="chain"`` path through the port's ``FlowPredictor``, serves
SparseRAFT at full OursConfig widths through ``load_predictor("random",
model_family="sparse")`` (352x480, B=8 at the defaults and B=4 with
``encoder_iterations=2``), holds those forwards against the plain route
and the tiny JAX-made fixture's flow against JAX's, holds one train step
through the kernels against the same step through the plain versions (B=2,
184x248, iters=4), trains RAFT-large for 7 steps at the chairs defaults
(B=8, 368x496, iters=12) through the port's ``train`` on synthetic batches,
counting kernel launches on every path, times each kernel beside its plain
version, its bound and a cuDNN yardstick where one exists, profiles one
Sintel pair, one sparse forward and one train step, and prints one JSON
line of kernel numbers. The last line is ``{"ok": true, "device":
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
DEVICE = "cuda"               # the train helpers' device
# Published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3 bandwidth.
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


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


def bound(flops: float, nbytes: float):
    """Least time on the card: the larger of operations over the f32 peak
    and bytes over the memory rate. Returns (ms, "operations"|"bytes")."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def corr_inputs(torch, sampling, corr, rng, h, w, c=256, levels=4):
    dev = torch.device("cuda")
    f1 = torch.tensor(rng.standard_normal((1, h, w, c)), dtype=torch.float32,
                      device=dev)
    f2 = torch.tensor(rng.standard_normal((1, h, w, c)), dtype=torch.float32,
                      device=dev)
    pyramid = corr.build_feature_pyramid(f2, levels)
    # flows up to 40 px move many windows partly or wholly off the image;
    # non-integer by construction
    flow = rng.uniform(-40.0, 40.0, (1, h, w, 2))
    coords = (sampling.coords_grid(1, h, w, dev)
              + torch.tensor(flow, dtype=torch.float32, device=dev))
    return f1, pyramid, coords.contiguous()


def in_range_neighbours(torch, pyramid, coords, radius):
    """In-range integer neighbours of every query's (2r+2)^2 grid, summed
    over the levels: the dot products the corr kernels do on these
    inputs."""
    steps = torch.arange(2 * radius + 2, device=coords.device)
    neighbours = 0
    for lvl, f2 in enumerate(pyramid):
        cl = coords / (2 ** lvl)
        xs = torch.floor(cl[..., 0:1]) - radius + steps
        ys = torch.floor(cl[..., 1:2]) - radius + steps
        nx = ((xs >= 0) & (xs < f2.shape[2])).sum(-1)
        ny = ((ys >= 0) & (ys < f2.shape[1])).sum(-1)
        neighbours += int((nx * ny).sum())
    return neighbours


def corr_work(torch, f1, pyramid, coords, radius):
    """Operations and bytes of one lookup on these inputs: a dot product
    of C channels for each in-range integer neighbour, 8 operations for
    each bilinear output; every input read once, the output written once."""
    b, h, w, c = f1.shape
    win = 2 * radius + 1
    outputs = b * h * w * len(pyramid) * win * win
    flops = (2 * c * in_range_neighbours(torch, pyramid, coords, radius)
             + 8 * outputs)
    nbytes = 4 * (f1.numel() + sum(f.numel() for f in pyramid)
                  + coords.numel() + outputs)
    return flops, nbytes


def corr_bwd_work(torch, f1, pyramid, coords, radius):
    """Operations and bytes of one backward on these inputs: two
    multiply-adds of C channels (df1 and df2) for each in-range neighbour,
    8 operations for each of the (2r+2)^2 coefficients of a query and
    level; f1, the levels, coords and the cotangent read once, df1 and the
    df2 levels written once."""
    b, h, w, c = f1.shape
    win = 2 * radius + 1
    queries = b * h * w * len(pyramid)
    flops = (4 * c * in_range_neighbours(torch, pyramid, coords, radius)
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
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


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


def profile_pair(torch, predictor, im1, im2, top: int = 10):
    """One pair under torch.profiler: device time by kernel name and the
    share of the (profiled, so inflated) wall time the device was busy."""
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
        print("profile: the profiler recorded no device time (not measured)")
        return
    busy = busy_ms(events)
    print_overlaps("profile", events, device_ms, busy)
    steps = sum(n for name, (_, n) in by_name.items()
                if "update_step_kernel" in name)
    if steps != SINTEL_ITERS:
        fail(f"the profiled pair launched the step kernel {steps} times, "
             f"expected {SINTEL_ITERS}")
    cudnn_convs = sum(n for name, (_, n) in by_name.items()
                      if "fprop" in name)
    print(f"profile: update_step_kernel launched {steps} times; "
          f"{cudnn_convs} cuDNN convolution launches (the encoders and the "
          f"final iteration's heads); "
          f"{sum(n for _, n in by_name.values())} device launches in all")
    print(f"profile: one Sintel pair, device busy {busy:.2f} ms of "
          f"{wall_ms:.2f} ms wall under the profiler "
          f"({100 * busy / wall_ms:.1f}%), device time {device_ms:.2f} ms, "
          f"{len(by_name)} kernel names")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        print(f"  {ms:8.3f} ms {100 * ms / device_ms:5.1f}% {n:5d}x  "
              f"{name[:90]}")


@contextlib.contextmanager
def plain_route(corr_cuda, step_cuda, motion_cuda, gru_cuda, msda,
                perturb=None):
    """Every kernel's dispatcher replaced by its plain version (autograd
    through plain PyTorch), for the duration: the reference the kernel
    route is held against on the card. ``perturb``: a generator; the
    lookup's, the step's and the MSDA core's outputs are then multiplied by
    1 + PERTURB * N(0, 1) from it."""
    def noisy(out):
        if perturb is None:
            return out
        return out * (1 + PERTURB * torch_randn_like(out, perturb))

    def torch_randn_like(t, gen):
        return t.new_empty(t.shape).normal_(generator=gen)

    swaps = {
        (corr_cuda, "windowed_correlation_fused"):
            lambda f1, pyr, c, r, scale=True, rescale=True: noisy(
                corr_cuda.windowed_correlation_fused_plain(f1, pyr, c, r,
                                                           scale, rescale)),
        (msda, "ms_deform_attn"):
            lambda v, shapes, loc, aw: noisy(
                msda.ms_deform_attn_plain(v, shapes, loc, aw)),
        (step_cuda, "fused_step"):
            lambda net, inp, corr, flow, convs, packed: noisy(
                step_cuda.fused_step_plain(net, inp, corr, flow, convs)),
        (motion_cuda, "motion_encoder"):
            lambda flow, corr, convs, packed:
            motion_cuda.motion_encoder_plain(flow, corr, convs),
        (gru_cuda, "sepconv_gru"):
            lambda h, x, convs, packed: gru_cuda.sepconv_gru_plain(h, x,
                                                                   convs)}
    saved = {key: getattr(*key) for key in swaps}
    try:
        for (mod, attr), fn in swaps.items():
            setattr(mod, attr, fn)
        yield
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


@contextlib.contextmanager
def plain_corr_backward(corr_cuda):
    """The kernel route with only the lookup's backward kernel replaced by
    autograd through the plain lookup: the corr_bwd kernel in situ."""
    saved = corr_cuda.windowed_correlation_bwd_cuda
    corr_cuda.windowed_correlation_bwd_cuda = \
        corr_cuda.windowed_correlation_bwd_plain
    try:
        yield
    finally:
        corr_cuda.windowed_correlation_bwd_cuda = saved


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


def train_against_plain(torch, pkg, weights):
    """One train step (B=2, 184x248, iters=4, chairs defaults) from the
    fixture weights, on one batch, through the kernels; through the kernels
    with the plain lookup backward in place of corr_bwd; and through the
    plain versions three times (twice as they are, once perturbed): the
    loss, grad_norm, every parameter's (clipped) gradient, every updated
    parameter and the batch-norm statistics. Returns the kernel route's
    launches and a list of the checks that failed."""
    tcfg = pkg.TrainConfig(batch_size=CMP_B, image_size=CMP_HW,
                           iters=CMP_ITERS, num_steps=100)
    batch = synthetic_batch(torch, CMP_B, CMP_HW,
                            torch.Generator(device=DEVICE).manual_seed(1))
    lr = pkg.make_schedule(tcfg)(0)

    def step():
        model = pkg.RAFT(pkg.RAFTConfig(alternate_corr=True))
        model.load_state_dict(weights)
        state = pkg.create_train_state(model.to(DEVICE), tcfg)
        metrics = pkg.make_train_step(tcfg, alternate_corr=True)(state,
                                                                  batch)
        # p.grad keeps the clipped gradient the update used
        return (metrics, model.state_dict(),
                {n: p.grad for n, p in model.named_parameters()})

    reset_counts(pkg.counters)
    kernel = step()
    launches = read_counts(pkg.counters)
    with plain_corr_backward(pkg.corr_cuda):
        kernel_plain_bwd = step()
    mods = (pkg.corr_cuda, pkg.step_cuda, pkg.motion_cuda, pkg.gru_cuda,
            pkg.msda)
    with plain_route(*mods):
        plain, again = step(), step()
    with plain_route(*mods, perturb=torch.Generator(
            device=DEVICE).manual_seed(4)):
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
            if not cancelled_by_norm(name):
                rel = float((a[2][name] - g).abs().max() / g.abs().max())
                worst["grad"] = max(worst["grad"], (rel, name))
            exact = g.abs() >= ADAM_EXACT
            for kind, where in (("param", exact), ("near0", ~exact)):
                if bool(where.any()):
                    worst[kind] = max(worst[kind],
                                      (float(diff[where].max()), name))
        return worst

    problems = []
    for what, key, bar in (("loss", "loss", LOSS_REL),
                           ("grad_norm", "grad_norm", NORM_REL)):
        a, b = kernel[0][key], plain[0][key]
        rel = abs(a - b) / abs(b)
        print(f"train step kernel vs plain: {what} {a:.7g} vs {b:.7g}, "
              f"relative difference {rel:.3e} (bar {bar:g})")
        if not (math.isfinite(a) and rel <= bar):
            problems.append(f"train step {what}")
    spread = compare(again, plain)
    moved = compare(perturbed, plain)

    def check(label, got, base, bar, base_label):
        limit = max(bar, SPREAD_MARGIN * base[0])
        print(f"train step {label}: {got[0]:.3e} ({got[1]}); {base_label} "
              f"{base[0]:.3e} ({base[1]}); bar {limit:.3g}")
        if not got[0] <= limit:
            problems.append(f"train step {label}")

    insitu = compare(kernel_plain_bwd, kernel)
    check("corr_bwd in situ (kernel route, its backward vs autograd "
          "through the plain lookup), gradients max|diff| / max|plain|",
          insitu["grad"], spread["grad"], GRAD_REL, "plain vs plain")
    got = compare(kernel, plain)
    check("kernel vs plain, gradients max|diff| / max|plain| (the conv "
          "biases a norm cancels left out)", got["grad"], moved["grad"],
          GRAD_REL, f"plain vs plain perturbed by {PERTURB:g}")
    check(f"kernel vs plain, parameters after one AdamW update at lr "
          f"{lr:.3g} where |gradient| >= {ADAM_EXACT:g}", got["param"],
          moved["param"], PARAM_BAR, f"plain vs plain perturbed by "
          f"{PERTURB:g}")
    check("kernel vs plain, parameters elsewhere", got["near0"], (0.0, ""),
          2 * lr, "bound 2 lr")
    check("kernel vs plain, BN running statistics", got["bn"], spread["bn"],
          BN_BAR, "plain vs plain")
    if any(r[0]["skipped_steps"] for r in (kernel, plain)):
        problems.append("the kernel-vs-plain train step was skipped")
    return launches, problems


def train_full_size(torch, pkg, weights_path):
    """RAFT-large through ``raft_tpu_torch.train.train`` at the chairs
    defaults (B=8, 368x496, iters=12, lr 4e-4 one-cycle, AdamW, clip 1.0,
    gamma 0.8, batch norm training) from the fixture weights, on synthetic
    batches made on the card, 2 warm-up and 5 timed steps, with every launch
    counter set to 0 just before. Returns (state, ms per step, launches,
    peak MiB)."""
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
    state = pkg.train(tcfg, pkg.RAFTConfig(), dataloader=loader,
                      restore_ckpt=weights_path, device=DEVICE,
                      logger=Logger())
    torch.cuda.synchronize()
    end = time.perf_counter()
    launches = read_counts(pkg.counters)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    ms = [1e3 * (b - a) for a, b in zip(loader.pulls,
                                         loader.pulls[1:] + [end])]
    if state.step != steps or len(logged) != steps:
        fail(f"train() took {state.step} steps, expected {steps}")
    for n, (m, lr) in enumerate(logged):
        print(f"  step {n}: loss {m['loss']:.5f}, grad_norm "
              f"{m['grad_norm']:.4f}, epe {m['epe']:.4f}, lr {lr:.4g}, "
              f"{ms[n]:.1f} ms{' (warm-up)' if n < TRAIN_WARMUP else ''}")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and not m["skipped_steps"]):
            fail(f"train step {n} was not finite")
    start = pkg.load_npz(weights_path)
    still = [n for n, p in state.model.named_parameters()
             if torch.equal(p.detach().cpu(), start[n])]
    if still:
        fail(f"{len(still)} parameters did not change in training: "
             f"{still[:3]}")
    block = state.model.update_block
    for module, pack in ((block.encoder, pkg.motion_cuda.pack_weights),
                         (block.gru, pkg.gru_cuda.pack_weights)):
        if not all(torch.equal(a, b) for a, b in
                   zip(module.packed_weights(), pack(module.convs()))):
            fail("a packed-weight cache was not refreshed after the "
                 "optimizer's updates")
    return state, tcfg, ms[TRAIN_WARMUP:], launches, peak_mib


# Categories of a train step's device time (profile_train_step), in order
# of precedence: a kernel belongs to the first whose marker names the
# kernel or one of the profiler ranges around its launch.
TRAIN_SPLIT = (
    ("forward kernels (corr_fwd, update_step)",
     ("corr_fwd_kernel", "update_step_kernel")),
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
               ("corr_fwd_kernel", "update_step_kernel")),
              ("corr_bwd", ("corr_bwd_kernel",)),
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


def profile_train_step(torch, step_fn, state, batch):
    """One train step under torch.profiler: device time split by
    TRAIN_SPLIT (else DEFAULT_SPLIT) from the host ranges around each
    kernel's launch, and by kernel name (NAME_SPLIT)."""
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
        print("train profile: the profiler recorded no device time "
              "(not measured)")
        return {}
    busy = busy_ms(events)
    print_overlaps("train profile", events, device_ms, busy)
    print(f"train profile: one step at B={TRAIN_B} {TRAIN_HW[0]}x"
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


def msda_work(torch, value, levels, loc, aw):
    """Operations and bytes of one MSDA call on these inputs: 2 D
    operations for each in-range corner and 12 for each sample's corner
    weights; the locations and weights read once, the output written once,
    and each distinct value row (pixel, head) that an in-range corner
    touches read once."""
    b, s, m, d = value.shape
    lq, p = loc.shape[1], loc.shape[4]
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
    distinct = int(torch.unique(torch.cat(rows)).numel())
    flops = 2 * d * corners + 12 * aw.numel()
    nbytes = 4 * (loc.numel() + aw.numel() + b * lq * m * d + distinct * d)
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


def fork_corr_work(torch, f1, pyr, centers, radius):
    """corr_work for the fork lookup: every level sampled around the
    centres themselves."""
    b, h, w, c = f1.shape
    win = 2 * radius + 1
    steps = torch.arange(2 * radius + 2, device=centers.device)
    neighbours = 0
    for f2 in pyr:
        xs = torch.floor(centers[..., 0:1]) - radius + steps
        ys = torch.floor(centers[..., 1:2]) - radius + steps
        nx = ((xs >= 0) & (xs < f2.shape[2])).sum(-1)
        ny = ((ys >= 0) & (ys < f2.shape[1])).sum(-1)
        neighbours += int((nx * ny).sum())
    outputs = b * h * w * len(pyr) * win * win
    flops = 2 * c * neighbours + 8 * outputs
    nbytes = 4 * (f1.numel() + sum(f.numel() for f in pyr) + centers.numel()
                  + outputs)
    return flops, nbytes


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


# Categories of a sparse forward's device time by kernel name, in order of
# precedence (profile_sparse).
SPARSE_SPLIT = (
    ("msda_fwd", ("msda_fwd_kernel",)),
    ("corr_fwd", ("corr_fwd_kernel",)),
    ("batch, group and layer norms", ("norm", "bn_fw")),
    ("cuDNN convolutions (implicit GEMM and FFT)",
     ("fprop", "fft", "pointwise_mult_and_sum_complex", "convolve",
      "cudnn", "winograd")),
    ("host-to-device copies", ("memcpy htod",)))


def profile_sparse(torch, predictor, frames, top: int = 10):
    """One sparse forward under torch.profiler: device busy share of the
    (profiled, so inflated) wall time, the shares of the device time of the
    corr and MSDA kernels and the top device operations by time. Returns
    the MSDA and corr shares."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict_batch(*frames)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = defaultdict(lambda: [0.0, 0])
    events = device_events(torch, prof)
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    device_ms = sum(t for t, _ in by_name.values())
    if not device_ms:
        print("sparse profile: the profiler recorded no device time (not "
              "measured)")
        return {}
    busy = busy_ms(events)
    print_overlaps("sparse profile", events, device_ms, busy)
    shares = {}
    for kernel in ("msda_fwd_kernel", "corr_fwd_kernel"):
        ms = sum(t for name, (t, _) in by_name.items() if kernel in name)
        n = sum(c for name, (_, c) in by_name.items() if kernel in name)
        shares[kernel] = ms / device_ms
        print(f"sparse profile: {kernel}: {n} launches, {ms:.3f} ms, "
              f"{100 * ms / device_ms:.1f}% of device time")
    print(f"sparse profile: one forward at the defaults (B={SPARSE_RUNS[0][1]}"
          f", {SPARSE_HW[0]}x{SPARSE_HW[1]}): device busy {busy:.2f} ms of "
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
    print("sparse profile by kernel name:")
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


def sparse_corr_times(torch, corr_cuda, rng, sparse_corr, radius):
    """corr_fwd at the fork lookup's three token levels (B=8 at 352x480):
    the kernel's and the plain version's ms a launch and the bound, keyed
    by C, for the corr_fwd row."""
    out = {"ms_sparse": {}, "plain_ms_sparse": {}, "bound_ms_sparse": {}}
    for c, (h, w) in sparse_corr.items():
        f1, pyr, centers = sparse_corr_inputs(torch, rng, SPARSE_RUNS[0][1],
                                              h, w, c)
        out["ms_sparse"][str(c)] = time_ms(
            torch, lambda: corr_cuda.windowed_correlation_cuda(
                f1, pyr, centers, radius, rescale=False))
        out["plain_ms_sparse"][str(c)] = time_ms(
            torch, lambda: corr_cuda.windowed_correlation_fused_plain(
                f1, pyr, centers, radius, rescale=False), n=10)
        out["bound_ms_sparse"][str(c)] = bound(*fork_corr_work(
            torch, f1, pyr, centers, radius))[0]
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, REPO)
    from types import SimpleNamespace

    from raft_tpu_torch.config import OursConfig, RAFTConfig, TrainConfig
    from raft_tpu_torch.evaluate import (ASSETS_DIR, SPARSE_GOLDEN,
                                         load_predictor, use_float32_math,
                                         validate_golden)
    from raft_tpu_torch.models import corr
    from raft_tpu_torch.models.raft import RAFT
    from raft_tpu_torch.ops import (build, corr_cuda, gru_cuda, motion_cuda,
                                    msda, msda_cuda, sampling, step_cuda)
    from raft_tpu_torch.optim import make_schedule
    from raft_tpu_torch.parallel.train_step import (create_train_state,
                                                    make_train_step)
    from raft_tpu_torch.train import train
    from raft_tpu_torch.utils.padder import InputPadder
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
           "motion_fwd": 0.0, "update_step": 0.0, "msda_fwd": 0.0}
    corr_bwd_rel = 0.0
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
                "motion_fwd": (motion_cuda, "launches"),
                "sepconv_gru": (gru_cuda, "launches"),
                "msda_fwd": (msda_cuda, "launches")}
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
        create_train_state=create_train_state,
        make_train_step=make_train_step, make_schedule=make_schedule,
        load_npz=load_npz, train=train, corr_cuda=corr_cuda,
        step_cuda=step_cuda, motion_cuda=motion_cuda, gru_cuda=gru_cuda,
        msda=msda, load_predictor=load_predictor,
        SPARSE_GOLDEN=SPARSE_GOLDEN, counters=counters)

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
    state, tcfg, step_ms, train_launches, train_peak = train_full_size(
        torch, pkg, weights)
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
    # each kernel's launches on the path that runs it
    path_of = {"corr_fwd": ("step", launches, SERVE_PAIRS, "pair"),
               "update_step": ("step", launches, SERVE_PAIRS, "pair"),
               "motion_fwd": ("chain", chain_launches, CHAIN_PAIRS, "pair"),
               "sepconv_gru": ("chain", chain_launches, CHAIN_PAIRS, "pair"),
               "corr_bwd": ("train", train_launches, steps, "step"),
               "msda_fwd": ("sparse", sparse_launches[SPARSE_RUNS[0][0]],
                            SPARSE_TIMED, "forward")}

    # -- kernel times at the Sintel shape ----------------------------------
    kernels = []

    def entry(name, source, replaces, ms, plain_ms, work, library_ms,
              **extra):
        path, counts, units, unit = path_of[name]
        bound_ms, bound_by = bound(*work)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path, "launches": counts[name],
            f"launches_per_{unit}": counts[name] / units,
            "train_launches_per_step": train_launches[name] / steps,
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra})

    # corr_bwd at the Sintel shape of the corr_fwd row (its plain version
    # needs autograd, so outside inference mode), and at the train shape
    h, w = feat["sintel"]
    f1, pyr, coords = corr_inputs(torch, sampling, corr, rng, h, w)
    g = torch.randn(1, h, w, len(pyr) * (2 * radius + 1) ** 2, device="cuda")
    th, tw = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    tf1 = torch.randn(TRAIN_B, th, tw, 256, device="cuda")
    tpyr = corr.build_feature_pyramid(
        torch.randn(TRAIN_B, th, tw, 256, device="cuda"), 4)
    # chairs-like motion: flows up to 4 feature pixels (32 image pixels)
    tcoords = (sampling.coords_grid(TRAIN_B, th, tw, "cuda")
               + 8.0 * torch.rand(TRAIN_B, th, tw, 2, device="cuda")
               - 4.0).contiguous()
    tg = torch.randn(TRAIN_B, th, tw, len(tpyr) * (2 * radius + 1) ** 2,
                     device="cuda")
    train_bound_ms, _ = bound(*corr_bwd_work(torch, tf1, tpyr, tcoords,
                                             radius))
    entry("corr_bwd", "raft_tpu_torch/csrc/corr_bwd.cu",
          "raft_tpu/ops/corr_pallas.py:276",
          time_ms(torch, lambda: corr_cuda.windowed_correlation_bwd_cuda(
              f1, pyr, coords, g, radius)),
          time_ms(torch, lambda: corr_cuda.windowed_correlation_bwd_plain(
              f1, pyr, coords, g, radius), n=10),
          corr_bwd_work(torch, f1, pyr, coords, radius), None,
          max_rel_err=corr_bwd_rel,
          ms_train_shape=time_ms(
              torch, lambda: corr_cuda.windowed_correlation_bwd_cuda(
                  tf1, tpyr, tcoords, tg, radius)),
          bound_ms_train_shape=train_bound_ms,
          ms_fwd_train_shape=time_ms(
              torch, lambda: corr_cuda.windowed_correlation_cuda(
                  tf1, tpyr, tcoords, radius)))

    with torch.inference_mode():
        h, w = feat["sintel"]
        f1, pyr, coords = corr_inputs(torch, sampling, corr, rng, h, w)
        entry("corr_fwd", "raft_tpu_torch/csrc/corr_fwd.cu",
              "raft_tpu/ops/corr_pallas.py:206",
              time_ms(torch, lambda: corr_cuda.windowed_correlation_cuda(
                  f1, pyr, coords, radius)),
              time_ms(torch, lambda: corr_cuda
                      .windowed_correlation_fused_plain(
                          f1, pyr, coords, radius), n=20),
              corr_work(torch, f1, pyr, coords, radius), None,
              **sparse_corr_times(torch, corr_cuda, rng, sparse_corr, radius))

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
        mg_bound_ms, _ = bound(*step["mg"]["work"])
        entry("update_step", "raft_tpu_torch/csrc/update_step.cu",
              "raft_tpu/ops/step_pallas.py:127", **step["mgf"],
              depth="mgf", ms_mg=step["mg"]["ms"],
              plain_ms_mg=step["mg"]["plain_ms"], bound_ms_mg=mg_bound_ms,
              library_ms_mg=step["mg"]["library_ms"])
        msda_times = {}
        for label, (b, lq, d_head) in msda_shapes.items():
            value, loc, aw = msda_inputs(torch, rng, b, lq, d_head)
            msda_times[label] = (
                time_ms(torch, lambda: msda_cuda.ms_deform_attn_cuda(
                    value, SPARSE_LEVELS, loc, aw)),
                time_ms(torch, lambda: msda.ms_deform_attn_plain(
                    value, SPARSE_LEVELS, loc, aw), n=10),
                msda_work(torch, value, SPARSE_LEVELS, loc, aw))
        enc_label = SPARSE_RUNS[1][0]
        entry("msda_fwd", "raft_tpu_torch/csrc/msda_fwd.cu",
              "raft_tpu/ops/msda_pallas.py:95", *msda_times["decoder"], None,
              shape="decoder: B=8 Lq=100 M=8 D=16 L=6 P=4",
              ms_encoder=msda_times["encoder"][0],
              plain_ms_encoder=msda_times["encoder"][1],
              bound_ms_encoder=bound(*msda_times["encoder"][2])[0],
              bound_by_encoder=bound(*msda_times["encoder"][2])[1],
              shape_encoder="encoder: B=4 Lq=6930 M=8 D=8 L=6 P=4",
              launches_per_forward_encoder=sparse_launches[enc_label][
                  "msda_fwd"] / SPARSE_TIMED)
    for k in kernels:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        print(f"{k['name']}: {k['ms']:.4f} ms a launch, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}), plain "
              f"{k['plain_ms']:.4f} ms, library {lib}")
    named = {k["name"]: k for k in kernels}
    mg = named["update_step"]
    print(f"update_step 'mg': {mg['ms_mg']:.4f} ms a launch, bound "
          f"{mg['bound_ms_mg']:.4f} ms, plain {mg['plain_ms_mg']:.4f} ms, "
          f"library {mg['library_ms_mg']:.4f} ms")
    cb = named["corr_bwd"]
    print(f"corr_bwd at the train shape (B={TRAIN_B}, {th}x{tw}, flows up "
          f"to 4 px): {cb['ms_train_shape']:.4f} ms a launch, bound "
          f"{cb['bound_ms_train_shape']:.4f} ms; corr_fwd there "
          f"{cb['ms_fwd_train_shape']:.4f} ms")
    cf = named["corr_fwd"]
    for c in sparse_corr:
        print(f"corr_fwd fork lookup C={c}: {cf['ms_sparse'][str(c)]:.4f} ms "
              f"a launch, bound {cf['bound_ms_sparse'][str(c)]:.4f} ms, plain "
              f"{cf['plain_ms_sparse'][str(c)]:.4f} ms")
    md = named["msda_fwd"]
    print(f"msda_fwd at the encoder shape: {md['ms_encoder']:.4f} ms a "
          f"launch, bound {md['bound_ms_encoder']:.4f} ms "
          f"({md['bound_by_encoder']}), plain {md['plain_ms_encoder']:.4f} ms")
    profile_pair(torch, serve, *frames[1])
    sparse_shares = profile_sparse(torch, *sparse_preds[SPARSE_RUNS[0][0]])
    if sparse_shares:
        named["msda_fwd"]["device_share_sparse_forward"] = sparse_shares[
            "msda_fwd_kernel"]
        named["corr_fwd"]["device_share_sparse_forward"] = sparse_shares[
            "corr_fwd_kernel"]
    profile_train_step(
        torch, make_train_step(tcfg, alternate_corr=True), state,
        synthetic_batch(torch, TRAIN_B, TRAIN_HW,
                        torch.Generator(device="cuda").manual_seed(3)))
    if problems:
        fail("kernel and plain train steps disagree: " + "; ".join(problems))
    if sparse_problems:
        fail("sparse checks failed: " + "; ".join(sparse_problems))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
