#!/usr/bin/env python3
"""Smoke run of the PyTorch port (raft_tpu_torch) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's four CUDA kernels from ``raft_tpu_torch/csrc`` (one
``nvcc`` each, all at once), holds each kernel against its plain PyTorch
version at the golden and Sintel feature shapes (the GRU with x whole and
as parts, the step kernel at both depths), checks RAFT-large against the
committed goldens through three routes (on-demand correlation with the
step kernel, with the motion and GRU kernels, and the all-pairs engine),
serves five Sintel-size pairs (436x1024, iters=32) on the default path and
two on the ``update_impl="chain"`` path through the port's
``FlowPredictor`` while counting kernel launches, times each kernel beside
its plain version, its bound and a cuDNN yardstick where one exists,
profiles one pair, and prints one JSON line of kernel numbers. The last
line is ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that line; without a CUDA card it exits non-zero at once.
"""

import json
import os
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


def corr_work(torch, f1, pyramid, coords, radius):
    """Operations and bytes of one lookup on these inputs: a dot product
    of C channels for each in-range integer neighbour, 8 operations for
    each bilinear output; every input read once, the output written once."""
    _, h, w, c = f1.shape
    win = 2 * radius + 1
    steps = torch.arange(2 * radius + 2, device=coords.device)
    neighbours = 0
    for lvl, f2 in enumerate(pyramid):
        cl = coords / (2 ** lvl)
        xs = torch.floor(cl[..., 0:1]) - radius + steps
        ys = torch.floor(cl[..., 1:2]) - radius + steps
        nx = ((xs >= 0) & (xs < f2.shape[2])).sum(-1)
        ny = ((ys >= 0) & (ys < f2.shape[1])).sum(-1)
        neighbours += int((nx * ny).sum())
    outputs = h * w * len(pyramid) * win * win
    flops = 2 * c * neighbours + 8 * outputs
    nbytes = 4 * (f1.numel() + sum(f.numel() for f in pyramid)
                  + coords.numel() + outputs)
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


def serve_pairs(torch, predictor, padder, frames, counters):
    """Serve ``frames`` (after the first, a warm-up) through ``predictor``,
    with every launch counter set to 0 just before. Returns (ms per pair,
    {kernel: launches})."""
    predictor(*frames[0])
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    times = []
    for im1, im2 in frames[1:]:
        t0 = time.perf_counter()
        _, flow_up = predictor(im1, im2)
        times.append(1e3 * (time.perf_counter() - t0))
        flow = padder.unpad(flow_up)
        if flow.shape != (*SINTEL_HW, 2) or not np.isfinite(flow).all():
            fail(f"Sintel flow has shape {flow.shape} or non-finite values")
    return times, {name: mod.launches for name, mod in counters.items()}


def check_launches(launches, pairs, want_per_pair):
    for name, n in launches.items():
        print(f"  {name}: {n} launches ({n / pairs:g} per pair)")
        if n != want_per_pair[name] * pairs:
            fail(f"{name} launched {n} times, expected "
                 f"{want_per_pair[name] * pairs}")


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
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    busy_ms = sum(t for t, _ in by_name.values())
    if not busy_ms:
        print("profile: the profiler recorded no device time (not measured)")
        return
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
    print(f"profile: one Sintel pair, device busy {busy_ms:.2f} ms of "
          f"{wall_ms:.2f} ms wall under the profiler "
          f"({100 * busy_ms / wall_ms:.1f}%), {len(by_name)} kernel names")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        print(f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% {n:5d}x  "
              f"{name[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, REPO)
    from raft_tpu_torch.evaluate import (ASSETS_DIR, load_predictor,
                                         use_float32_math, validate_golden)
    from raft_tpu_torch.models import corr
    from raft_tpu_torch.ops import (build, corr_cuda, gru_cuda, motion_cuda,
                                    sampling, step_cuda)
    from raft_tpu_torch.utils.padder import InputPadder

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
    err = {"corr_fwd": 0.0, "sepconv_gru": 0.0, "motion_fwd": 0.0,
           "update_step": 0.0}
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
    counters = {"corr_fwd": corr_cuda, "update_step": step_cuda,
                "motion_fwd": motion_cuda, "sepconv_gru": gru_cuda}
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
                   {"corr_fwd": SINTEL_ITERS, "update_step": SINTEL_ITERS,
                    "motion_fwd": 0, "sepconv_gru": 0})
    chain = load_predictor(weights, iters=SINTEL_ITERS, update_impl="chain")
    chain_times, chain_launches = serve_pairs(
        torch, chain, padder, frames[:CHAIN_PAIRS + 1], counters)
    print(f"serve [chain]: {CHAIN_PAIRS} Sintel pairs, iters={SINTEL_ITERS}, "
          f"B=1: median {statistics.median(chain_times):.2f} ms/pair "
          f"(all {', '.join(f'{t:.2f}' for t in chain_times)})")
    check_launches(chain_launches, CHAIN_PAIRS,
                   {"corr_fwd": SINTEL_ITERS, "update_step": 0,
                    "motion_fwd": SINTEL_ITERS, "sepconv_gru": SINTEL_ITERS})
    # each kernel's launches on the path that runs it
    path_of = {"corr_fwd": ("step", launches, SERVE_PAIRS),
               "update_step": ("step", launches, SERVE_PAIRS),
               "motion_fwd": ("chain", chain_launches, CHAIN_PAIRS),
               "sepconv_gru": ("chain", chain_launches, CHAIN_PAIRS)}

    # -- kernel times at the Sintel shape ----------------------------------
    kernels = []

    def entry(name, source, replaces, ms, plain_ms, work, library_ms,
              **extra):
        path, counts, pairs = path_of[name]
        bound_ms, bound_by = bound(*work)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path, "launches": counts[name],
            "launches_per_pair": counts[name] / pairs,
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra})

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
              corr_work(torch, f1, pyr, coords, radius), None)

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
    for k in kernels:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        print(f"{k['name']}: {k['ms']:.4f} ms a launch, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}), plain "
              f"{k['plain_ms']:.4f} ms, library {lib}")
    mg = kernels[-1]
    print(f"update_step 'mg': {mg['ms_mg']:.4f} ms a launch, bound "
          f"{mg['bound_ms_mg']:.4f} ms, plain {mg['plain_ms_mg']:.4f} ms, "
          f"library {mg['library_ms_mg']:.4f} ms")
    profile_pair(torch, serve, *frames[1])
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
