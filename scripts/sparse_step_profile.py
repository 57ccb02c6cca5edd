#!/usr/bin/env python3
"""SparseRAFT at ``encoder_iterations=2`` (OursConfig widths, B=4,
352x480, random weights from a seed) on one CUDA card: the wall time of
forwards and train steps, and one of each profiled by kernel name.

It times 10 forwards through ``load_predictor(...).predict_batch`` after
one warm-up, and 6 train steps through ``train()`` after 2 (chip_smoke's
``sparse_train_full_size``), then profiles one forward and one train step
with chip_smoke's ``profile_by_name``: device busy share of the profiled
wall, device time, launches, and the time of the corr and MSDA kernels and
of each category of kernels. It runs the package of the tree it lies in;
to compare two commits, copy it into the other tree's ``scripts/`` and run
both copies in one call, interleaved.

Run from the repository root:

    python3 scripts/sparse_step_profile.py
"""

import importlib.util
import os
import statistics
import sys
import time
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORWARDS = 10
WARMUP_STEPS, TIMED_STEPS = 2, 6


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sparse_step_profile: no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "sparse_profile_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, REPO)
    from raft_tpu_torch.config import OursConfig, TrainConfig
    from raft_tpu_torch.evaluate import load_predictor
    from raft_tpu_torch.models.ours import SparseRAFT
    from raft_tpu_torch.parallel.train_step import make_train_step
    from raft_tpu_torch.train import train

    print(smoke.card_line())
    label, batch, enc = smoke.SPARSE_RUNS[1]
    cfg = OursConfig(encoder_iterations=enc)
    pred = load_predictor("random", model_family="sparse", config=cfg, seed=1)
    frames = smoke.sparse_frames(batch, seed=3)
    pred.predict_batch(*frames)
    times = []
    for _ in range(FORWARDS):
        t0 = time.perf_counter()
        pred.predict_batch(*frames)  # returns numpy: waits for the card
        times.append(1e3 * (time.perf_counter() - t0))
    print(f"{REPO}: forward [{label}] B={batch}: median "
          f"{statistics.median(times):.2f} ms (all "
          f"{', '.join(f'{t:.2f}' for t in times)})")
    smoke.profile_by_name(torch, lambda: pred.predict_batch(*frames),
                          "forward profile", f"one forward [{label}]")

    pkg = SimpleNamespace(TrainConfig=TrainConfig, OursConfig=OursConfig,
                          SparseRAFT=SparseRAFT, train=train, counters={})
    state, tcfg, ms = smoke.sparse_train_full_size(
        torch, pkg, label, batch, enc, WARMUP_STEPS, TIMED_STEPS)[:3]
    print(f"{REPO}: train step [{label}] B={batch}: median "
          f"{statistics.median(ms):.2f} ms (all "
          f"{', '.join(f'{t:.2f}' for t in ms)})")
    step = make_train_step(tcfg)
    sbatch = smoke.synthetic_batch(torch, batch, smoke.SPARSE_HW,
                                   torch.Generator(device="cuda").manual_seed(8))
    smoke.profile_by_name(torch, lambda: step(state, sbatch),
                          "train step profile", f"one train step [{label}]")
    print(smoke.card_line())


if __name__ == "__main__":
    main()
