#!/usr/bin/env python3
"""The bf16 plain convolutions in two forms, timed and compared in the mixed
chairs train step of RAFT-large on one CUDA card.

Under the bf16 policy the step kernel's backward recomputes through its
plain version, whose convolutions are ``conv_pack.conv2d`` on bfloat16
activations: cuDNN's bfloat16 convolution on the card ("bf16"). The
other form ("f32 of bf16") is a float32 convolution of the bfloat16 values
(TF32 off), rounded to bfloat16. Both multiply the same bfloat16 values
and sum in float32. This script trains RAFT-large
under the policy through ``train()`` at chip_smoke's chairs defaults
(B=8, 368x496, iters=12, 2 warm-up and 5 timed steps, the fixture weights,
the same batches) with each form in turns (f32 of bf16, bf16, bf16, f32 of
bf16) and prints ms per step; then it takes one B=2 train step (184x248,
iters=4) with each form from the same weights and prints, per parameter,
max|bf16 - f32 of bf16| / max|f32 of bf16| of the clipped gradients, the
worst first.

Run from the repository root:

    python3 scripts/recompute_conv_ab.py
"""

import contextlib
import importlib.util
import os
import statistics
import sys
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("recompute_conv_ab: no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "recompute_ab_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, REPO)
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.evaluate import use_float32_math
    from raft_tpu_torch.models.raft import RAFT
    from raft_tpu_torch.ops import gru_cuda, motion_cuda, step_cuda
    from raft_tpu_torch.parallel.train_step import (create_train_state,
                                                    make_train_step)
    from raft_tpu_torch.train import train
    from raft_tpu_torch.weights import load_npz

    print(smoke.card_line())
    use_float32_math()
    users = (gru_cuda, motion_cuda, step_cuda)   # each imported conv2d
    bf16_form = step_cuda.conv2d

    def f32_form(x, weight, bias, padding=0):
        if x.dtype == torch.float32:
            return F.conv2d(x, weight, bias, padding=padding)
        y = F.conv2d(x.float(), weight.to(x.dtype).float(), padding=padding)
        return y.to(x.dtype) + bias.to(x.dtype)[:, None, None]

    @contextlib.contextmanager
    def form(fn):
        for mod in users:
            mod.conv2d = fn
        try:
            yield
        finally:
            for mod in users:
                mod.conv2d = bf16_form

    weights = os.path.join(REPO, "assets", "golden", "weights.npz")
    pkg = SimpleNamespace(RAFTConfig=RAFTConfig, TrainConfig=TrainConfig,
                          train=train, counters={}, load_npz=load_npz,
                          motion_cuda=motion_cuda, gru_cuda=gru_cuda)
    times = {"f32 of bf16": [], "bf16": []}
    for name in ("f32 of bf16", "bf16", "bf16", "f32 of bf16"):
        with form(f32_form if name == "f32 of bf16" else bf16_form):
            ms = smoke.train_full_size(torch, pkg, weights,
                                       RAFTConfig(mixed_precision=True),
                                       name)[2]
        times[name].append(statistics.median(ms))
        print(f"{name}: median {times[name][-1]:.2f} ms/step (all "
              f"{', '.join(f'{t:.2f}' for t in ms)})")
    for name, t in times.items():
        print(f"{name}: {', '.join(f'{v:.2f}' for v in t)} ms/step")

    tcfg = TrainConfig(batch_size=smoke.CMP_B, image_size=smoke.CMP_HW,
                       iters=smoke.CMP_ITERS, num_steps=100)
    batch = smoke.synthetic_batch(
        torch, smoke.CMP_B, smoke.CMP_HW,
        torch.Generator(device="cuda").manual_seed(1))
    grads = {}
    for name, fn in (("f32 of bf16", f32_form), ("bf16", bf16_form)):
        model = RAFT(RAFTConfig(mixed_precision=True, alternate_corr=True))
        model.load_state_dict(load_npz(weights))
        state = create_train_state(model.to("cuda"), tcfg)
        with form(fn):
            metrics = make_train_step(tcfg, alternate_corr=True)(state,
                                                                 batch)
        print(f"{name}: loss {metrics['loss']:.7g}, grad_norm "
              f"{metrics['grad_norm']:.7g}")
        grads[name] = {n: p.grad for n, p in model.named_parameters()}
    rel = sorted(((float((grads["bf16"][n] - g).abs().max()
                         / g.abs().max()), n)
                  for n, g in grads["f32 of bf16"].items()
                  if not smoke.cancelled_by_norm(n)), reverse=True)
    print("max|bf16 - f32 of bf16| / max|f32 of bf16| per parameter (the "
          "conv biases a norm cancels left out), worst 8: "
          + "; ".join(f"{n} {r:.3e}" for r, n in rel[:8]))
    print(smoke.card_line())


if __name__ == "__main__":
    main()
