"""Optimizer and learning-rate schedules, the counterpart of
``raft_tpu/optim.py``.

The schedules are plain functions of the step count, returning the
learning rate; ``fetch_optimizer`` drives one through
``torch.optim.lr_scheduler.LambdaLR`` over an AdamW whose base rate is 1,
so the rate of update ``n`` (counting from 0) is ``schedule(n)``, as
optax's count gives it. Gradient clipping (``clip_by_global_norm``)
precedes the update, written to optax's formula.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from raft_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule: ``init`` to ``end`` over ``steps``, then
    ``end``."""
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def onecycle_schedule(lr: float, num_steps: int,
                      pct_start: float = 0.05) -> Schedule:
    """PyTorch OneCycleLR with linear annealing as original RAFT used it:
    ``lr / 25`` up to ``lr`` over the first ``pct_start`` of the steps,
    then down to ``lr / 25 / 1e4``."""
    warm = max(int(num_steps * pct_start), 1)

    def sched(count: int) -> float:
        if count < warm:
            return _linear(lr / 25.0, lr, warm, count)
        return _linear(lr, lr / 25.0 / 1e4, num_steps - warm, count - warm)
    return sched


def step_schedule(lr: float, num_steps: int, decay_point: float = 0.8,
                  gamma: float = 0.5) -> Schedule:
    """The fork's StepLR: multiply by ``gamma`` once at ``decay_point *
    num_steps``."""
    boundary = int(num_steps * decay_point)
    return lambda count: lr * gamma ** (count >= boundary)


def cosine_warmup_restarts_schedule(
        max_lr: float, first_cycle_steps: int, cycle_mult: float = 1.0,
        min_lr: float = 1e-7, warmup_steps: int = 0,
        gamma: float = 1.0) -> Schedule:
    """``CosineAnnealingWarmupRestarts`` (reference
    ``core/utils/scheduler.py``): linear warm-up, then a cosine decay per
    cycle; a cycle's length grows by ``cycle_mult`` and its peak by
    ``gamma`` at each restart."""
    # cycle_mult != 1: the first 63 cycle boundaries (or those below 1e7
    # steps), precomputed as the JAX package does.
    bounds = [0]
    length = first_cycle_steps
    while bounds[-1] < 10_000_000 and len(bounds) < 64:
        bounds.append(bounds[-1] + int(length))
        length *= cycle_mult

    def sched(count: int) -> float:
        if cycle_mult == 1.0:
            cycle, in_cycle = divmod(count, first_cycle_steps)
            clen = first_cycle_steps
        else:
            cycle = sum(count >= b for b in bounds[1:])
            last = min(cycle, len(bounds) - 2)
            in_cycle = count - bounds[last]
            clen = bounds[last + 1] - bounds[last]
        peak = max_lr * gamma ** cycle
        if in_cycle < warmup_steps:
            return ((peak - min_lr) * min(in_cycle / max(warmup_steps, 1), 1.0)
                    + min_lr)
        t = (in_cycle - warmup_steps) / max(clen - warmup_steps, 1)
        return min_lr + (peak - min_lr) * (
            1 + math.cos(math.pi * min(max(t, 0.0), 1.0))) / 2
    return sched


def make_schedule(cfg: TrainConfig) -> Schedule:
    if cfg.scheduler == "onecycle":
        # The reference pads num_steps by 100 (OneCycle total_steps).
        return onecycle_schedule(cfg.lr, cfg.num_steps + 100)
    if cfg.scheduler == "step":
        return step_schedule(cfg.lr, cfg.num_steps)
    if cfg.scheduler == "cosine_warmup":
        return cosine_warmup_restarts_schedule(
            cfg.lr, first_cycle_steps=cfg.num_steps,
            warmup_steps=max(cfg.num_steps // 20, 1))
    raise ValueError(f"unknown scheduler {cfg.scheduler!r}")


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place, given the gradients' global norm
    (``torch.nn.utils.get_total_norm``): each gradient becomes ``g / norm *
    max_norm`` when ``norm >= max_norm`` and stays as it is otherwise.
    ``torch.nn.utils.clip_grad_norm_`` differs: it scales by ``max_norm /
    (norm + 1e-6)``."""
    if float(norm) >= max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)


def fetch_optimizer(cfg: TrainConfig, params
                    ) -> Tuple[torch.optim.AdamW,
                               torch.optim.lr_scheduler.LambdaLR]:
    """AdamW (betas 0.9/0.999, ``cfg.epsilon``, decoupled weight decay
    ``cfg.wdecay`` on every parameter) and the scheduler that sets its rate
    to ``make_schedule(cfg)(n)`` for update ``n``. BatchNorm running
    statistics are buffers, which the optimizer never sees (the JAX package
    masks them out of the decay to the same end). Clip with
    ``clip_by_global_norm`` before ``optimizer.step()``, then call
    ``scheduler.step()``."""
    optimizer = torch.optim.AdamW(params, lr=1.0, betas=(0.9, 0.999),
                                  eps=cfg.epsilon, weight_decay=cfg.wdecay)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer,
                                                        make_schedule(cfg))
