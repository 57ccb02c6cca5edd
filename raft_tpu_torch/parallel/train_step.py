"""The train step, the counterpart of ``raft_tpu/parallel/train_step.py``
(``RAFTTrainState``, ``create_train_state``, ``make_train_step``) on one
device.

One step: optional noise augmentation, the training forward of the model
(``models.raft.RAFT``, every iteration upsampled; or the sparse family's
``models.ours.SparseRAFT``, one flow per outer iteration and its keypoint
predictions, with dropout), ``sequence_loss`` (plus, for the sparse family,
the gated ``sparse_keypoint_loss``), backward, the global gradient norm
(reported before clipping, as ``optax.global_norm(grads)``), the
non-finite guard, clipping, AdamW and the schedule. Unlike the JAX step,
which returns a new state, this one updates the state in place: the
model's parameters and batch-norm buffers, the optimizer's moments and the
scheduler's count.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.profiler import record_function

from raft_tpu_torch.config import TrainConfig
from raft_tpu_torch.losses import sequence_loss, sparse_keypoint_loss
from raft_tpu_torch.optim import clip_by_global_norm, fetch_optimizer

METRICS = ("loss", "epe", "1px", "3px", "5px")


@dataclasses.dataclass
class TrainState:
    """Carried training state: the step count (batches seen, skipped ones
    included), the model (parameters and batch-norm buffers), the optimizer
    and its scheduler, and the generator of the noise augmentation and of
    dropout."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator


def create_train_state(model: nn.Module, tcfg: TrainConfig) -> TrainState:
    """A state at step 0 around ``model`` (already on its device, with its
    weights): AdamW and its schedule from ``tcfg`` (``optim.fetch_optimizer``)
    and a generator on the model's device seeded from ``tcfg.seed``."""
    device = next(model.parameters()).device
    optimizer, scheduler = fetch_optimizer(tcfg, model.parameters())
    generator = torch.Generator(device=device).manual_seed(tcfg.seed)
    return TrainState(0, model, optimizer, scheduler, generator)


def add_noise(generator: torch.Generator, image1: torch.Tensor,
              image2: torch.Tensor):
    """Per-batch Gaussian noise (reference ``train.py:373-376``): a
    standard deviation drawn from U(0, 5), both images perturbed, then
    clamped to [0, 255]. ``torch.Generator`` and ``jax.random`` give other
    numbers from one seed; the distribution is the same."""
    dev = image1.device
    stdv = 5.0 * torch.rand((), generator=generator, device=dev)
    noisy = []
    for image in (image1, image2):
        noise = torch.randn(image.shape, generator=generator, device=dev)
        noisy.append(torch.clamp(image + stdv * noise, 0.0, 255.0))
    return tuple(noisy)


def make_train_step(tcfg: TrainConfig, freeze_bn: bool = False,
                    alternate_corr: Optional[bool] = None,
                    update_impl: str = "step"
                    ) -> Callable[[TrainState, Dict], Dict[str, float]]:
    """Build ``step_fn(state, batch) -> metrics`` for
    ``tcfg.model_family``: ``"raft"`` (``RAFT``) or ``"sparse"``
    (``SparseRAFT``).

    ``batch`` holds ``image1``/``image2`` (B, H, W, 3) float in [0, 255],
    ``flow`` (B, H, W, 2) and ``valid`` (B, H, W), on the model's device.
    ``freeze_bn`` keeps the batch norms (``cnet``'s, ``CNNDecoder``'s) on
    their running statistics (the reference's freeze after the chairs
    stage); ``alternate_corr`` and ``update_impl`` pick RAFT's correlation
    engine and refine-iteration kernels (``RAFT.forward``; the sparse
    family's engine is its config's ``alternate_corr``).

    The sparse family's loss (``raft_tpu/parallel/train_step.py``'s sparse
    branch): ``sequence_loss`` over the outer iterations' flows, plus, when
    ``tcfg.sparse_lambda > 0``, ``lam * sparse_keypoint_loss`` on the key
    flows scaled to pixels by (W - 1, H - 1), where ``lam`` is
    ``sparse_lambda`` while the step count before this step is under
    ``sparse_lambda_steps`` and 0 after; the metrics then add
    ``sparse_loss``. Dropout draws from the state's generator.

    The non-finite guard: a step whose loss or any gradient is non-finite
    applies no update: parameters, optimizer moments and scheduler count
    stay as they were, and the batch-norm running statistics that its
    forward already wrote are restored; it reports ``skipped_steps = 1``.
    The step count advances either way. The metrics are Python floats:
    ``loss``, ``epe``, ``1px``, ``3px``, ``5px``, ``grad_norm`` (before
    clipping) and ``skipped_steps``; reading them waits for the device.
    """
    if tcfg.model_family not in ("raft", "sparse"):
        raise ValueError(f"model_family must be 'raft' or 'sparse', got "
                         f"{tcfg.model_family!r}")
    sparse = tcfg.model_family == "sparse"
    keys = METRICS + (("sparse_loss",) if sparse and tcfg.sparse_lambda > 0
                      else ())

    def loss_fn(state: TrainState, image1, image2, batch):
        """The forward and the loss: (loss, metrics as tensors)."""
        if not sparse:
            preds = state.model(image1, image2, iters=tcfg.iters,
                                alternate_corr=alternate_corr,
                                update_impl=update_impl, train=True,
                                freeze_bn=freeze_bn)
            return sequence_loss(preds, batch["flow"], batch["valid"],
                                 gamma=tcfg.gamma,
                                 normalization=tcfg.loss_normalization)
        flow_preds, sparse_preds = state.model(
            image1, image2, iters=tcfg.iters, train=True,
            freeze_bn=freeze_bn, generator=state.generator)
        loss, metrics = sequence_loss(
            torch.stack(flow_preds), batch["flow"], batch["valid"],
            gamma=tcfg.gamma, normalization=tcfg.loss_normalization)
        if tcfg.sparse_lambda > 0:
            _, H, W, _ = batch["flow"].shape
            scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                                 device=loss.device)
            aux = sparse_keypoint_loss(
                [(p[0], p[1] * scale) for p in sparse_preds], batch["flow"],
                batch["valid"])
            lam = tcfg.sparse_lambda * (state.step < tcfg.sparse_lambda_steps)
            loss = loss + lam * aux
            metrics["sparse_loss"] = aux
            metrics["loss"] = loss
        return loss, metrics

    def step_fn(state: TrainState, batch: Dict) -> Dict[str, float]:
        model = state.model
        params = list(model.parameters())
        image1, image2 = batch["image1"], batch["image2"]
        if tcfg.add_noise:
            image1, image2 = add_noise(state.generator, image1, image2)
        buffers = list(model.buffers())
        saved = [b.clone() for b in buffers]

        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state, image1, image2, batch)
        loss.backward()

        with torch.no_grad(), record_function("train_step.guard_and_clip"):
            for p in params:
                if p.grad is None:      # optax updates every parameter
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            norm = torch.nn.utils.get_total_norm(grads)
            finite = torch.stack([torch.isfinite(loss)]
                                 + [torch.isfinite(g).all() for g in grads])
            host = torch.stack([finite.all().float(), norm]
                               + [metrics[k].detach() for k in keys]
                               ).tolist()
            ok = host[0] == 1.0
            if ok:
                clip_by_global_norm(grads, tcfg.clip, norm)
            else:
                for b, s in zip(buffers, saved):
                    b.copy_(s)
        if ok:
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        out = dict(zip(keys, host[2:]))
        out["grad_norm"] = host[1]
        out["skipped_steps"] = 0.0 if ok else 1.0
        return out

    return step_fn
