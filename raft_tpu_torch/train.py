"""The training loop, the counterpart of ``raft_tpu/train.py``'s ``train``
and ``resolve_train_corr_engine``.

It trains canonical RAFT-large (``model_family="raft"``, a ``RAFTConfig``)
or the sparse-keypoint family's ``SparseRAFT`` (``model_family="sparse"``,
an ``OursConfig``) on batches from an injected
``dataloader``: any iterable of ``{"image1", "image2", "flow", "valid"}``
batches, NHWC, as numpy arrays or tensors (``image*`` (B, H, W, 3) in [0,
255], ``flow`` (B, H, W, 2), ``valid`` (B, H, W)). It is iterated again
from the start until ``tcfg.num_steps`` steps are done. It runs on the
CUDA card unless the caller passes ``device="cpu"``, and raises when there
is neither.

RAFT-large trains in float32 or under the bf16 mixed-precision policy
(``RAFTConfig(mixed_precision=True)``, and the explicit levers
``corr_mxu_dtype="bfloat16"`` and ``corr_dtype="bfloat16"``), on either
``update_impl``, as in the JAX package: bfloat16 encoders and update block
on float32 parameters, float32 flow arithmetic and loss, float32 master
parameters, AdamW in float32 and no loss scaling.

Not ported yet, each refused with ``NotImplementedError`` when asked for:
RAFT-small (``RAFTConfig(small=True)``, in float32 or bf16), the sparse
family's bf16, the data pipeline and the ``--stage`` CLI
(``dataloader=None``),
checkpoints and resume, the preemption guard, the logger's files and
TensorBoard (``log_dir``), validation in the loop, spatial sharding and the
other model families (``keypoint_transformer``, ``dual_query``,
``two_stage``, ``full_transformer``).

    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.train import train
    state = train(TrainConfig(num_steps=100), RAFTConfig(),
                  dataloader=my_batches,
                  restore_ckpt="assets/golden/weights.npz")
    state = train(TrainConfig(model_family="sparse", sparse_lambda=0.1,
                              image_size=(352, 480)), OursConfig(),
                  dataloader=my_batches)
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from raft_tpu_torch.config import OursConfig, RAFTConfig, TrainConfig
from raft_tpu_torch.evaluate import resolve_device, use_float32_math
from raft_tpu_torch.models.ours import SparseRAFT
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.models.update import UPDATE_IMPLS
from raft_tpu_torch.parallel.train_step import (TrainState,
                                                create_train_state,
                                                make_train_step)
from raft_tpu_torch.weights import load_npz


class TrainingDiverged(RuntimeError):
    """``tcfg.max_consecutive_skips`` steps in a row were non-finite."""


def resolve_train_corr_engine(device: torch.device, corr_impl: str,
                              mcfg: RAFTConfig) -> bool:
    """Whether training runs the on-demand correlation. ``alternate_corr``
    in the config always wins. ``corr_impl="auto"`` picks the on-demand
    kernels on the card and the materialised pyramid on the CPU, where the
    plain on-demand lookup would keep every window's samples for the
    backward (the JAX ``auto`` likewise keeps the volume off the TPU);
    ``corr_dtype="bfloat16``, a lever of the materialised pyramid, pins
    that engine. ``"fixed"`` takes the config as it is."""
    if corr_impl not in ("auto", "fixed"):
        raise ValueError(f"corr_impl must be 'auto' or 'fixed', "
                         f"got {corr_impl!r}")
    if mcfg.alternate_corr:
        return True
    if corr_impl == "fixed" or mcfg.corr_dtype == "bfloat16":
        return False
    return device.type == "cuda"


def _to_device(batch, device: torch.device) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device=device, dtype=torch.float32)
            for k, v in batch.items()}


def _refuse(**unported) -> None:
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported to "
                                      f"raft_tpu_torch yet (ROADMAP.md)")


def build_model(model_family: str, mcfg: Union[RAFTConfig, OursConfig]):
    """The model of ``model_family`` from its config (the counterpart of
    ``raft_tpu/train.py``'s ``build_model``): ``RAFT`` from a
    ``RAFTConfig``, ``SparseRAFT`` from an ``OursConfig``, whose
    ``alternate_corr`` picks the correlation engine (the JAX package reads
    an environment variable for it; the port has no such knob). Raises
    ``TypeError`` on a config of the other family, ``NotImplementedError``
    on a family not ported yet."""
    want = {"raft": RAFTConfig, "sparse": OursConfig}.get(model_family)
    if want is None:
        raise NotImplementedError(f"model_family={model_family!r} is not "
                                  f"ported to raft_tpu_torch yet "
                                  f"(ROADMAP.md)")
    if type(mcfg) is not want:
        raise TypeError(f"model_family={model_family!r} takes a "
                        f"{want.__name__}, got {type(mcfg).__name__}")
    return RAFT(mcfg) if model_family == "raft" else SparseRAFT(mcfg)


def train(tcfg: TrainConfig,
          mcfg: Union[RAFTConfig, OursConfig] = RAFTConfig(), *,
          dataloader=None, restore_ckpt: Optional[str] = None,
          device=None, corr_impl: str = "auto", update_impl: str = "step",
          logger=None, resume: bool = False,
          validation: Sequence[str] = (), ckpt_dir: Optional[str] = None,
          log_dir: Optional[str] = None,
          spatial_shards: int = 1) -> TrainState:
    """Run one training stage on ``dataloader``; returns the final state.

    ``mcfg`` is the model's config: a ``RAFTConfig`` for
    ``tcfg.model_family="raft"``, an ``OursConfig`` for ``"sparse"``
    (``build_model``; a ``SparseRAFT`` starts from the random weights of
    its ``init_weights`` seeded from ``tcfg.seed``). ``corr_impl`` and
    ``update_impl`` are RAFT's levers; the sparse family refuses any but
    their defaults. ``restore_ckpt``: a ``.npz`` archive with torch
    state-dict names (such as ``assets/golden/weights.npz``, or one written
    by ``weights.state_dict_to_npz``), parameters and batch-norm buffers.
    Batch norm trains on the chairs stage and is frozen on the others, as
    in the reference. ``logger``, if given, is called as
    ``logger.push(metrics, lr=...)`` after every step, the interface of
    ``raft_tpu.utils.logger.TrainLogger``. After
    ``tcfg.max_consecutive_skips`` non-finite steps in a row it raises
    ``TrainingDiverged``.
    """
    _refuse(**{
        "the data pipeline (pass dataloader=)": dataloader is None,
        "resume": resume, "validation in the loop": bool(validation),
        "checkpointing (ckpt_dir)": ckpt_dir is not None,
        "async checkpointing": tcfg.async_checkpointing,
        "the training logger (log_dir)": log_dir is not None,
        "spatial sharding": spatial_shards != 1,
        "RAFT-small training": getattr(mcfg, "small", False)})
    if update_impl not in UPDATE_IMPLS:
        raise ValueError(f"update_impl must be one of {UPDATE_IMPLS}, "
                         f"got {update_impl!r}")
    model = build_model(tcfg.model_family, mcfg)
    sparse = tcfg.model_family == "sparse"
    if sparse and (corr_impl != "auto" or update_impl != "step"):
        raise ValueError("corr_impl and update_impl are canonical RAFT's "
                         "levers; the sparse family's correlation engine is "
                         "OursConfig.alternate_corr")
    device = resolve_device(device)
    if device.type == "cuda":
        use_float32_math()
    torch.manual_seed(tcfg.seed)

    if sparse:
        model.init_weights(torch.Generator().manual_seed(tcfg.seed))
    if restore_ckpt:
        model.load_state_dict(load_npz(restore_ckpt))
    model.to(device)
    state = create_train_state(model, tcfg)
    step_fn = make_train_step(
        tcfg, freeze_bn=tcfg.stage != "chairs",
        alternate_corr=None if sparse else resolve_train_corr_engine(
            device, corr_impl, mcfg),
        update_impl=update_impl)

    consecutive_skips = 0
    while state.step < tcfg.num_steps:
        seen = 0
        for batch in dataloader:
            lr = state.scheduler.get_last_lr()[0]
            metrics = step_fn(state, _to_device(batch, device))
            seen += 1
            if logger is not None:
                logger.push(metrics, lr=lr)
            consecutive_skips = (consecutive_skips + 1
                                 if metrics["skipped_steps"] else 0)
            if (tcfg.max_consecutive_skips
                    and consecutive_skips >= tcfg.max_consecutive_skips):
                raise TrainingDiverged(
                    f"{consecutive_skips} consecutive non-finite steps at "
                    f"step {state.step}")
            if state.step >= tcfg.num_steps:
                break
        if not seen:
            raise ValueError("the dataloader yielded no batch")
    return state
