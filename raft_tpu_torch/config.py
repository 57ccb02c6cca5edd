"""Model and training configuration, the counterpart of
``raft_tpu/config.py``'s ``RAFTConfig`` and ``TrainConfig``: the same
fields, defaults and validation, with dtype levers kept as strings (no
framework dtypes)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """Canonical RAFT hyperparameters: the large model uses hidden/context
    dims 128/128, 4 correlation levels, radius 4; the small model 96/64, 4
    levels, radius 3."""

    small: bool = False
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    feature_dim: int = 256          # fnet output channels
    dropout: float = 0.0
    alternate_corr: bool = False    # on-demand (kernel) correlation lookup
    corr_scale: bool = True         # divide correlations by sqrt(C)
    normalized_coords: bool = False
    mixed_precision: bool = False
    corr_dtype: str = "auto"        # auto | float32 | bfloat16
    corr_mxu_dtype: str = "auto"    # auto | float32 | bfloat16
    iters: int = 12

    def __post_init__(self):
        if self.corr_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(
                f"corr_dtype must be 'auto', 'float32' or 'bfloat16', "
                f"got {self.corr_dtype!r}")
        if self.corr_mxu_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(
                f"corr_mxu_dtype must be 'auto', 'float32' or 'bfloat16', "
                f"got {self.corr_mxu_dtype!r}")
        if self.alternate_corr and self.corr_dtype == "bfloat16":
            raise ValueError(
                "corr_dtype='bfloat16' has no effect with alternate_corr "
                "(the on-demand path stores no correlation pyramid)")
        if not self.alternate_corr and self.corr_mxu_dtype == "bfloat16":
            raise ValueError(
                "corr_mxu_dtype='bfloat16' has no effect without "
                "alternate_corr (the materialized path controls volume "
                "precision via corr_dtype)")

    @property
    def fnet_dim(self) -> int:
        return 128 if self.small else self.feature_dim

    @property
    def hdim(self) -> int:
        return 96 if self.small else self.hidden_dim

    @property
    def cdim(self) -> int:
        return 64 if self.small else self.context_dim

    @property
    def radius(self) -> int:
        return 3 if self.small else self.corr_radius


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference ``train.py:431-452`` flags): the
    chairs-stage defaults, batch 8 at 368x496, 12 iterations, AdamW at 4e-4
    with a one-cycle schedule, weight decay 1e-4, clipping at global norm
    1.0 and loss decay 0.8. Fields of ``raft_tpu.config.TrainConfig`` that
    belong to parts not ported yet (checkpointing, the sparse family) are
    kept so that configs carry over; ``train.train`` refuses the values it
    cannot honour."""

    name: str = "raft"
    stage: str = "chairs"
    model_family: str = "raft"
    lr: float = 4e-4
    num_steps: int = 100000
    batch_size: int = 8
    image_size: Tuple[int, int] = (368, 496)
    wdecay: float = 1e-4
    epsilon: float = 1e-8
    clip: float = 1.0
    gamma: float = 0.8              # loss decay weight
    # "all": the reference's mean over all pixels with invalid ones zeroed;
    # "valid": divide by the valid-pixel count instead.
    loss_normalization: str = "all"
    add_noise: bool = False
    iters: int = 12
    val_freq: int = 5000
    sum_freq: int = 100
    scheduler: str = "onecycle"     # onecycle | step | cosine_warmup
    seed: int = 2022
    sparse_lambda: float = 0.0
    sparse_lambda_steps: int = 20000
    # Non-finite step guard: after this many consecutive skipped steps the
    # run stops (0: never).
    max_consecutive_skips: int = 20
    async_checkpointing: bool = False
