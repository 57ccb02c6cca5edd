"""Feature and context encoders of canonical RAFT-large, the counterpart of
``raft_tpu/models/extractor.py`` (``Norm``, ``ResidualBlock``,
``BasicEncoder``); the sparse family's encoders reuse the block with GELU
(``models/sparse_extractor.py``).

Attribute names follow the torch state-dict keys of the reference weights
(``conv1``, ``norm1``, ``layer1.0`` ...; the stride-2 shortcut is registered
both as ``downsample`` = Sequential(conv, norm) and as ``norm3``), so
``load_state_dict`` takes those weights with no renaming. Inside, tensors
are NCHW; ``BasicEncoder`` takes and returns NHWC like its counterpart.

Like the flax modules, every ``forward`` takes a ``train`` flag, which
selects batch statistics in the batch norms (``BatchNorm``); the module's
``training`` attribute plays no part.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.BatchNorm2d):
    """Batch norm with flax's semantics (``raft_tpu/models/extractor.py``
    ``Norm``). ``train=False`` normalises with the running statistics.
    ``train=True`` normalises with the batch mean and *biased* variance
    and moves the running statistics 0.1 of the way towards them (flax's
    momentum 0.9), the variance too taken biased. ``nn.BatchNorm2d`` in
    training mode would update ``running_var`` with the unbiased variance,
    N/(N-1) larger. ``num_batches_tracked`` counts the updates."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * scale[:, None, None]
                + self.bias[:, None, None])


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class InstanceNorm(nn.InstanceNorm2d):
    """Instance norm without affine parameters: the same in training."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return super().forward(x)


def make_norm(norm_fn: str, planes: int) -> nn.Module:
    """The norms of RAFT-large: batch (``cnet``) and instance without
    affine parameters (``fnet``), eps 1e-5."""
    if norm_fn == "batch":
        return BatchNorm(planes, eps=1e-5, momentum=0.1)
    if norm_fn == "instance":
        return InstanceNorm(planes, eps=1e-5, affine=False)
    raise ValueError(f"unknown norm_fn {norm_fn!r}")


class ResidualBlock(nn.Module):
    """Two 3x3 convs with norm and activation, plus a 1x1 strided shortcut
    when stride > 1. ``act`` is "relu" (RAFT) or "gelu" (the sparse
    family's encoders: flax's ``nn.gelu``, the tanh approximation)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1, act: str = "relu"):
        super().__init__()
        if act not in ("relu", "gelu"):
            raise ValueError(f"unknown act {act!r}")
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.act = nn.ReLU(inplace=True) if act == "relu" else gelu
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.act(self.norm1(self.conv1(x), train))
        y = self.act(self.norm2(self.conv2(y), train))
        if self.downsample is not None:
            x = self.norm3(self.downsample[0](x), train)
        return self.act(x + y)


class BasicEncoder(nn.Module):
    """Stride-8 encoder: 7x7 stem, stages of 64, 96 and 128 channels, then a
    1x1 projection to ``output_dim``."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "batch",
                 dropout: float = 0.0):
        super().__init__()
        if dropout > 0:
            # JAX: nn.Dropout(broadcast_dims=(1, 2)) after conv2.
            raise NotImplementedError("encoder dropout is not ported yet")
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = make_norm(norm_fn, 64)
        self.relu1 = nn.ReLU(inplace=True)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm_fn, 1),
                                    ResidualBlock(64, 64, norm_fn, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm_fn, 2),
                                    ResidualBlock(96, 96, norm_fn, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm_fn, 2),
                                    ResidualBlock(128, 128, norm_fn, 1))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``x`` (B, H, W, 3) -> (B, H/8, W/8, output_dim), both NHWC;
        ``train`` normalises with batch statistics and updates the running
        ones (batch norm only)."""
        x = x.permute(0, 3, 1, 2).contiguous()
        x = self.relu1(self.norm1(self.conv1(x), train))
        for block in (*self.layer1, *self.layer2, *self.layer3):
            x = block(x, train)
        return self.conv2(x).permute(0, 2, 3, 1).contiguous()
