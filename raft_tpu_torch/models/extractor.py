"""Feature and context encoders of canonical RAFT, the counterpart of
``raft_tpu/models/extractor.py`` (``Norm``, ``ResidualBlock``,
``BasicEncoder`` of RAFT-large; ``BottleneckBlock``, ``SmallEncoder`` of
RAFT-small); the sparse family's encoders reuse the residual block with
GELU (``models/sparse_extractor.py``).

Attribute names follow the torch state-dict keys of the reference weights
(``conv1``, ``norm1``, ``layer1.0`` ...; the stride-2 shortcut is registered
both as ``downsample`` = Sequential(conv, norm) and as ``norm3``, or
``norm4`` in the bottleneck block), so ``load_state_dict`` takes those
weights with no renaming. Inside, tensors
are NCHW; ``BasicEncoder`` takes and returns NHWC like its counterpart.

Like the flax modules, every ``forward`` takes a ``train`` flag, which
selects batch statistics in the batch norms (``BatchNorm``); the module's
``training`` attribute plays no part.

The encoders compute in the dtype of their input, as flax's do in their
``dtype``: a bfloat16 image (the mixed-precision policy) runs every
convolution in bfloat16 on weights cast from the float32 parameters
(``conv``; in training the cast is in the autograd graph), and every norm
takes its statistics and normalises in float32 and returns bfloat16,
flax's ``_compute_stats``/``_normalize``; batch norm's running statistics
stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def cached_weights(module: nn.Module, make, slot: str):
    """``make(module)``, kept on the module under ``slot`` and remade only
    when a parameter was replaced or written since the last call (a new
    state dict, an optimizer step, a move to another device)."""
    key = tuple((p.data_ptr(), p._version) for p in module.parameters())
    cached = getattr(module, slot, None)
    if cached is None or cached[0] != key:
        cached = (key, make(module))
        setattr(module, slot, cached)
    return cached[1]


def conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` on ``x`` in ``x``'s dtype: a float32 input runs the module
    as it is; a bfloat16 one runs as flax's ``Conv`` at ``dtype=bfloat16``
    over float32 parameters: the convolution of bfloat16 operands (float32
    sums) rounded to bfloat16, then the bfloat16 bias added in bfloat16. A
    bias fused into the convolution would be added before the rounding and
    move many outputs by one ulp. Where autograd wants a gradient of the
    parameters (training), the bfloat16 weight and bias are cast in the
    graph, so that the gradients reach the float32 parameters, as flax's
    do through its cast; elsewhere (inference) they are cast once and
    cached on the layer (``cached_weights``), detached."""
    if x.dtype == layer.weight.dtype:
        return layer(x)
    if torch.is_grad_enabled() and (layer.weight.requires_grad
                                    or layer.bias.requires_grad):
        weight, bias = layer.weight.to(x.dtype), layer.bias.to(x.dtype)
    else:
        weight, bias = cached_weights(
            layer, lambda m: (m.weight.detach().to(x.dtype),
                              m.bias.detach().to(x.dtype)),
            f"_cast_{x.dtype}")
    y = F.conv2d(x, weight, None, layer.stride, layer.padding)
    return y + bias[:, None, None]


class BatchNorm(nn.BatchNorm2d):
    """Batch norm with flax's semantics (``raft_tpu/models/extractor.py``
    ``Norm``). ``train=False`` normalises with the running statistics.
    ``train=True`` normalises with the batch mean and *biased* variance
    and moves the running statistics 0.1 of the way towards them (flax's
    momentum 0.9), the variance too taken biased. ``nn.BatchNorm2d`` in
    training mode would update ``running_var`` with the unbiased variance,
    N/(N-1) larger. ``num_batches_tracked`` counts the updates."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.dtype != torch.float32:
            return self.forward(x.float(), train).to(x.dtype)
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
        return super().forward(x.float()).to(x.dtype)


class NoNorm(nn.Module):
    """The identity, RAFT-small's context encoder's norm (no parameters)."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return x


def make_norm(norm_fn: str, planes: int) -> nn.Module:
    """The norms of canonical RAFT: batch (RAFT-large's ``cnet``), instance
    without affine parameters (both ``fnet``s), eps 1e-5, and "none"
    (RAFT-small's ``cnet``)."""
    if norm_fn == "batch":
        return BatchNorm(planes, eps=1e-5, momentum=0.1)
    if norm_fn == "instance":
        return InstanceNorm(planes, eps=1e-5, affine=False)
    if norm_fn == "none":
        return NoNorm()
    raise ValueError(f"unknown norm_fn {norm_fn!r}")


def _refuse_dropout(dropout: float) -> None:
    if dropout > 0:
        # JAX: nn.Dropout(broadcast_dims=(1, 2)) after conv2.
        raise NotImplementedError("encoder dropout is not ported yet")


def _encode(encoder: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    """Stem, the three stages and the 1x1 projection of ``encoder``: NHWC
    in and out, NCHW inside."""
    x = x.permute(0, 3, 1, 2).contiguous()
    x = encoder.relu1(encoder.norm1(conv(encoder.conv1, x), train))
    for block in (*encoder.layer1, *encoder.layer2, *encoder.layer3):
        x = block(x, train)
    return conv(encoder.conv2, x).permute(0, 2, 3, 1).contiguous()


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
        y = self.act(self.norm1(conv(self.conv1, x), train))
        y = self.act(self.norm2(conv(self.conv2, y), train))
        if self.downsample is not None:
            x = self.norm3(conv(self.downsample[0], x), train)
        return self.act(x + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 to ``planes``, each with norm and ReLU,
    plus a 1x1 strided shortcut when stride > 1 (RAFT-small's encoders)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes // 4, 1)
        self.conv2 = nn.Conv2d(planes // 4, planes // 4, 3, stride=stride,
                               padding=1)
        self.conv3 = nn.Conv2d(planes // 4, planes, 1)
        self.relu = nn.ReLU(inplace=True)
        self.norm1 = make_norm(norm_fn, planes // 4)
        self.norm2 = make_norm(norm_fn, planes // 4)
        self.norm3 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm4 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm4)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.relu(self.norm1(conv(self.conv1, x), train))
        y = self.relu(self.norm2(conv(self.conv2, y), train))
        y = self.relu(self.norm3(conv(self.conv3, y), train))
        if self.downsample is not None:
            x = self.norm4(conv(self.downsample[0], x), train)
        return self.relu(x + y)


class BasicEncoder(nn.Module):
    """Stride-8 encoder: 7x7 stem, stages of 64, 96 and 128 channels, then a
    1x1 projection to ``output_dim``."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "batch",
                 dropout: float = 0.0):
        super().__init__()
        _refuse_dropout(dropout)
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
        return _encode(self, x, train)


class SmallEncoder(nn.Module):
    """RAFT-small's stride-8 encoder: 7x7 stem to 32 channels, bottleneck
    stages of 32, 64 and 96, then a 1x1 projection to ``output_dim``."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dropout: float = 0.0):
        super().__init__()
        _refuse_dropout(dropout)
        self.conv1 = nn.Conv2d(3, 32, 7, stride=2, padding=3)
        self.norm1 = make_norm(norm_fn, 32)
        self.relu1 = nn.ReLU(inplace=True)
        self.layer1 = nn.Sequential(BottleneckBlock(32, 32, norm_fn, 1),
                                    BottleneckBlock(32, 32, norm_fn, 1))
        self.layer2 = nn.Sequential(BottleneckBlock(32, 64, norm_fn, 2),
                                    BottleneckBlock(64, 64, norm_fn, 1))
        self.layer3 = nn.Sequential(BottleneckBlock(64, 96, norm_fn, 2),
                                    BottleneckBlock(96, 96, norm_fn, 1))
        self.conv2 = nn.Conv2d(96, output_dim, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``x`` (B, H, W, 3) -> (B, H/8, W/8, output_dim), both NHWC."""
        return _encode(self, x, train)
