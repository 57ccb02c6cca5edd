"""The multi-scale CNN encoders of the sparse-keypoint family, the
counterpart of ``raft_tpu/models/sparse_extractor.py``.

A GELU residual trunk (7x7/2 stem, then five stages of two
``ResidualBlock``s at channels (c, 1.5c, 2c, 3c, 4c) and strides
(1, 2, 2, 2, 2)) gives per-image pyramids at strides 4, 8, 16 and 32;
``CNNDecoder`` adds one FPN top-down merge, the stride-4 context map ``U1``
of the first image. Both take the two images concatenated on the batch axis,
NHWC, and return NHWC.

The JAX package keeps a quirk of the reference and so does the port: the
second image's pyramid starts with the *first* image's stride-4 level
(``_split_pyramids``). The model drops that level.
"""

from __future__ import annotations

import torch
from torch import nn

from raft_tpu_torch.models.extractor import ResidualBlock, gelu, make_norm
from raft_tpu_torch.ops.sampling import resize_linear


class _Trunk(nn.Module):
    """Stem and five down stages, shared by the encoder and the decoder."""

    def __init__(self, base_channel: int, norm_fn: str):
        super().__init__()
        c = base_channel
        dims = (c, round(c * 1.5), c * 2, round(c * 3), c * 4)
        self.conv1 = nn.Conv2d(3, c, 7, stride=2, padding=3)
        self.norm1 = make_norm(norm_fn, c)
        prev = c
        for i, (dim, stride) in enumerate(zip(dims, (1, 2, 2, 2, 2))):
            setattr(self, f"down_layer{i + 1}", nn.Sequential(
                ResidualBlock(prev, dim, norm_fn, stride, act="gelu"),
                ResidualBlock(dim, dim, norm_fn, 1, act="gelu")))
            prev = dim

    def forward(self, x: torch.Tensor, train: bool = False) -> list:
        """NCHW in; the five stages' outputs (strides 2 to 32), NCHW."""
        x = gelu(self.norm1(self.conv1(x), train))
        outs = []
        for i in range(1, 6):
            for block in getattr(self, f"down_layer{i}"):
                x = block(x, train)
            outs.append(x)
        return outs


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _split_pyramids(levels):
    """Twin-image batch split of NCHW levels into two NHWC pyramids,
    keeping the reference's quirk: the second pyramid's first level is the
    first image's."""
    halves = [lvl.chunk(2) for lvl in levels]
    x1 = tuple(_nhwc(a) for a, _ in halves)
    x2 = (x1[0],) + tuple(_nhwc(b) for _, b in halves[1:])
    return x1, x2


class CNNEncoder(nn.Module):
    """Downsampling-only pyramid encoder: both images (2B, H, W, 3) ->
    ``(X1, X2)``, 4-level pyramids (strides 4 to 32), NHWC."""

    def __init__(self, base_channel: int = 64, norm_fn: str = "instance"):
        super().__init__()
        self.trunk = _Trunk(base_channel, norm_fn)

    def forward(self, x: torch.Tensor, train: bool = False):
        outs = self.trunk(x.permute(0, 3, 1, 2).contiguous(), train)
        return _split_pyramids(outs[1:])


class CNNDecoder(nn.Module):
    """Pyramid encoder plus the FPN top-down context map: both images
    (2B, H, W, 3) -> ``(X1, X2, U1)``, where ``U1`` (B, H/4, W/4, 1.5c) is the
    first image's stride-4 context map."""

    def __init__(self, base_channel: int = 64, norm_fn: str = "batch"):
        super().__init__()
        c = base_channel
        up = round(c * 1.5)
        self.trunk = _Trunk(c, norm_fn)
        self.up_top1 = nn.Conv2d(c * 2, up, 1)
        self.up_top1_norm = make_norm(norm_fn, up)
        self.up_lateral1 = nn.Conv2d(round(c * 1.5), up, 1)
        self.up_lateral1_norm = make_norm(norm_fn, up)
        self.up_smooth1 = nn.Conv2d(up, up, 3, padding=1)
        self.up_smooth1_norm = make_norm(norm_fn, up)

    def forward(self, x: torch.Tensor, train: bool = False):
        outs = self.trunk(x.permute(0, 3, 1, 2).contiguous(), train)
        x1, x2 = _split_pyramids(outs[1:])
        d2_x1, d3_x1 = outs[1].chunk(2)[0], outs[2].chunk(2)[0]
        t1 = self.up_top1_norm(self.up_top1(d3_x1), train)
        l2 = self.up_lateral1_norm(self.up_lateral1(d2_x1), train)
        t1 = resize_linear(t1, t1.shape[:2] + l2.shape[2:])
        u1 = gelu(t1 + l2)
        u1 = gelu(self.up_smooth1_norm(self.up_smooth1(u1), train))
        return x1, x2, _nhwc(u1)
