"""Correlation volumes, the counterpart of ``raft_tpu/models/corr.py``.

* ``CorrBlock``: materialise the all-pairs volume with one matmul,
  average-pool it into a pyramid, answer each lookup with windowed bilinear
  sampling.
* ``AlternateCorrBlock``: pool the target *features* instead and recompute
  the windows around the current estimate on every lookup. On a CUDA
  tensor this is the kernel of ``ops/corr_cuda.py``; on the CPU its plain
  version.

Both give the same numbers up to float summation order. Window channel
``i*(2r+1)+j`` samples ``(x + i - r, y + j - r)``: the first window axis
moves x, as in the reference's delta grid, so reference weights read the
channels in the order they were trained on. Level l is sampled around
``coords / 2**l``; ``rescale=False`` samples every level around ``coords``,
the lookup the sparse family was trained with.

Mixed precision (``RAFTConfig.corr_storage``/``corr_mxu``): the all-pairs
volume and its pooling are always computed in float32 and only stored in
``storage``; the lookup reads the levels back as float32, and autograd
differentiates it in plain PyTorch. The on-demand lookup takes bfloat16
feature maps as they come, multiplies in ``mxu_dtype`` with float32 sums
and emits ``out_dtype``; in training its backward is the bf16 kernel on
the card.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.ops import corr_cuda
from raft_tpu_torch.ops.corr_cuda import windowed_correlation  # noqa: F401
from raft_tpu_torch.ops.sampling import avg_pool2x2, windowed_bilinear_matmul


def all_pairs_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor,
                          scale: bool = True) -> torch.Tensor:
    """(B, H, W, C) x (B, H, W, C) -> (B, H, W, H, W), in float32."""
    B, H, W, C = fmap1.shape
    a = fmap1.reshape(B, H * W, C).float()
    b = fmap2.reshape(B, H * W, C).float()
    corr = torch.bmm(a, b.transpose(1, 2))
    if scale:
        corr = corr / torch.sqrt(torch.tensor(float(C)))
    return corr.reshape(B, H, W, H, W)


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4, scale: bool = True,
                       storage: str = "float32") -> tuple:
    """All-pairs volume -> average-pooled pyramid, level l of shape
    (B*H*W, H/2^l, W/2^l), stored in ``storage`` ("float32" or
    "bfloat16"). Each level is pooled in float32 from the stored one
    before it, as in the JAX package."""
    B, H, W, _ = fmap1.shape
    dtype = getattr(torch, storage)
    corr = all_pairs_correlation(fmap1, fmap2, scale).reshape(B * H * W, H, W)
    pyramid = [corr.to(dtype)]
    for _ in range(num_levels - 1):
        pyramid.append(avg_pool2x2(pyramid[-1].float()).to(dtype))
    return tuple(pyramid)


def pyramid_lookup(pyramid, coords: torch.Tensor, radius: int,
                   rescale: bool = True) -> torch.Tensor:
    """Windowed bilinear lookup into a materialised pyramid; level l is
    sampled around ``coords / 2**l`` (``coords`` with ``rescale=False``).
    ``coords`` (B, H, W, 2). Returns (B, H, W, L*(2r+1)^2)."""
    B, H, W, _ = coords.shape
    flat = coords.reshape(B * H * W, 2)
    out = []
    for lvl, corr in enumerate(pyramid):
        centroid = flat / (2 ** lvl) if rescale else flat
        sampled = windowed_bilinear_matmul(corr, centroid[:, 0],
                                           centroid[:, 1], radius)
        out.append(sampled.reshape(B, H, W, -1))
    return torch.cat(out, dim=-1)


class CorrBlock:
    """Materialised all-pairs correlation pyramid with windowed lookup."""

    def __init__(self, fmap1, fmap2, num_levels: int = 4, radius: int = 4,
                 scale: bool = True, rescale: bool = True,
                 storage: str = "float32"):
        self.radius = radius
        self.rescale = rescale
        self.pyramid = build_corr_pyramid(fmap1, fmap2, num_levels, scale,
                                          storage)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        return pyramid_lookup(self.pyramid, coords, self.radius, self.rescale)


def build_feature_pyramid(fmap2: torch.Tensor, num_levels: int) -> tuple:
    """Pooled target features for the on-demand lookup, each contiguous
    NHWC (B, H/2^l, W/2^l, C)."""
    pyramid2 = [fmap2.contiguous()]
    for _ in range(num_levels - 1):
        pyramid2.append(avg_pool2x2(pyramid2[-1]).contiguous())
    return tuple(pyramid2)


def alternate_lookup(fmap1: torch.Tensor, pyramid2, coords: torch.Tensor,
                     radius: int, scale: bool = True,
                     rescale: bool = True, mxu_dtype: str = "float32",
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """On-demand windowed lookup over a pooled feature pyramid; equal to
    ``pyramid_lookup`` over the materialised volume. A CUDA tensor goes to
    the kernel, a CPU tensor to its plain version; a level pooled to zero
    size gives zero windows either way. ``mxu_dtype`` ("float32" or
    "bfloat16") is the products' operand dtype, ``out_dtype`` the windows'
    (``corr_cuda.windowed_correlation_bf16``; on the card, the maps').
    bfloat16 maps take the bf16 forms whatever ``mxu_dtype`` says: their
    forward products are exact in either form, and the backward multiplies
    the cotangents in ``mxu_dtype``. Differentiable on both devices (no
    gradient for ``coords`` on the card)."""
    if mxu_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"mxu_dtype must be 'float32' or 'bfloat16', got "
                         f"{mxu_dtype!r}")
    if mxu_dtype == "bfloat16" or fmap1.dtype == torch.bfloat16:
        return corr_cuda.windowed_correlation_bf16(
            fmap1, pyramid2, coords, radius, scale, rescale, out_dtype,
            mxu_dtype)
    return corr_cuda.windowed_correlation_fused(
        fmap1, pyramid2, coords, radius, scale, rescale).to(out_dtype)


class AlternateCorrBlock:
    """Memory-efficient correlation: pool features, recompute windows on
    demand."""

    def __init__(self, fmap1, fmap2, num_levels: int = 4, radius: int = 4,
                 scale: bool = True, rescale: bool = True):
        self.radius = radius
        self.scale = scale
        self.rescale = rescale
        self.fmap1 = fmap1.contiguous()
        self.pyramid2 = build_feature_pyramid(fmap2, num_levels)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        return alternate_lookup(self.fmap1, self.pyramid2,
                                coords.contiguous(), self.radius, self.scale,
                                self.rescale)
