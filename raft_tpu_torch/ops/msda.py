"""Multi-scale deformable attention's sampling core, the counterpart of
``raft_tpu/ops/msda.py``.

For each (query, head, level, point), sample the value map bilinearly at a
predicted normalised location and sum the samples with predicted attention
weights. A normalised location ``u`` in [0, 1] maps to pixel ``u*W - 0.5``
(``F.grid_sample(align_corners=False)``), with zero padding outside the
level.

``ms_deform_attn`` dispatches on where the tensors lie: a CPU tensor goes to
the plain PyTorch version (``ms_deform_attn_plain``), a CUDA tensor to the
kernel of ``ops/msda_cuda.py`` at every query count (the JAX package's
128-query crossover was measured on a TPU and does not carry over).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from raft_tpu_torch.ops import msda_cuda
from raft_tpu_torch.ops.sampling import bilinear_sampler


def ms_deform_attn_plain(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """The sampling core in plain PyTorch, one batched bilinear gather per
    level: the CPU path and the kernel's test oracle.

    ``value`` (B, S, M, D) with ``S = sum(H_l * W_l)``; ``spatial_shapes``
    the levels' (H, W); ``sampling_locations`` (B, Lq, M, L, P, 2)
    normalised (x, y); ``attention_weights`` (B, Lq, M, L, P). Returns
    (B, Lq, M*D)."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes) or S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value {tuple(value.shape)} and locations "
                         f"{tuple(sampling_locations.shape)} do not match "
                         f"the levels {list(spatial_shapes)}")
    start = 0
    sampled = []
    for lvl, (H, W) in enumerate(spatial_shapes):
        v = value[:, start:start + H * W]                     # (B, HW, M, D)
        start += H * W
        v = v.permute(0, 2, 1, 3).reshape(B * M, H, W, D)
        loc = sampling_locations[:, :, :, lvl]                # (B, Lq, M, P, 2)
        px = loc[..., 0] * W - 0.5
        py = loc[..., 1] * H - 0.5
        coords = torch.stack([px, py], dim=-1).permute(0, 2, 1, 3, 4)
        out = bilinear_sampler(v, coords.reshape(B * M, Lq * P, 2))
        sampled.append(out.reshape(B, M, Lq, P, D))
    sampled = torch.stack(sampled, dim=3)                     # (B, M, Lq, L, P, D)
    weights = attention_weights.permute(0, 2, 1, 3, 4)        # (B, M, Lq, L, P)
    out = torch.einsum("bmqlpd,bmqlp->bqmd", sampled, weights)
    return out.reshape(B, Lq, M * D)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Deformable attention sampling, shapes as ``ms_deform_attn_plain``:
    the plain version for CPU tensors, the CUDA kernel
    (``msda_cuda.MSDeformAttnFn``) for CUDA tensors."""
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes,
                                    sampling_locations, attention_weights)
    return msda_cuda.MSDeformAttnFn.apply(
        msda_cuda.ms_deform_attn_cuda, value, tuple(spatial_shapes),
        sampling_locations, attention_weights)
