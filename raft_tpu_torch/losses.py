"""Training loss and in-loss metrics, the counterpart of
``raft_tpu/losses.py`` (``epe_metrics``, ``sequence_loss``,
``sparse_keypoint_loss``).

``sequence_loss`` is the reference's L1 loss over every refinement
iteration's upsampled flow, weighted by ``gamma**(n - i - 1)`` and masked
by validity (``valid & |flow| < MAX_FLOW``). Predictions are stacked as
``(iters, B, H, W, 2)``, NHWC. ``sparse_keypoint_loss`` is the sparse
family's auxiliary loss on its keypoint flows.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from raft_tpu_torch.ops.sampling import bilinear_sampler

MAX_FLOW = 400.0  # reference train.py:48


def epe_metrics(flow_pred: torch.Tensor, flow_gt: torch.Tensor,
                valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mean end-point error and 1/3/5-px accuracies of ``flow_pred``
    (B, H, W, 2) against ``flow_gt`` over the pixels where ``valid``
    (B, H, W) is set."""
    epe = torch.sqrt(torch.sum((flow_pred - flow_gt) ** 2, dim=-1))
    v = valid.float()
    denom = torch.clamp(v.sum(), min=1.0)

    def masked_mean(x):
        return (x * v).sum() / denom

    return {"epe": masked_mean(epe),
            "1px": masked_mean((epe < 1.0).float()),
            "3px": masked_mean((epe < 3.0).float()),
            "5px": masked_mean((epe < 5.0).float())}


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                  valid: torch.Tensor, gamma: float = 0.8,
                  max_flow: float = MAX_FLOW, normalization: str = "all",
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted multi-iteration L1 flow loss.

    ``normalization="all"`` is the reference's ``(valid * |pred -
    gt|).mean()`` over all pixels; ``"valid"`` divides by the valid-pixel
    count. Returns the scalar loss and the metrics of the final iteration
    (``epe_metrics`` plus ``loss``)."""
    if normalization not in ("all", "valid"):
        raise ValueError(f"normalization must be 'all' or 'valid', "
                         f"got {normalization!r}")
    n = flow_preds.shape[0]
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=-1))
    v = valid.float() * (mag < max_flow).float()                 # (B,H,W)
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                    device=flow_preds.device)
    masked = torch.abs(flow_preds - flow_gt[None]).mean(dim=-1) * v[None]
    if normalization == "all":
        per_iter = masked.mean(dim=(1, 2, 3))
    else:
        per_iter = masked.sum(dim=(1, 2, 3)) / torch.clamp(v.sum(), min=1.0)
    loss = torch.sum(weights * per_iter)
    metrics = epe_metrics(flow_preds[-1], flow_gt, v)
    metrics["loss"] = loss
    return loss, metrics


def sparse_keypoint_loss(sparse_preds: Sequence, flow_gt: torch.Tensor,
                         valid: torch.Tensor,
                         max_flow: float = MAX_FLOW) -> torch.Tensor:
    """The auxiliary keypoint-flow loss of the sparse family (reference
    ``train.py:71-83``): for each outer iteration, the L1 between every
    keypoint's flow and the ground truth read at its reference point,
    weighted by the validity read there, divided by ``max(2 * sum of that
    validity, 1)``; the mean over the iterations.

    It keeps the JAX package's deliberate deviation from the fork, which
    reads the ground truth at rounded points through a flat index of
    ``y * x`` (an indexing bug): the ground truth (masked by ``valid & |flow|
    < max_flow``) and the mask are sampled bilinearly at ``ref * (W - 1,
    H - 1)``.

    ``sparse_preds``: ``(ref_points (B, K, 2) in [0, 1] (x, y), key_flows
    (B, K, 2) in pixels)`` per iteration; ``flow_gt`` (B, H, W, 2);
    ``valid`` (B, H, W)."""
    _, H, W, _ = flow_gt.shape
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=-1))
    vmask = (valid.float() * (mag < max_flow).float())[..., None]
    scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                         device=flow_gt.device)
    total = 0.0
    for ref_points, key_flows in sparse_preds:
        pix = ref_points * scale
        gt_at_kp = bilinear_sampler(flow_gt * vmask, pix)        # (B, K, 2)
        v_at_kp = bilinear_sampler(vmask, pix)                   # (B, K, 1)
        l1 = torch.abs(key_flows - gt_at_kp) * v_at_kp
        total = total + l1.sum() / torch.clamp(v_at_kp.sum() * 2.0, min=1.0)
    return total / max(len(sparse_preds), 1)
