"""Training loss and in-loss metrics, the counterpart of
``raft_tpu/losses.py`` (``epe_metrics``, ``sequence_loss``).

``sequence_loss`` is the reference's L1 loss over every refinement
iteration's upsampled flow, weighted by ``gamma**(n - i - 1)`` and masked
by validity (``valid & |flow| < MAX_FLOW``). Predictions are stacked as
``(iters, B, H, W, 2)``, NHWC.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

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
