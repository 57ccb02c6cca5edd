"""Canonical RAFT-large inference (test mode), the counterpart of
``raft_tpu/models/raft.py``'s ``RAFT`` with ``test_mode=True``.

Images in [0, 255] NHWC; both go through ``fnet`` in one pass (batch
concatenation), ``cnet`` splits into the tanh hidden state and the ReLU
context. Then ``iters - 1`` refinement iterations without the mask head and
one final iteration with it, whose mask drives the convex 8x upsampling.
On the card each iteration is one launch of the step kernel
(``ops/step_cuda.py``) after the lookup, or, with ``update_impl="chain"``,
the motion kernel followed by the GRU kernel.
The correlation engine is the materialised all-pairs pyramid or the
on-demand lookup (``alternate_corr``), whose CUDA path is the kernel of
``ops/corr_cuda.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.corr import AlternateCorrBlock, CorrBlock
from raft_tpu_torch.models.extractor import BasicEncoder
from raft_tpu_torch.models.normalize import normalize_image
from raft_tpu_torch.models.update import BasicUpdateBlock
from raft_tpu_torch.ops.sampling import convex_upsample, coords_grid


class RAFT(nn.Module):
    """RAFT-large, f32, inference."""

    def __init__(self, config: RAFTConfig = RAFTConfig()):
        super().__init__()
        if config.small:
            raise NotImplementedError("RAFT-small is not ported yet")
        if config.mixed_precision:
            raise NotImplementedError(
                "the bf16 mixed-precision policy is not ported yet")
        if config.normalized_coords:
            raise ValueError("normalized_coords is not supported by the "
                             "canonical RAFT path")
        self.config = config
        self.fnet = BasicEncoder(config.fnet_dim, "instance")
        self.cnet = BasicEncoder(config.hdim + config.cdim, "batch")
        win = 2 * config.radius + 1
        self.update_block = BasicUpdateBlock(
            config.hdim, config.cdim, config.corr_levels * win * win)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: Optional[int] = None,
                flow_init: Optional[torch.Tensor] = None,
                alternate_corr: Optional[bool] = None,
                update_impl: str = "step"):
        """``image1``/``image2`` (B, H, W, 3) in [0, 255]; ``flow_init``
        (B, H/8, W/8, 2) or None; ``alternate_corr`` overrides the config's
        engine; ``update_impl`` picks the refine iteration's kernels
        (``BasicUpdateBlock.forward``). Returns ``(flow_low (B, H/8, W/8,
        2), flow_up (B, H, W, 2))``.
        """
        cfg = self.config
        iters = cfg.iters if iters is None else iters
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        if alternate_corr is None:
            alternate_corr = cfg.alternate_corr
        image1 = normalize_image(image1)
        image2 = normalize_image(image2)

        fmap1, fmap2 = self.fnet(torch.cat([image1, image2], dim=0)).chunk(2)
        block = AlternateCorrBlock if alternate_corr else CorrBlock
        corr_fn = block(fmap1, fmap2, cfg.corr_levels, cfg.radius,
                        cfg.corr_scale)

        cnet = self.cnet(image1)
        net = torch.tanh(cnet[..., :cfg.hdim]).contiguous()
        inp = torch.relu(cnet[..., cfg.hdim:]).contiguous()

        B, H8, W8, _ = fmap1.shape
        coords0 = coords_grid(B, H8, W8, device=fmap1.device)
        coords1 = coords0 if flow_init is None else coords0 + flow_init

        for itr in range(iters):
            last = itr == iters - 1
            corr = corr_fn(coords1)
            flow = coords1 - coords0
            net, mask, delta_flow = self.update_block(
                net, inp, corr, flow, compute_mask=True if last else None,
                update_impl=update_impl)
            coords1 = coords1 + delta_flow
        flow_low = coords1 - coords0
        return flow_low, convex_upsample(flow_low, mask)
