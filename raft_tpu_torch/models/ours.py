"""The sparse-keypoint flow model ("ours"), the counterpart of
``raft_tpu/models/ours.py``'s ``SparseRAFT``.

A DAB-DETR-style decoder over ``num_keypoints`` learned keypoint queries
attends, by multi-scale deformable attention, to a token set built from the
bidirectional correlation of the two images and their CNN features over
``num_feature_levels`` pyramid levels; each of the ``outer_iterations``
recovers dense flow by soft-attending the stride-4 context map against the
keypoint embeddings. In order:

1. both images normalised, through ``CNNEncoder`` (instance norm) and
   ``CNNDecoder`` (batch norm, running statistics, and the context map U1);
2. per level, the forward and backward fork correlation: a 2-level lookup
   of radius 4 at the half-pixel centres with no per-level rescale
   (``AlternateCorrBlock(rescale=False)``, the corr kernel on the card, or
   the materialised ``CorrBlock``);
3. tokens: the correlation through ``corr_proj`` (motion half) beside the
   features through ``input_proj`` (context half), for both images;
4. separable learned position embeddings, resized with JAX's linear resize;
5. ``encoder_iterations`` deformable encoder layers over each half (every
   token a query: the MSDA kernel);
6. per outer iteration: DAB query positioning, a decoder layer (the MSDA
   kernel in its cross-attention), inverse-sigmoid flow refinement, the
   dense flow from context attention, resized to the image.

Flows are NHWC ``(B, H, W, 2)``. ``train=True`` is the training forward of
``raft_tpu/models/ours.py``: ``CNNDecoder``'s batch norm on the statistics
of both images' batch (unless ``freeze_bn``), dropout at the transformer's
sites from the caller's generator, and the gradient cut where JAX has
``stop_gradient`` (the reference-flow bank, the source points, the
destination slots of the reference points, the masks and the scores). The
fork correlation is differentiable on both engines (on the card,
``WindowedCorrelationFn`` with ``rescale=False``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from raft_tpu_torch.config import OursConfig
from raft_tpu_torch.models.corr import AlternateCorrBlock, CorrBlock
from raft_tpu_torch.models.deformable import (
    MLP, DeformableTransformerDecoderLayer, DeformableTransformerEncoder,
    DeformableTransformerEncoderLayer, MSDeformAttn, TokenGroupNorm)
from raft_tpu_torch.models.normalize import normalize_image
from raft_tpu_torch.models.sparse_extractor import CNNDecoder, CNNEncoder
from raft_tpu_torch.ops.sampling import inverse_sigmoid, resize_linear


def _center_grid(h: int, w: int, normalize: bool, device=None):
    """(h*w, 2) half-pixel-centre points (x, y), in pixels or normalised to
    [0, 1]."""
    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    if normalize:
        ys, xs = ys / h, xs / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1).reshape(h * w, 2)


def _position_grid(row_tab, col_tab, h: int, w: int) -> torch.Tensor:
    """(h*w, 2*half): the column table resized to h rows (the y half) beside
    the row table resized to w columns (the x half)."""
    half = row_tab.shape[1]
    cy = resize_linear(col_tab, (h, half))
    rx = resize_linear(row_tab, (w, half))
    return torch.cat([cy[:, None].expand(h, w, half),
                      rx[None].expand(h, w, half)], dim=-1).reshape(h * w, -1)


class SparseRAFT(nn.Module):
    """The "ours" model, f32: inference and the training forward."""

    def __init__(self, config: OursConfig = OursConfig()):
        super().__init__()
        if config.mixed_precision:
            raise NotImplementedError(
                "the sparse family's bf16 mixed precision is not ported yet")
        root = round(math.sqrt(config.num_keypoints))
        if root * root != config.num_keypoints:
            raise ValueError(
                f"num_keypoints must be a perfect square (got "
                f"{config.num_keypoints}): the initial reference points form "
                "a sqrt(N) x sqrt(N) grid")
        self.config = cfg = config
        L, N, Dm = cfg.num_feature_levels, cfg.num_keypoints, cfg.d_model
        half = Dm // 2
        corr_dim = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.cnn_encoder = CNNEncoder(cfg.base_channel, "instance")
        self.cnn_decoder = CNNDecoder(cfg.base_channel, "batch")
        self.corr_proj = nn.ModuleList(MLP(corr_dim, half, half, 3)
                                       for _ in range(L))
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Linear(ch, half), TokenGroupNorm(16, half))
            for ch in cfg.level_channels)
        self.row_pos_embed = nn.Parameter(torch.empty(1000, half))
        self.col_pos_embed = nn.Parameter(torch.empty(1000, half))
        self.lvl_pos_embed = nn.Parameter(torch.empty(L, Dm))
        self.img_pos_embed = nn.Parameter(torch.empty(3, Dm))
        if cfg.encoder_iterations > 0:
            self.encoder_pos_proj = nn.Linear(Dm, half)
            self.encoder = nn.ModuleList(
                DeformableTransformerEncoderLayer(
                    half, half * 4, "gelu", 2 * L, cfg.n_heads, cfg.n_points,
                    cfg.dropout)
                for _ in range(cfg.encoder_iterations))
            self.context_encoder = nn.ModuleList(
                DeformableTransformerEncoderLayer(
                    half, half * 4, "gelu", 2 * L, cfg.n_heads, cfg.n_points,
                    cfg.dropout)
                for _ in range(cfg.encoder_iterations))
        self.context_pos_embed = nn.Linear(Dm, cfg.up_dim)
        self.query_embed = nn.Parameter(torch.empty(N, Dm))
        self.ref_point_head = MLP(4, Dm, Dm, 3)
        if cfg.outer_iterations > 1:        # used from the second on
            self.query_scale = MLP(Dm, Dm, Dm, 2)
            self.motion_high_dim_query_proj = MLP(Dm, Dm, Dm, 2)
        self.decoder = nn.ModuleList(
            DeformableTransformerDecoderLayer(Dm, Dm * 4, "gelu", 2 * L,
                                              cfg.n_heads, cfg.n_points,
                                              cfg.dropout)
            for _ in range(cfg.outer_iterations))
        self.flow_embed = nn.ModuleList(MLP(Dm, Dm, 2, 3)
                                        for _ in range(cfg.outer_iterations))
        self.context_embed = nn.ModuleList(
            MLP(Dm, cfg.up_dim, cfg.up_dim, 3)
            for _ in range(cfg.outer_iterations))
        self.init_weights(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SparseRAFT":
        """Random weights from ``generator``, with the JAX package's init
        rules (not its random numbers): convolution and linear weights
        LeCun normal (truncated at two deviations), zero biases, unit norm
        scales, the 1000-entry position tables and the level and image
        embeddings N(0, 1), the queries Xavier uniform, and the MSDA heads'
        own init (``MSDeformAttn.reset_parameters``)."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                fan_in = module.weight[0].numel()
                std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                nn.init.zeros_(module.bias)
        for table in (self.row_pos_embed, self.col_pos_embed,
                      self.lvl_pos_embed, self.img_pos_embed):
            nn.init.normal_(table, generator=generator)
        nn.init.xavier_uniform_(self.query_embed, generator=generator)
        for module in self.modules():
            if isinstance(module, MSDeformAttn):
                module.reset_parameters()
        return self

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: Optional[int] = None,
                flow_init: Optional[torch.Tensor] = None,
                test_mode: bool = False, train: bool = False,
                freeze_bn: bool = False,
                generator: Optional[torch.Generator] = None):
        """``image1``/``image2`` (B, H, W, 3) in [0, 255]. ``iters`` is
        accepted and ignored (``outer_iterations`` rules). Returns
        ``(flow_low (B, H/8, W/8, 2), flow_up (B, H, W, 2))`` with
        ``test_mode``, else ``(flow_predictions, sparse_predictions)``: one
        (B, H, W, 2) flow and one ``(src_points, key_flow, masks, scores)``
        per outer iteration.

        ``train`` trains ``CNNDecoder``'s batch norm on the batch
        statistics (moving the running ones) unless ``freeze_bn``, and
        applies dropout drawn from ``generator``, which training with
        ``config.dropout > 0`` needs."""
        del iters
        if flow_init is not None:
            raise ValueError("the sparse family does not support warm "
                             "starting (flow_init)")
        cfg = self.config
        if train and cfg.dropout > 0 and generator is None:
            raise ValueError(f"training with dropout {cfg.dropout} draws "
                             "its masks from a generator: pass generator=")
        norm_train = train and not freeze_bn
        rng = generator if train else None        # None: deterministic
        B, I_H, I_W, _ = image1.shape
        L, N, Dm = cfg.num_feature_levels, cfg.num_keypoints, cfg.d_model
        dev = image1.device

        both = torch.cat([normalize_image(image1), normalize_image(image2)])
        E1, E2 = self.cnn_encoder(both, norm_train)
        D1, D2, U1 = self.cnn_decoder(both, norm_train)
        E1, E2 = E1[4 - L:], E2[4 - L:]
        D1, D2 = D1[4 - L:], D2[4 - L:]
        shapes = [tuple(f.shape[1:3]) for f in D1]
        spatial_shapes = shapes * 2                  # image 1's, image 2's

        block = AlternateCorrBlock if cfg.alternate_corr else CorrBlock
        motion, context = [[], []], [[], []]
        for lvl, (h, w) in enumerate(shapes):
            centers = _center_grid(h, w, False, dev).reshape(1, h, w, 2)
            centers = centers.expand(B, h, w, 2)
            for side, (fa, fb) in enumerate(((E1[lvl], E2[lvl]),
                                             (E2[lvl], E1[lvl]))):
                corr = block(fa, fb, cfg.corr_levels, cfg.corr_radius,
                             rescale=False)(centers)
                motion[side].append(
                    self.corr_proj[lvl](corr.reshape(B, h * w, -1)))
            for side, feat in enumerate((D1[lvl], D2[lvl])):
                context[side].append(
                    self.input_proj[lvl](feat.reshape(B, h * w, -1)))
        motion_src = torch.cat(motion[0] + motion[1], dim=1)
        context_src = torch.cat(context[0] + context[1], dim=1)

        pos_cat = torch.cat([
            _position_grid(self.row_pos_embed, self.col_pos_embed, h, w)
            + self.lvl_pos_embed[lvl]
            for lvl, (h, w) in enumerate(shapes)])[None]     # (1, ΣHW, Dm)
        src_pos = torch.cat([pos_cat + self.img_pos_embed[0],
                             pos_cat + self.img_pos_embed[1]], dim=1)

        if cfg.encoder_iterations > 0:
            enc_ref = DeformableTransformerEncoder.get_reference_points(
                spatial_shapes, dev)
            half_pos = self.encoder_pos_proj(src_pos)
            for motion_layer, context_layer in zip(self.encoder,
                                                   self.context_encoder):
                motion_src = motion_layer(motion_src, half_pos, enc_ref,
                                          spatial_shapes, rng)
                context_src = context_layer(context_src, half_pos, enc_ref,
                                            spatial_shapes, rng)
        src = torch.cat([motion_src, context_src], dim=-1)

        uh, uw = U1.shape[1:3]
        context_pos = self.context_pos_embed(
            _position_grid(self.row_pos_embed, self.col_pos_embed, uh, uw)
            [None] + self.img_pos_embed[2])
        context_keys = U1.reshape(B, uh * uw, -1) + context_pos

        query = self.query_embed[None].expand(B, N, Dm)
        root = round(math.sqrt(N))
        base = _center_grid(root, root, True, dev)[None].expand(B, N, 2)
        # the reference-point bank: slot 0 the source grid, the others dst
        reference_points = base[:, :, None].expand(B, N, 2 * L, 2)
        reference_flows = torch.full((B, N, 2), 0.5, device=dev)
        image_scale = torch.tensor([I_W, I_H], dtype=torch.float32,
                                   device=dev)

        flow_predictions, sparse_predictions = [], []
        for o_i in range(cfg.outer_iterations):
            query_pos = self.ref_point_head(torch.cat(
                [reference_points[:, :, 0], reference_points[:, :, 1]], -1))
            if o_i != 0:
                query_pos = query_pos * self.query_scale(query)
                query_pos = query_pos + self.motion_high_dim_query_proj(query)
            query = self.decoder[o_i](query, query_pos, reference_points,
                                      src, src_pos, spatial_shapes, rng)

            fe = self.flow_embed[o_i](query) + inverse_sigmoid(
                reference_flows)
            reference_flows = torch.sigmoid(fe).detach()
            src_points = reference_points[:, :, 0].detach()
            dst_points = torch.sigmoid(inverse_sigmoid(src_points) + fe)
            key_flow = src_points - dst_points               # (B, N, 2)
            reference_points = torch.cat([
                src_points[:, :, None],
                dst_points.detach()[:, :, None].expand(B, N, 2 * L - 1, 2)],
                dim=2)

            ce = self.context_embed[o_i](query)              # (B, N, up_dim)
            context_attn = torch.softmax(
                context_keys @ ce.transpose(1, 2), dim=-1)   # (B, HW, N)
            masks = context_attn.detach().transpose(1, 2).reshape(B, N, uh,
                                                                  uw)
            scores = context_attn.detach().amax(dim=1)
            flow = (context_attn @ key_flow).reshape(B, uh, uw, 2) \
                * image_scale
            if (uh, uw) != (I_H, I_W):
                flow = resize_linear(flow, (B, I_H, I_W, 2))
            flow_predictions.append(flow)
            sparse_predictions.append((src_points, key_flow, masks, scores))

        if test_mode:
            flow_up = flow_predictions[-1]
            flow_low = resize_linear(
                flow_up, (B, I_H // 8, I_W // 8, 2)) / 8.0
            return flow_low, flow_up
        return flow_predictions, sparse_predictions


# The reference module calls this class ``RAFT``.
RAFT = SparseRAFT
