"""Deformable-transformer building blocks of the sparse family, the
counterpart of ``raft_tpu/models/deformable.py``: ``MSDeformAttn`` (linear
heads predict per (head, level, point) sampling offsets and softmaxed
attention weights; the sampling core is ``ops/msda.py``), the decoder layer
(multi-head self-attention, deformable cross-attention, FFN), the encoder
layer (deformable self-attention, FFN) and the token ``MLP``.

Tokens are (B, N, C). The numerics follow flax: ``nn.gelu`` is the tanh
approximation, ``LayerNorm`` has eps 1e-6, and ``GroupNorm`` on tokens
normalises over the tokens and the group's channels together.

Dropout follows flax's ``nn.Dropout`` at the JAX package's five sites: the
two of the FFN, the decoder's self-attention weights and its two
pre-residual dropouts, the encoder layer's pre-residual one. Every layer's
``forward`` takes ``generator``: ``None`` is flax's ``deterministic=True``
(no dropout), a ``torch.Generator`` draws the keep masks from it. There is
no global random state.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from raft_tpu_torch.models.extractor import gelu
from raft_tpu_torch.ops import msda

FLAX_LAYER_NORM_EPS = 1e-6


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            mask_shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """flax ``nn.Dropout(rate)``: keep each entry with probability
    ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``; the identity
    when ``generator`` is None (deterministic) or ``rate`` is 0.
    ``mask_shape`` (broadcastable to ``x``) shares one keep mask across the
    axes where it has size 1, as flax's broadcast dims do."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(tuple(mask_shape or x.shape), generator=generator,
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), device=x.device,
                                                        dtype=x.dtype))


class TokenGroupNorm(nn.GroupNorm):
    """flax ``GroupNorm`` on (B, N, C) tokens: statistics over the tokens
    and the group's channels together, eps 1e-5."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=FLAX_LAYER_NORM_EPS)


def _directional_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """The reference's sampling-offset bias init: heads point along a ring
    of directions, scaled by the point index."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention. ``forward(query, reference_points,
    value_flatten, spatial_shapes)`` with ``reference_points``
    (B or 1, Lq, L, 2) normalised points or (..., 4) boxes; returns
    ``(output (B, Lq, d_model), attention_weights (B, Lq, M, L, P))``. The
    sampling core is ``ops/msda.py``'s dispatch: the kernel on the card,
    the plain version on the CPU."""

    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_heads {n_heads}")
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        mlp = n_heads * n_levels * n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, mlp * 2)
        self.attention_weights = nn.Linear(d_model, mlp)
        self.output_proj = nn.Linear(d_model, d_model)
        self.reset_parameters()

    def reset_parameters(self):
        """The reference's init of the two heads: zero weights, the
        directional ring as the offsets' bias, uniform attention."""
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                _directional_bias(self.n_heads, self.n_levels,
                                  self.n_points)))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def forward(self, query, reference_points, value_flatten,
                spatial_shapes: Sequence[Tuple[int, int]]):
        B, Lq, _ = query.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        if L != len(spatial_shapes):
            raise ValueError(f"{L} levels, got {len(spatial_shapes)} shapes")
        value = self.value_proj(value_flatten)
        value = value.reshape(value.shape[0], -1, M, self.d_model // M)
        offsets = self.sampling_offsets(query).reshape(B, Lq, M, L, P, 2)
        weights = torch.softmax(
            self.attention_weights(query).reshape(B, Lq, M, L * P), dim=-1)
        weights = weights.reshape(B, Lq, M, L, P)
        if reference_points.shape[-1] == 2:
            normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                      dtype=torch.float32,
                                      device=query.device)
            locations = (reference_points[:, :, None, :, None, :]
                         + offsets / normalizer[None, None, None, :, None, :])
        elif reference_points.shape[-1] == 4:
            locations = (reference_points[:, :, None, :, None, :2]
                         + offsets / P
                         * reference_points[:, :, None, :, None, 2:] * 0.5)
        else:
            raise ValueError("reference_points last dim must be 2 or 4")
        out = msda.ms_deform_attn(value.float().contiguous(), spatial_shapes,
                                  locations.float().contiguous(),
                                  weights.float().contiguous())
        return self.output_proj(out), weights


class _FFN(nn.Module):
    """Linear, activation, dropout, linear, dropout, residual and
    LayerNorm."""

    def __init__(self, d_model: int, d_ffn: int, activation: str = "relu",
                 dropout: float = 0.1):
        super().__init__()
        self.act = {"relu": torch.relu, "gelu": gelu}[activation]
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm = layer_norm(d_model)
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = dropout(self.act(self.linear1(x)), self.dropout, generator)
        y = dropout(self.linear2(y), self.dropout, generator)
        return self.norm(x + y)


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` with ``qkv_features = d_model``:
    per-head projections (``query``, ``key``, ``value``), the query scaled
    by 1/sqrt(head_dim), softmax over the keys, dropout on the weights
    (flax's ``broadcast_dropout=True``: one keep mask over the (queries,
    keys) axes, shared by the batch and the heads), ``out`` projection back
    to the input width. A matmul, a softmax and a matmul: no TPU kernel
    computes it, and it covers the decoder's few queries."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.1):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_heads {n_heads}")
        self.n_heads = n_heads
        self.dropout = dropout
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q_in, k_in, v_in,
                generator: Optional[torch.Generator] = None):
        B, N, C = q_in.shape
        heads = self.n_heads

        def split(t):                                   # (B, heads, N, hd)
            return t.reshape(B, -1, heads, C // heads).transpose(1, 2)

        q = split(self.query(q_in)) / math.sqrt(C // heads)
        k, v = split(self.key(k_in)), split(self.value(v_in))
        attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        attn = dropout(attn, self.dropout, generator,
                       (1, 1, *attn.shape[-2:]))
        return self.out((attn @ v).transpose(1, 2).reshape(B, N, C))


def _with_pos(x, pos):
    return x if pos is None else x + pos


class DeformableTransformerDecoderLayer(nn.Module):
    """Self-attention, deformable cross-attention over the token set, FFN;
    each followed by dropout, the residual and a LayerNorm. The
    self-attention's query and key carry the position embedding, its value
    does not."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024,
                 activation: str = "relu", n_levels: int = 1,
                 n_heads: int = 8, n_points: int = 4, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = SelfAttention(d_model, n_heads, dropout)
        self.norm2 = layer_norm(d_model)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = layer_norm(d_model)
        self.ffn = _FFN(d_model, d_ffn, activation, dropout)

    def forward(self, tgt, query_pos, reference_points, src, src_pos,
                spatial_shapes, generator: Optional[torch.Generator] = None):
        q = _with_pos(tgt, query_pos)
        tgt2 = self.self_attn(q, q, tgt, generator)
        tgt = self.norm2(tgt + dropout(tgt2, self.dropout, generator))
        tgt2, _ = self.cross_attn(_with_pos(tgt, query_pos), reference_points,
                                  _with_pos(src, src_pos), spatial_shapes)
        tgt = self.norm1(tgt + dropout(tgt2, self.dropout, generator))
        return self.ffn(tgt, generator)


class DeformableTransformerEncoderLayer(nn.Module):
    """Deformable self-attention over the token set (every token a query),
    dropout, the residual and a LayerNorm, then the FFN."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024,
                 activation: str = "relu", n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = layer_norm(d_model)
        self.ffn = _FFN(d_model, d_ffn, activation, dropout)

    def forward(self, src, pos, reference_points, spatial_shapes,
                generator: Optional[torch.Generator] = None):
        src2, _ = self.self_attn(_with_pos(src, pos), reference_points, src,
                                 spatial_shapes)
        src = self.norm1(src + dropout(src2, self.dropout, generator))
        return self.ffn(src, generator)


class MLP(nn.Module):
    """The experiments' pointwise MLP: Linear, then GroupNorm(gcd(32, dim))
    and GELU between layers, the last layer linear unless
    ``last_activate``."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, last_activate: bool = False):
        super().__init__()
        dims = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip([input_dim] + dims[:-1], dims))
        n_norms = num_layers if last_activate else num_layers - 1
        self.norms = nn.ModuleList(
            TokenGroupNorm(math.gcd(32, d), d) for d in dims[:n_norms])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.norms):
                x = gelu(self.norms[i](x))
        return x


def normalized_center_grid(spatial_shapes, device=None) -> torch.Tensor:
    """(1, sum(H*W), 2) pixel-centre grid of every level, normalised to
    [0, 1], in (x, y) order."""
    refs = []
    for h, w in spatial_shapes:
        ry = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        rx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    return torch.cat(refs, dim=0)[None]


class DeformableTransformerEncoder:
    """Only the reference points of the encoder stack for now (the stack
    itself serves the family's variants, not ported yet)."""

    @staticmethod
    def get_reference_points(spatial_shapes,
                             device: Optional[torch.device] = None):
        """(1, sum(H*W), L, 2): every token's normalised centre, repeated
        for each level."""
        ref = normalized_center_grid(spatial_shapes, device)
        return ref[:, :, None, :].expand(1, ref.shape[1],
                                         len(spatial_shapes), 2)
