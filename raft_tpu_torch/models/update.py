"""The update blocks of canonical RAFT, the counterpart of
``raft_tpu/models/update.py`` (``FlowHead``, ``SepConvGRU``,
``BasicMotionEncoder``, ``BasicUpdateBlock`` of RAFT-large; ``ConvGRU``,
``SmallMotionEncoder``, ``SmallUpdateBlock`` of RAFT-small).

Every module takes and returns NHWC tensors, as its counterpart does.
``BasicMotionEncoder`` and ``SepConvGRU`` hand their weights to
``ops/motion_cuda.py`` and ``ops/gru_cuda.py``, and ``BasicUpdateBlock``
the weights of all three modules to ``ops/step_cuda.py``: the CUDA kernel
on a CUDA tensor (differentiable: its backward recomputes through the plain
version, ``ops/recompute.py``), its plain version on the CPU. After an
optimizer updates the weights in place, the packed copies the kernels read
are rebuilt on the next call (``packed_weights``). The remaining convolutions
(the flow head outside the step kernel, the mask head) run as
``nn.Conv2d`` on an NCHW view of the NHWC memory. Attribute names follow
the torch state-dict keys (``update_block.gru.convz1``,
``update_block.mask.0`` ...). RAFT-small's block has no TPU kernel in the
reference either: its convolutions are ``nn.Conv2d`` (cuDNN on the card).

``BasicUpdateBlock`` computes in the dtype of ``net``: bfloat16 under the
mixed-precision policy, through the step kernel's bf16 form and bfloat16
heads on cuDNN (``extractor.conv``), with float32 parameters. The chain's
kernels have no bf16 form yet, so ``update_impl="chain"`` refuses it.
"""

from __future__ import annotations

import torch
from torch import nn

from raft_tpu_torch.models.extractor import cached_weights, conv
from raft_tpu_torch.ops import gru_cuda, motion_cuda, step_cuda

# Convex-upsampling mask channels: 9 neighbours x (8x8) sub-pixels.
UPSAMPLE_MASK_CHANNELS = 9 * 8 * 8
# BasicUpdateBlock.forward's choice of refine iteration, the counterpart of
# RAFT_STEP_PALLAS=auto|0: one launch of the step kernel, or the motion
# kernel followed by the GRU kernel.
UPDATE_IMPLS = ("step", "chain")


def conv_nhwc(layer, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW function of one tensor to an NHWC tensor; returns
    NHWC."""
    return layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> contiguous NCHW. cuDNN's f32 convolutions are NCHW kernels:
    handed channels-last views, it converts every operand (15 conversion
    launches an iteration of RAFT-small's block)."""
    return x.permute(0, 3, 1, 2).contiguous()


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def conv_pairs(*convs: nn.Conv2d) -> tuple:
    return tuple((c.weight, c.bias) for c in convs)


def packed_weights(module: nn.Module, pack, slot: str = "_packed") -> tuple:
    """``pack(module.convs())``, the layout a kernel reads, kept on the
    module under ``slot`` (one slot a layout) and repacked only when a
    parameter was replaced or written since the last call (a new state
    dict, a move to another device): ``extractor.cached_weights``."""
    return cached_weights(module, lambda m: pack(m.convs()), slot)


class FlowHead(nn.Module):
    """3x3 conv -> ReLU -> 3x3 conv to 2 channels."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)

    def convs(self) -> tuple:
        return conv_pairs(self.conv1, self.conv2)

    def packed_weights(self) -> tuple:
        return packed_weights(self, step_cuda.pack_flow_head)

    def packed_weights_bf16(self) -> tuple:
        return packed_weights(self, step_cuda.pack_flow_head_bf16,
                              "_packed_bf16")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC in and out, in ``x``'s dtype."""
        return conv_nhwc(lambda t: conv(self.conv2,
                                        self.relu(conv(self.conv1, t))), x)


class SepConvGRU(nn.Module):
    """Separable (1,5) then (5,1) convolutional GRU."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz1 = nn.Conv2d(cin, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(cin, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(cin, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(cin, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(cin, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(cin, hidden_dim, (5, 1), padding=(2, 0))

    def convs(self) -> tuple:
        return conv_pairs(self.convz1, self.convr1, self.convq1,
                          self.convz2, self.convr2, self.convq2)

    def packed_weights(self) -> tuple:
        return packed_weights(self, gru_cuda.pack_weights)

    def packed_weights_bf16(self) -> tuple:
        return packed_weights(self, gru_cuda.pack_weights_bf16,
                              "_packed_bf16")

    def forward(self, h: torch.Tensor, x) -> torch.Tensor:
        """``h`` (B, H, W, C) and ``x`` (B, H, W, Cx) or a tuple of parts,
        contiguous NHWC."""
        return gru_cuda.sepconv_gru(h, x, self.convs(), self.packed_weights())


class ConvGRU(nn.Module):
    """3x3 convolutional GRU (RAFT-small). Takes and returns NCHW tensors:
    ``SmallUpdateBlock`` runs the whole small block in NCHW."""

    def __init__(self, hidden_dim: int = 96, input_dim: int = 146):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = nn.Conv2d(cin, hidden_dim, 3, padding=1)
        self.convr = nn.Conv2d(cin, hidden_dim, 3, padding=1)
        self.convq = nn.Conv2d(cin, hidden_dim, 3, padding=1)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class SmallMotionEncoder(nn.Module):
    """Correlation + flow -> 82 motion channels ([80 features | flow]);
    NCHW in and out."""

    def __init__(self, corr_channels: int = 4 * 7 * 7):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 96, 1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 32, 3, padding=1)
        self.conv = nn.Conv2d(128, 80, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc1(corr))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SmallUpdateBlock(nn.Module):
    """RAFT-small's iteration: motion encoder -> ConvGRU -> FlowHead, with
    no mask head (the model upsamples with ``upflow8``)."""

    def __init__(self, hidden_dim: int = 96, input_dim: int = 64,
                 corr_channels: int = 4 * 7 * 7):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_channels)
        self.gru = ConvGRU(hidden_dim, input_dim + 82)
        self.flow_head = FlowHead(hidden_dim, 128)

    def forward(self, net, inp, corr, flow, compute_mask=True,
                update_impl: str = "step"):
        """NHWC in and out, as ``BasicUpdateBlock.forward``;
        ``compute_mask`` and ``update_impl`` are taken and ignored (no mask
        head, no kernel). Returns ``(net, None, delta_flow)``."""
        del compute_mask, update_impl
        flow = nchw(flow)
        motion = self.encoder(flow, nchw(corr))
        net = self.gru(nchw(net), torch.cat([nchw(inp), motion], dim=1))
        delta = self.flow_head.conv2(torch.relu(self.flow_head.conv1(net)))
        return nhwc(net), None, nhwc(delta)


class BasicMotionEncoder(nn.Module):
    """Correlation + flow -> 128 motion channels ([126 features | flow])."""

    def __init__(self, corr_channels: int = 4 * 9 * 9):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def convs(self) -> tuple:
        return conv_pairs(self.convc1, self.convc2, self.convf1, self.convf2,
                          self.conv)

    def packed_weights(self) -> tuple:
        return packed_weights(self, motion_cuda.pack_weights)

    def packed_weights_bf16(self) -> tuple:
        return packed_weights(self, motion_cuda.pack_weights_bf16,
                              "_packed_bf16")

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        return motion_cuda.motion_encoder(flow.contiguous(), corr.contiguous(),
                                          self.convs(), self.packed_weights())


class BasicUpdateBlock(nn.Module):
    """Motion encoder -> SepConvGRU -> FlowHead, plus the convex-upsampling
    mask head scaled by 0.25."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 128,
                 corr_channels: int = 4 * 9 * 9):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels)
        self.gru = SepConvGRU(hidden_dim, input_dim + 128)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(256, UPSAMPLE_MASK_CHANNELS, 1))

    def forward(self, net, inp, corr, flow, compute_mask=True,
                update_impl: str = "step"):
        """NHWC ``net`` (B,H,W,hdim), ``inp`` (B,H,W,cdim), ``corr``
        (B,H,W,L(2r+1)^2), ``flow`` (B,H,W,2). ``compute_mask=None`` skips
        the mask head (the non-final test-mode iterations). ``update_impl``
        ``"step"`` runs one step kernel (with the flow head inside it when
        the mask head is skipped, ``step_cuda.plan_fusion``); ``"chain"``
        runs the motion kernel, then the GRU kernel with x = (inp,
        motion). Returns ``(net, mask or None, delta_flow)``, in ``net``'s
        dtype (float32, or bfloat16 under mixed precision: the other
        inputs then in bfloat16 too)."""
        net, inp = net.contiguous(), inp.contiguous()
        bf16 = net.dtype == torch.bfloat16
        if update_impl == "chain" and bf16:
            raise NotImplementedError(
                "update_impl='chain' has no bf16 form: the bf16 chain kernels "
                "(motion_fwd and sepconv_gru in bfloat16) are not ported yet; "
                "use update_impl='step'")
        if update_impl == "step":
            with_head = step_cuda.plan_fusion(compute_mask is None) == "mgf"
            modules = [self.encoder, self.gru, None]
            if with_head:
                modules[2] = self.flow_head
            convs = [None if m is None else m.convs() for m in modules]
            packed = [None if m is None else m.packed_weights_bf16() if bf16
                      else m.packed_weights() for m in modules]
            out = step_cuda.fused_step(net, inp, corr.contiguous(),
                                       flow.contiguous(), convs, packed)
            if with_head:
                net, delta_flow = out
                return net, None, delta_flow
            net = out
        elif update_impl == "chain":
            net = self.gru(net, (inp, self.encoder(flow, corr)))
        else:
            raise ValueError(f"update_impl must be one of {UPDATE_IMPLS}, "
                             f"got {update_impl!r}")
        delta_flow = self.flow_head(net)
        if compute_mask is None:
            return net, None, delta_flow
        # 0.25 balances gradients into the mask head (reference update.py).
        mask = 0.25 * conv_nhwc(
            lambda t: conv(self.mask[2], self.mask[1](conv(self.mask[0], t))),
            net)
        return net, mask, delta_flow
