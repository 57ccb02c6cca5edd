"""The arithmetic of the port's conv tile (``csrc/conv_phase.cuh``),
emulated on the CPU: why the tile multiplies in 3xTF32 and not in one TF32
pass.

A TF32 operand keeps the top 11 bits of a float32 significand. The tile
splits each weight at pack time into ``hi = tf32_rna(w)`` and ``lo =
tf32_rna(w - hi)`` (``ops/conv_pack.py``), and each activation in
registers into ``hi = tf32_rna(a)`` and ``lo = a - hi``, of which the
tensor core reads the top 11 bits. Per k8 step it accumulates the
products a_lo*b_hi, a_hi*b_lo, a_hi*b_hi in that order into the partial
sum of its 32-deep pipeline stage (float32, each product adding its 8
exact terms to the sum), then adds the partial to the tile's sum. The
emulation below follows that order with torch ops on the packed matrices,
at the widths of two Sintel-size phases of the step kernel: the GRU gates
(K = 5 x 384, N = 256) and the flow head's first conv (K = 9 x 128, N =
256), and holds the result against float64 convolutions to
``chip_smoke.TOL``, the bar of the kernels against their plain versions on
the card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
import torch_conv_replay as replay
from raft_tpu_torch.models.update import FlowHead, SepConvGRU
from raft_tpu_torch.ops import conv_pack, gru_cuda, step_cuda

STAGE, STEP = conv_pack.BK, 8       # a pipeline stage's K, the MMA's k


def _tf32_trunc(x):
    """The top 11 significand bits of x, the rest cleared: what the tensor
    core reads of a float32 register given as a TF32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_activation(a):
    hi = conv_pack.tf32_rna(a)
    return hi, _tf32_trunc(a - hi)


def _tile_gemm(a, w, passes=3):
    """The tile's product of A (M, K) and packed ``w`` (2, N, K): 3xTF32,
    or one TF32 pass (hi * hi) for ``passes=1``, in the kernel's order."""
    a_hi, a_lo = _split_activation(a)
    b_hi, b_lo = w[0].t(), w[1].t()
    k = a.shape[1]
    order = ([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if passes == 3
             else [(a_hi, b_hi)])
    # the 8 products of one k8 step, exact in float64
    steps = [[(x[:, s:s + STEP].double() @ y[s:s + STEP].double())
              for x, y in order] for s in range(0, k, STEP)]
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
    for s0 in range(0, len(steps), STAGE // STEP):
        part = torch.zeros_like(acc)
        for step in steps[s0:s0 + STAGE // STEP]:
            for prod in step:
                part = (part.double() + prod).float()
        acc = acc + part
    return acc


def _cases():
    """The packed GRU-gate and flow-head convs: their inputs as the A
    operand at a few image rows, the packed and the unsplit K x N matrix
    (transposed, as packed), and the float64 convolution."""
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    gru = SepConvGRU(128, 256)
    head = FlowHead(128, 256)
    h = torch.from_numpy(np.tanh(rng.standard_normal((1, 3, 32, 128)))
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 3, 32, 256))
                         .astype(np.float32))
    w_zr = torch.cat([gru.convz1.weight, gru.convr1.weight]).detach()
    ref = F.conv2d(torch.cat([h, x], -1).permute(0, 3, 1, 2).double(),
                   w_zr.double(), padding=(0, 2)).permute(0, 2, 3, 1)
    packed = gru_cuda.pack_weights(gru.convs())[0]
    yield ("gru gates", replay.columns([h, x], 1, 5, packed.shape[2]),
           packed, w_zr.reshape(256, 384, 5).transpose(1, 2).reshape(256, -1),
           ref)
    w1 = head.conv1.weight.detach()
    ref = F.conv2d(h.permute(0, 3, 1, 2).double(), w1.double(),
                   padding=1).permute(0, 2, 3, 1)
    packed = step_cuda.pack_flow_head(head.convs())[0]
    yield ("flow head", replay.columns([h], 3, 3, packed.shape[2]), packed,
           w1.permute(0, 2, 3, 1).reshape(256, -1), ref)


CASES = list(_cases())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_three_tf32_passes_hold_the_bar_and_one_does_not(case):
    """Max |tile - float64| over 96 pixels x 256 channels: 3xTF32 within a
    hundredth of the bar (6.4e-7 and 2.9e-7), one TF32 pass above it (6.1e-4,
    3.9e-4)."""
    _, cols, w, _, ref = case
    a = cols.reshape(-1, cols.shape[-1])
    want = ref.reshape(-1, ref.shape[-1])
    three = (_tile_gemm(a, w).double() - want).abs().max().item()
    one = (_tile_gemm(a, w, passes=1).double() - want).abs().max().item()
    assert three <= chip_smoke.TOL / 100, three
    assert one > chip_smoke.TOL, one


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_packed_hi_and_lo_split_the_weight(case):
    """hi and lo are TF32 values (the low 13 significand bits clear), lo
    is at most 2^-11 of hi, and hi + lo gives the float32 weight back to
    2^-22 of it (one TF32 rounding of the remainder: 2 float32 ulps)."""
    _, _, w, weight, _ = case
    assert int((w.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    hi, lo = w[0].double(), w[1].double()
    assert torch.all(lo.abs() <= 2.0 ** -11 * hi.abs())
    weight = weight.double()
    assert torch.all((hi + lo - weight).abs() <= 2.0 ** -22 * weight.abs())
