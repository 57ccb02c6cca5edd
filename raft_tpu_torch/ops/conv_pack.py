"""The weight layout of the shared convolution tile, ``csrc/conv_phase.cuh``.

A convolution's weight (N, Cin, ky, kx) becomes a K x N matrix whose K
rows are tap-major, tap ``(dy + ky//2) * kx + (dx + kx//2)``, and within a
tap the input channels followed by zero rows up to a multiple of ``KC``
(a chunk of the kernel's reduction never straddles a tap or a part). A
2-channel input (the flow) packs taps x 2 channels densely instead, zero
rows up to a multiple of ``KC``. Columns, and the bias, are padded with
zeros to a multiple of ``BN`` (``ldw`` columns).

The tile reads the matrix K-contiguous, as the B operand of its MMAs, and
multiplies in 3xTF32, so the matrix is stored transposed and split once
here, as ``(2, ldw, rows)``: its TF32 high part and the TF32 rounding of
the remainder (``split_tf32``). An N = 2 convolution, which the kernel runs
one warp per pixel in f32 on its two columns as they are, keeps one
``(rows, 2)`` float32 matrix.

The tests replay the kernel's arithmetic on these matrices
(``tests/torch_conv_replay.py``, ``tests/test_torch_conv_tile.py``).

The tile's bf16 form (the mixed-precision policy) takes the same matrix
once, rounded to bfloat16 (``pack_conv_bf16``), with the bias as float32
values rounded to bfloat16. ``conv2d`` is a convolution as the kernels
compute it, in float32 or in bfloat16: the plain versions use it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KC = 16     # conv_phase.cuh: K rows of a chunk (a part pads to a multiple)
BK = 32     # conv_phase.cuh: K rows of one pipeline stage (two chunks)
BN = 64     # conv_phase.cuh: output channels per tile


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def packed_rows(cin: int, taps: int) -> int:
    """Rows of the packed matrix of a one-part convolution."""
    return round_up(2 * taps, KC) if cin == 2 else taps * round_up(cin, KC)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 stored mantissa bits, to
    nearest with ties away from zero: ``cvt.rna.tf32.f32``. The low 13
    bits of the result are zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> torch.Tensor:
    """``(2, *x.shape)``: ``hi = tf32_rna(x)`` and ``lo = tf32_rna(x -
    hi)``, so that ``hi + lo`` is ``x`` to about 2^-22 relative."""
    hi = tf32_rna(x)
    return torch.stack([hi, tf32_rna(x - hi)])


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           padding=0) -> torch.Tensor:
    """``F.conv2d`` of NCHW ``x`` in its dtype. float32: as it is.
    bfloat16 (the JAX kernels' compute dtype): the bfloat16 convolution of
    ``x`` with the weight rounded to bfloat16 (float32 sums rounded to
    bfloat16: cuDNN on the card, oneDNN on the CPU), then the bfloat16 bias
    added in bfloat16, the flax ``Conv`` contract at ``dtype=bfloat16``
    (``extractor.conv`` for the encoders). The weight is cast in the
    autograd graph: its gradient reaches the float32 parameter."""
    if x.dtype == torch.float32:
        return F.conv2d(x, weight, bias, padding=padding)
    y = F.conv2d(x, weight.to(x.dtype), padding=padding)
    return y + bias.to(x.dtype)[:, None, None]


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest even), kept in float32."""
    return x.detach().float().to(torch.bfloat16).float()


def _matrix(weight: torch.Tensor) -> torch.Tensor:
    """The packed K x N float32 matrix of ``weight`` (N, Cin, ky, kx)."""
    n, cin, ky, kx = weight.shape
    taps = ky * kx
    rows = weight.detach().float().reshape(n, cin, taps).permute(2, 1, 0)
    if cin != 2:
        rows = F.pad(rows, (0, 0, 0, round_up(cin, KC) - cin))
    rows = rows.reshape(-1, n)
    return F.pad(rows, (0, 0, 0, packed_rows(cin, taps) - rows.shape[0]))


def pack_conv(weight: torch.Tensor, bias: torch.Tensor) -> tuple:
    """``(w, b (ldw))``, float32 and contiguous, for a convolution of one
    input part (several parts whose widths are multiples of ``KC`` pack
    the same way, as one): ``w`` is ``(2, ldw, rows)``, hi and lo of the
    transposed matrix, or ``(rows, 2)`` for an N = 2 convolution."""
    n = weight.shape[0]
    rows = _matrix(weight)
    bias = bias.detach().float()
    if n == 2:
        return rows.contiguous(), bias.contiguous()
    ldw = round_up(n, BN)
    return (split_tf32(F.pad(rows, (0, ldw - n)).t()).contiguous(),
            F.pad(bias, (0, ldw - n)).contiguous())


def pack_conv_bf16(weight: torch.Tensor, bias: torch.Tensor) -> tuple:
    """``pack_conv``'s layout for the bf16 form: ``w`` is one bfloat16
    ``(ldw, rows)`` matrix (no lo part), or ``(rows, 2)`` for an N = 2
    convolution; ``b`` is float32 holding bfloat16 values."""
    n = weight.shape[0]
    rows = _matrix(weight)
    if n == 2:
        return rows.to(torch.bfloat16).contiguous(), round_bf16(bias)
    ldw = round_up(n, BN)
    return (F.pad(rows, (0, ldw - n)).t().to(torch.bfloat16).contiguous(),
            round_bf16(F.pad(bias.detach(), (0, ldw - n))).contiguous())
