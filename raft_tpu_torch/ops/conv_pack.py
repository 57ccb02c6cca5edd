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


def pack_conv(weight: torch.Tensor, bias: torch.Tensor) -> tuple:
    """``(w, b (ldw))``, float32 and contiguous, for a convolution of one
    input part (several parts whose widths are multiples of ``KC`` pack
    the same way, as one): ``w`` is ``(2, ldw, rows)``, hi and lo of the
    transposed matrix, or ``(rows, 2)`` for an N = 2 convolution."""
    n, cin, ky, kx = weight.shape
    taps = ky * kx
    rows = weight.detach().float().reshape(n, cin, taps).permute(2, 1, 0)
    if cin != 2:
        rows = F.pad(rows, (0, 0, 0, round_up(cin, KC) - cin))
    rows = rows.reshape(-1, n)
    rows = F.pad(rows, (0, 0, 0, packed_rows(cin, taps) - rows.shape[0]))
    bias = bias.detach().float()
    if n == 2:
        return rows.contiguous(), bias.contiguous()
    ldw = round_up(n, BN)
    return (split_tf32(F.pad(rows, (0, ldw - n)).t()).contiguous(),
            F.pad(bias, (0, ldw - n)).contiguous())
