"""The weight layout of the shared convolution tile, ``csrc/conv_phase.cuh``.

A convolution's weight (N, Cin, ky, kx) becomes a row-major matrix whose
rows are tap-major, tap ``(dy + ky//2) * kx + (dx + kx//2)``, and within a
tap the input channels followed by zero rows up to a multiple of ``BK``
(the kernel's reduction slice never straddles a tap). A 2-channel input
(the flow) packs taps x 2 channels densely instead, zero rows up to a
multiple of ``BK``. Columns, and the bias, are padded with zeros to a
multiple of ``BN``, except for an N = 2 convolution, which the kernel runs
one warp per pixel on its two columns as they are.

The tests replay the kernel's arithmetic on these matrices
(``tests/test_torch_motion.py``, ``tests/test_torch_step.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BK = 16     # conv_phase.cuh: reduction slice
BN = 64     # conv_phase.cuh: output channels per tile


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def packed_rows(cin: int, taps: int) -> int:
    """Rows of the packed matrix of a one-part convolution."""
    return round_up(2 * taps, BK) if cin == 2 else taps * round_up(cin, BK)


def pack_conv(weight: torch.Tensor, bias: torch.Tensor) -> tuple:
    """``(w (rows, ldw), b (ldw))``, float32 and contiguous, for a
    convolution of one input part (several parts whose widths are
    multiples of ``BK`` pack the same way, as one)."""
    n, cin, ky, kx = weight.shape
    taps = ky * kx
    rows = weight.detach().float().reshape(n, cin, taps).permute(2, 1, 0)
    if cin != 2:
        rows = F.pad(rows, (0, 0, 0, round_up(cin, BK) - cin))
    rows = rows.reshape(-1, n)
    rows = F.pad(rows, (0, 0, 0, packed_rows(cin, taps) - rows.shape[0]))
    ldw = n if n == 2 else round_up(n, BN)
    return (F.pad(rows, (0, ldw - n)).contiguous(),
            F.pad(bias.detach().float(), (0, ldw - n)).contiguous())
