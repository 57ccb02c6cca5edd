"""The arithmetic of the port's shared CUDA convolution tile
(``raft_tpu_torch/csrc/conv_phase.cuh``), replayed with torch ops on the
packed weights, so that the CPU tests can hold the kernels' weight layout
(tap order, padding rows and columns, x parts) against the plain versions:
the kernels themselves run only on the card.

Each convolution is an implicit GEMM: per tap ``(dy, dx)`` in the kernel's
order, each input part read at the shifted pixel (zero outside the image),
its channels followed by zero columns up to a multiple of ``KC`` (a
2-channel input is taken densely, taps x 2), then the whole row
zero-padded to the packed matrix's rows; the product with the packed
weights (the sum of their TF32 hi and lo parts), plus the packed bias, cut
to the N real output channels. ``tests/test_torch_conv_tile.py`` replays
the kernel's 3xTF32 products themselves.

The bf16 form's packs (one bfloat16 ``(ldw, rows)`` matrix, columns padded
to the bf16 tile's block width, ``conv_pack.pack_conv_bf16``) replay the
same way: ``motion``, ``gru`` and ``flow_head`` given bfloat16 activations
and those packs sum the exact products in float32 and round where the
kernel rounds (``csrc/conv_phase.cuh``): each conv's sum to bfloat16
before its bfloat16 bias, then the gates and the blend.
"""

import torch
import torch.nn.functional as F

from raft_tpu_torch.ops.conv_pack import KC


def shift(t, dy, dx):
    """``t`` (B, H, W, C) read at (y + dy, x + dx), zero outside."""
    out = torch.zeros_like(t)
    H, W = t.shape[1:3]
    src_y = slice(max(dy, 0), H + min(dy, 0))
    dst_y = slice(max(-dy, 0), H - max(dy, 0))
    src_x = slice(max(dx, 0), W + min(dx, 0))
    dst_x = slice(max(-dx, 0), W - max(dx, 0))
    out[:, dst_y, dst_x] = t[:, src_y, src_x]
    return out


def columns(parts, ky, kx, rows):
    """The implicit GEMM's A operand (B, H, W, rows): per tap, each part
    at the shifted pixel, padded as the packed weights' K rows are."""
    cols = []
    for tap in range(ky * kx):
        dy, dx = tap // kx - ky // 2, tap % kx - kx // 2
        for p in parts:
            s = shift(p, dy, dx)
            c = p.shape[-1]
            if c != 2:
                s = F.pad(s, (0, -(-c // KC) * KC - c))
            cols.append(s)
    a = torch.cat(cols, dim=-1)
    return F.pad(a, (0, rows - a.shape[-1]))


def rb(x):
    """``x`` rounded to bfloat16, kept in float32."""
    return x.float().to(torch.bfloat16).float()


def conv(parts, w, b, ky, kx, n):
    """The convolution's sum plus bias; for a bfloat16 pack the float32 sum
    of the exact products rounded to bfloat16, then the bias added and
    rounded again (in float32, the values bfloat16)."""
    bf16 = w.dtype == torch.bfloat16
    if w.dim() == 3:            # (2, ldw, rows): hi and lo, transposed
        w = (w[0] + w[1]).t()
    elif bf16 and w.shape[1] != 2:  # (ldw, rows): transposed
        w = w.t()
    parts = [p.float() for p in parts]
    acc = (columns(parts, ky, kx, w.shape[0]) @ w.float())[..., :n]
    if bf16:
        return rb(rb(acc) + b[:n])
    return acc + b[:n]


def _round(x, like):
    """``x`` as the kernel holds it for ``like``'s form: bfloat16 values
    for a bfloat16 pack, else as it is."""
    return rb(x) if like.dtype == torch.bfloat16 else x


def motion(flow, corr, packed):
    """csrc/motion_fwd.cu's phases on ``motion_cuda.pack_weights`` (or
    ``pack_weights_bf16``: bfloat16 values out, held in float32)."""
    wc1, bc1, wc2, bc2, wf1, bf1, wf2, bf2, wo, bo = packed
    c1 = torch.relu(conv([corr], wc1, bc1, 1, 1, 256))
    cor = torch.relu(conv([c1], wc2, bc2, 3, 3, 192))
    f1 = torch.relu(conv([flow], wf1, bf1, 7, 7, 128))
    flo = torch.relu(conv([f1], wf2, bf2, 3, 3, 64))
    out = torch.relu(conv([torch.cat([cor, flo], -1)], wo, bo, 3, 3, 126))
    return torch.cat([out, flow.float()], dim=-1)


def gru(h, xs, packed):
    """csrc/sepconv_gru.cu's phases on ``gru_cuda.pack_weights`` (or
    ``pack_weights_bf16``, rounding as the kernel's bf16 form), x given as
    parts."""
    c = h.shape[-1]
    h = h.float()
    for half, (ky, kx) in enumerate(((1, 5), (5, 1))):
        w_zr, b_zr, w_q, b_q = packed[4 * half:4 * half + 4]
        zr = torch.sigmoid(conv([h, *xs], w_zr, b_zr, ky, kx, 2 * c))
        z, r = _round(zr[..., :c], w_zr), _round(zr[..., c:], w_zr)
        q = _round(torch.tanh(conv([_round(r * h, w_zr), *xs], w_q, b_q, ky,
                                   kx, c)), w_q)
        if w_q.dtype == torch.bfloat16:
            h = rb(rb(rb(1 - z) * h) + rb(z * q))
        else:
            h = (1 - z) * h + z * q
    return h


def flow_head(h, packed):
    """csrc/update_step.cu's flow-head phases on ``step_cuda.pack_flow_head``
    (or ``pack_flow_head_bf16``)."""
    w1, b1, w2, b2 = packed
    n1 = w1.shape[-2]
    x = torch.relu(conv([h], w1, b1, 3, 3, n1))
    return conv([x], w2, b2, 3, 3, 2)
