"""The arithmetic of the port's shared CUDA convolution tile
(``raft_tpu_torch/csrc/conv_phase.cuh``), replayed with torch ops on the
packed weights, so that the CPU tests can hold the kernels' weight layout
(tap order, padding rows and columns, x parts) against the plain versions:
the kernels themselves run only on the card.

Each convolution is an implicit GEMM: per tap ``(dy, dx)`` in the kernel's
order, each input part read at the shifted pixel (zero outside the image),
its channels followed by zero columns up to a multiple of 16 (a 2-channel
input is taken densely, taps x 2), then the whole row zero-padded to the
packed matrix's rows; the product with the packed weights, plus the packed
bias, cut to the N real output channels.
"""

import torch
import torch.nn.functional as F

BK = 16


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


def conv(parts, w, b, ky, kx, n):
    cols = []
    for tap in range(ky * kx):
        dy, dx = tap // kx - ky // 2, tap % kx - kx // 2
        for p in parts:
            s = shift(p, dy, dx)
            c = p.shape[-1]
            if c != 2:
                s = F.pad(s, (0, -(-c // BK) * BK - c))
            cols.append(s)
    a = torch.cat(cols, dim=-1)
    a = F.pad(a, (0, w.shape[0] - a.shape[-1]))
    return (a @ w + b)[..., :n]


def motion(flow, corr, packed):
    """csrc/motion_fwd.cu's phases on ``motion_cuda.pack_weights``."""
    wc1, bc1, wc2, bc2, wf1, bf1, wf2, bf2, wo, bo = packed
    c1 = torch.relu(conv([corr], wc1, bc1, 1, 1, 256))
    cor = torch.relu(conv([c1], wc2, bc2, 3, 3, 192))
    f1 = torch.relu(conv([flow], wf1, bf1, 7, 7, 128))
    flo = torch.relu(conv([f1], wf2, bf2, 3, 3, 64))
    out = torch.relu(conv([torch.cat([cor, flo], -1)], wo, bo, 3, 3, 126))
    return torch.cat([out, flow], dim=-1)


def gru(h, xs, packed):
    """csrc/sepconv_gru.cu's phases on ``gru_cuda.pack_weights``, x given
    as parts."""
    c = h.shape[-1]
    for half, (ky, kx) in enumerate(((1, 5), (5, 1))):
        w_zr, b_zr, w_q, b_q = packed[4 * half:4 * half + 4]
        zr = torch.sigmoid(conv([h, *xs], w_zr, b_zr, ky, kx, 2 * c))
        z, r = zr[..., :c], zr[..., c:]
        q = torch.tanh(conv([r * h, *xs], w_q, b_q, ky, kx, c))
        h = (1 - z) * h + z * q
    return h


def flow_head(h, packed):
    """csrc/update_step.cu's flow-head phases on ``step_cuda.pack_flow_head``."""
    w1, b1, w2, b2 = packed
    x = torch.relu(conv([h], w1, b1, 3, 3, w1.shape[1]))
    return conv([x], w2, b2, 3, 3, 2)
