"""SepConvGRU cell: the CUDA kernel and its plain version.

Counterpart of ``raft_tpu/ops/gru_pallas.py``: the horizontal (1x5) GRU
step, then the vertical (5x1) one, each

    z = sigmoid(convz([h, x]))    r = sigmoid(convr([h, x]))
    q = tanh(convq([r * h, x]))   h' = (1 - z) * h + z * q

with zero padding at the image border, in float32. ``h`` (B, H, W, C) is
NHWC; ``x`` is one NHWC tensor (B, H, W, Cx) or a tuple of two parts, such
as ``(inp, [motion | flow])``, whose channels make up x in order (the
counterpart of ``gru_pallas.split_x_weights``). ``convs`` are the six
``(weight, bias)`` pairs of the module in torch layout, ordered (z1, r1,
q1, z2, r2, q2).

``sepconv_gru`` is the entry point: a tensor on the CPU goes to the plain
``F.conv2d`` version, a CUDA tensor to the kernel in ``csrc/sepconv_gru.cu``
(one launch per cell, counted in ``launches``), which takes the weights
packed once by ``pack_weights`` and reads the x parts where they lie,
through ``sepconv_gru_autograd``, whose backward recomputes through the
plain version (the JAX ``_gru_bwd``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.build import check_operand
from raft_tpu_torch.ops.conv_pack import split_tf32
from raft_tpu_torch.ops.recompute import RecomputeFn, flatten, pairs

launches = 0          # cells computed by the CUDA kernel
TAPS = 5


def _step_plain(h, x, conv_z, conv_r, conv_q, padding):
    hx = torch.cat([h, x], dim=1)
    z = torch.sigmoid(F.conv2d(hx, *conv_z, padding=padding))
    r = torch.sigmoid(F.conv2d(hx, *conv_r, padding=padding))
    q = torch.tanh(F.conv2d(torch.cat([r * h, x], dim=1), *conv_q,
                            padding=padding))
    return (1 - z) * h + z * q


def _parts(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def sepconv_gru_plain(h: torch.Tensor, x, convs) -> torch.Tensor:
    """The cell with ``F.conv2d``, NHWC in and out; x parts are
    concatenated."""
    h = h.permute(0, 3, 1, 2)
    x = torch.cat(_parts(x), dim=-1)
    x = x.permute(0, 3, 1, 2)
    h = _step_plain(h, x, *convs[:3], padding=(0, 2))
    h = _step_plain(h, x, *convs[3:], padding=(2, 0))
    return h.permute(0, 2, 3, 1).contiguous()


def pack_weights(convs) -> tuple:
    """The kernel's weight layout, per half: ``w_zr`` (2, 2C, 5 (C+Cx))
    with the z and r convs merged on the output axis, ``b_zr`` (2C),
    ``w_q`` (2, C, 5 (C+Cx)), ``b_q`` (C). K (the last axis) is tap-major,
    input channels in ``[h | x]`` order, which are also the ``[h | x0 |
    x1]`` rows of the parts form; each K x N matrix is stored transposed
    and split into its TF32 hi and lo parts (``ops/conv_pack.py``). Returns
    the 8 contiguous float32 tensors (w_zr1, b_zr1, w_q1, b_q1, w_zr2,
    b_zr2, w_q2, b_q2)."""
    def taps(w):                                  # (Cout, Cin, 1|5, 5|1)
        return w.detach().float().reshape(
            w.shape[0], w.shape[1], TAPS).permute(2, 1, 0)

    packed = []
    for (wz, bz), (wr, br), (wq, bq) in (convs[:3], convs[3:]):
        cin, c = wz.shape[1], wz.shape[0]
        w_zr = torch.cat([taps(wz), taps(wr)], dim=2).reshape(TAPS * cin, 2 * c)
        packed += [split_tf32(w_zr.t()), torch.cat([bz, br]),
                   split_tf32(taps(wq).reshape(TAPS * cin, c).t()), bq]
    return tuple(t.detach().float().contiguous() for t in packed)


def check_packed(packed, k: int, c: int, device) -> None:
    """Raise unless ``packed`` is ``pack_weights`` output with K = ``k``
    rows (5 taps x (C + Cx)) and C = ``c``, on ``device``."""
    shapes = [(2, 2 * c, k), (2 * c,), (2, c, k), (c,)] * 2
    if len(packed) != len(shapes):
        raise ValueError(f"expected {len(shapes)} packed GRU tensors, "
                         f"got {len(packed)}")
    for n, (t, s) in enumerate(zip(packed, shapes)):
        check_operand(f"GRU packed[{n}]", t, s, device)


_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def sepconv_gru_cuda(h: torch.Tensor, x, packed) -> torch.Tensor:
    """Launch the kernel of ``csrc/sepconv_gru.cu`` on the current stream.

    ``h`` (B, H, W, C) and ``x``, one tensor (B, H, W, Cx) or two parts:
    float32, contiguous, on one CUDA device, C a multiple of 64 and each
    part's channels of 16. ``packed`` is ``pack_weights`` output on the
    same device. Returns h' (B, H, W, C).
    """
    global launches
    if h.device.type != "cuda":
        raise ValueError(f"the GRU kernel needs CUDA tensors, got {h.device}")
    B, H, W, C = h.shape
    xs = _parts(x)
    cxs = [p.shape[-1] for p in xs]
    if len(xs) > 2 or C % 64 or any(cx % 16 for cx in cxs):
        raise ValueError(f"C must be a multiple of 64 and x one or two parts "
                         f"of a multiple of 16 channels, got C={C}, "
                         f"x parts {cxs}")
    dev = h.device
    check_operand("h", h, (B, H, W, C), dev)
    for n, p in enumerate(xs):
        check_operand(f"x part {n}", p, (B, H, W, cxs[n]), dev)
    check_packed(packed, TAPS * (C + sum(cxs)), C, dev)
    out = torch.empty_like(h)
    h1, z, rh = (torch.empty_like(h) for _ in range(3))
    x1, cx1 = (xs[1].data_ptr(), cxs[1]) if len(xs) == 2 else (None, 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.bind("sepconv_gru", "raft_sepconv_gru", _ARGTYPES)(
            h.data_ptr(), xs[0].data_ptr(), x1,
            *[t.data_ptr() for t in packed],
            h1.data_ptr(), z.data_ptr(), rh.data_ptr(), out.data_ptr(),
            B, H, W, C, cxs[0], cx1, stream)
    if err:
        raise RuntimeError(f"sepconv_gru kernel failed: cudaError {err}")
    launches += 1
    return out


def sepconv_gru_autograd(h: torch.Tensor, x, convs, run) -> torch.Tensor:
    """The cell as a ``RecomputeFn``: ``run(h, x)`` in the forward (the
    kernel, or the plain version in a CPU test), the gradients of
    ``sepconv_gru_plain`` for h, every part of x and the six convolutions'
    weights and biases in the backward."""
    xs = _parts(x)

    def plain(h, *rest):
        return sepconv_gru_plain(h, rest[:len(xs)], pairs(rest[len(xs):]))

    return RecomputeFn.apply(lambda h, *rest: run(h, rest[:len(xs)]), plain,
                             h, *xs, *flatten(convs))


def sepconv_gru(h: torch.Tensor, x, convs, packed) -> torch.Tensor:
    """One SepConvGRU cell: the plain version (``convs``) for a CPU tensor,
    the CUDA kernel (``packed``, from ``pack_weights(convs)``) for a CUDA
    tensor, differentiable either way."""
    if h.device.type == "cpu":
        return sepconv_gru_plain(h, x, convs)
    return sepconv_gru_autograd(h, x, convs,
                                lambda h, x: sepconv_gru_cuda(h, x, packed))
