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

The kernel's bf16 form (``sepconv_gru_cuda`` on a bfloat16 ``h``, the JAX
kernel at ``dtype=bfloat16``) takes h and every x part in bfloat16 and the
weights packed by ``pack_weights_bf16``, and returns h' in bfloat16; it
rounds where the JAX kernel rounds (``csrc/conv_phase.cuh``) and counts
its launches in ``bf16_launches``. Its plain version is
``sepconv_gru_plain`` on bfloat16 inputs, which is also its backward, as
for the motion kernel (the JAX ``_gru_bwd`` recomputes through its bf16
``reference_gru``).
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.build import check_operand
from raft_tpu_torch.ops.conv_pack import conv2d, round_bf16, split_tf32
from raft_tpu_torch.ops.conv_tile import c_plan
from raft_tpu_torch.ops.recompute import RecomputeFn, flatten, pairs

launches = 0          # cells computed by the CUDA kernel
bf16_launches = 0     # cells computed by its bf16 form
TAPS = 5


def _step_plain(h, x, conv_z, conv_r, conv_q, padding):
    """One GRU step; in bfloat16 for bfloat16 inputs, each operation then
    rounding its result to bfloat16 as the JAX kernels' compute dtype
    does."""
    hx = torch.cat([h, x], dim=1)
    z = torch.sigmoid(conv2d(hx, *conv_z, padding=padding))
    r = torch.sigmoid(conv2d(hx, *conv_r, padding=padding))
    q = torch.tanh(conv2d(torch.cat([r * h, x], dim=1), *conv_q,
                          padding=padding))
    return (1 - z) * h + z * q


def _parts(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def sepconv_gru_plain(h: torch.Tensor, x, convs) -> torch.Tensor:
    """The cell with ``F.conv2d`` (``conv_pack.conv2d``: in float32, or in
    bfloat16 for bfloat16 inputs, the arithmetic of the kernels' bf16
    forms), NHWC in and out; x parts are concatenated."""
    h = h.permute(0, 3, 1, 2)
    x = torch.cat(_parts(x), dim=-1)
    x = x.permute(0, 3, 1, 2)
    h = _step_plain(h, x, *convs[:3], padding=(0, 2))
    h = _step_plain(h, x, *convs[3:], padding=(2, 0))
    return h.permute(0, 2, 3, 1).contiguous()


def _matrices(convs) -> list:
    """Per half: the merged z and r matrix and the q matrix, transposed
    (N x K, float32), each followed by its bias."""
    def taps(w):                                  # (Cout, Cin, 1|5, 5|1)
        return w.detach().float().reshape(
            w.shape[0], w.shape[1], TAPS).permute(2, 1, 0)

    mats = []
    for (wz, bz), (wr, br), (wq, bq) in (convs[:3], convs[3:]):
        cin, c = wz.shape[1], wz.shape[0]
        w_zr = torch.cat([taps(wz), taps(wr)], dim=2).reshape(TAPS * cin, 2 * c)
        mats += [w_zr.t(), torch.cat([bz, br]),
                 taps(wq).reshape(TAPS * cin, c).t(), bq]
    return mats


def pack_weights(convs) -> tuple:
    """The kernel's weight layout, per half: ``w_zr`` (2, 2C, 5 (C+Cx))
    with the z and r convs merged on the output axis, ``b_zr`` (2C),
    ``w_q`` (2, C, 5 (C+Cx)), ``b_q`` (C). K (the last axis) is tap-major,
    input channels in ``[h | x]`` order, which are also the ``[h | x0 |
    x1]`` rows of the parts form; each K x N matrix is stored transposed
    and split into its TF32 hi and lo parts (``ops/conv_pack.py``). Returns
    the 8 contiguous float32 tensors (w_zr1, b_zr1, w_q1, b_q1, w_zr2,
    b_zr2, w_q2, b_q2)."""
    return tuple((split_tf32(t) if t.dim() == 2 else t).detach().float()
                 .contiguous() for t in _matrices(convs))


def pack_weights_bf16(convs) -> tuple:
    """``pack_weights``' layout for the bf16 forms of this kernel and the
    step kernel: ``w_zr``
    (2C, 5 (C+Cx)) and ``w_q`` (C, 5 (C+Cx)) one bfloat16 matrix each (no
    lo part), the biases float32 holding bfloat16 values."""
    return tuple(t.to(torch.bfloat16).contiguous() if t.dim() == 2
                 else round_bf16(t) for t in _matrices(convs))


def check_packed(packed, k: int, c: int, device, bf16: bool = False) -> None:
    """Raise unless ``packed`` is ``pack_weights`` (``bf16``:
    ``pack_weights_bf16``) output with K = ``k`` rows (5 taps x (C + Cx))
    and C = ``c``, on ``device``."""
    shapes = [(2, 2 * c, k), (2 * c,), (2, c, k), (c,)] * 2
    if bf16:
        shapes = [s[1:] if len(s) == 3 else s for s in shapes]
    if len(packed) != len(shapes):
        raise ValueError(f"expected {len(shapes)} packed GRU tensors, "
                         f"got {len(packed)}")
    for n, (t, s) in enumerate(zip(packed, shapes)):
        check_operand(f"GRU packed[{n}]", t, s, device,
                      torch.bfloat16 if bf16 and n % 2 == 0 else None)


_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# the bf16 form's: the tile plan (ops/conv_tile.py) before the stream
_ARGTYPES_BF16 = _ARGTYPES[:-1] + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                   ctypes.c_void_p]


def sepconv_gru_cuda(h: torch.Tensor, x, packed) -> torch.Tensor:
    """Launch the kernel of ``csrc/sepconv_gru.cu`` on the current stream:
    its float32 form, or its bf16 form when ``h`` is bfloat16.

    ``h`` (B, H, W, C) and ``x``, one tensor (B, H, W, Cx) or two parts:
    all float32 or all bfloat16 (the JAX kernel casts every x part to the
    compute dtype, h's here), contiguous, on one CUDA device, C a multiple
    of 64 and each part's channels of 16. ``packed`` is ``pack_weights``
    (bfloat16: ``pack_weights_bf16``) output on the same device. Returns
    h' (B, H, W, C) in h's dtype.
    """
    global launches, bf16_launches
    xs = _parts(x)
    if any(p.dtype != h.dtype for p in xs):
        raise ValueError(f"the GRU kernel takes h and every x part in one "
                         f"dtype, got h {h.dtype}, x "
                         f"{[p.dtype for p in xs]}")
    if h.device.type != "cuda":
        raise ValueError(f"the GRU kernel needs CUDA tensors, got {h.device}")
    bf16 = h.dtype == torch.bfloat16
    B, H, W, C = h.shape
    cxs = [p.shape[-1] for p in xs]
    if len(xs) > 2 or C % 64 or any(cx % 16 for cx in cxs):
        raise ValueError(f"C must be a multiple of 64 and x one or two parts "
                         f"of a multiple of 16 channels, got C={C}, "
                         f"x parts {cxs}")
    dev = h.device
    dt = torch.bfloat16 if bf16 else None
    check_operand("h", h, (B, H, W, C), dev, dt)
    for n, p in enumerate(xs):
        check_operand(f"x part {n}", p, (B, H, W, cxs[n]), dev, dt)
    check_packed(packed, TAPS * (C + sum(cxs)), C, dev, bf16)
    out = torch.empty_like(h)
    h1, z, rh = (torch.empty_like(h) for _ in range(3))
    x1, cx1 = (xs[1].data_ptr(), cxs[1]) if len(xs) == 2 else (None, 0)
    symbol = "raft_sepconv_gru_bf16" if bf16 else "raft_sepconv_gru"
    plan = c_plan("gru", C, *cxs) if bf16 else ()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.bind("sepconv_gru", symbol,
                         _ARGTYPES_BF16 if bf16 else _ARGTYPES)(
            h.data_ptr(), xs[0].data_ptr(), x1,
            *[t.data_ptr() for t in packed],
            h1.data_ptr(), z.data_ptr(), rh.data_ptr(), out.data_ptr(),
            B, H, W, C, cxs[0], cx1, *plan, stream)
    if err:
        raise RuntimeError(f"{symbol} failed: cudaError {err}")
    if bf16:
        bf16_launches += 1
    else:
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
    the CUDA kernel (``packed``, from ``pack_weights(convs)``, or
    ``pack_weights_bf16(convs)`` for bfloat16 tensors) for a CUDA tensor,
    differentiable either way."""
    if h.device.type == "cpu":
        return sepconv_gru_plain(h, x, convs)
    return sepconv_gru_autograd(h, x, convs,
                                lambda h, x: sepconv_gru_cuda(h, x, packed))
