"""BasicMotionEncoder: the CUDA kernel and its plain version.

Counterpart of ``raft_tpu/ops/motion_pallas.py``: RAFT-large's five motion
convolutions, each with bias and ReLU,

    cor = convc2(convc1(corr))    1x1 Cc->256, 3x3 256->192
    flo = convf2(convf1(flow))    7x7 2->128,  3x3 128->64
    out = conv([cor | flo])       3x3 256->126

emitted as ``[out (126) | flow (2)]`` with the flow passed through
untouched, in float32. ``flow`` (B, H, W, 2) and ``corr`` (B, H, W, Cc) are
NHWC, as is the output (B, H, W, 128). ``convs`` are the five ``(weight,
bias)`` pairs in torch layout, ordered (convc1, convc2, convf1, convf2,
conv).

``motion_encoder`` is the entry point: a tensor on the CPU goes to the
plain ``F.conv2d`` version, a CUDA tensor to the kernel in
``csrc/motion_fwd.cu`` (one launch, counted in ``launches``), which takes
the weights packed once by ``pack_weights``, through
``motion_encoder_autograd``, whose backward recomputes through the plain
version (the JAX ``_motion_bwd``).

The kernel's bf16 form (``motion_encoder_cuda`` on bfloat16 corr and
flow, the JAX kernel at ``dtype=bfloat16``) takes the weights packed by
``pack_weights_bf16`` and returns bfloat16, the flow channels the given
bfloat16 flow bit for bit; it rounds where the JAX kernel rounds
(``csrc/conv_phase.cuh``) and counts its launches in ``bf16_launches``.
Its plain version is ``motion_encoder_plain`` on bfloat16 inputs
(``conv_pack.conv2d``), which is also its backward: the recompute's
bfloat16 convolutions cast the float32 weights in the graph, so the
gradients reach the float32 parameters (the JAX ``_motion_bwd``
recomputes through its bf16 ``reference_motion`` the same way).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.build import check_operand
from raft_tpu_torch.ops.conv_pack import (BN, bf16_block_n, conv2d,
                                          pack_conv, pack_conv_bf16,
                                          packed_rows, round_up)
from raft_tpu_torch.ops.conv_tile import c_plan
from raft_tpu_torch.ops.recompute import RecomputeFn, flatten, pairs

launches = 0          # calls computed by the CUDA kernel
bf16_launches = 0     # calls computed by its bf16 form
# Output widths of convc1, convc2, convf1, convf2 and conv (fixed by
# RAFT-large; csrc/conv_phase.cuh holds the same constants).
WIDTHS = (256, 192, 128, 64, 126)
OUT_CHANNELS = WIDTHS[4] + 2
# Scratch floats a pixel: convc1's and convf1's outputs, [cor | flo].
SCRATCH = WIDTHS[0] + WIDTHS[2] + WIDTHS[1] + WIDTHS[3]
KSIZES = (1, 3, 7, 3, 3)


def motion_encoder_plain(flow: torch.Tensor, corr: torch.Tensor,
                         convs) -> torch.Tensor:
    """The encoder with ``F.conv2d`` (``conv_pack.conv2d``: in float32, or
    in bfloat16 for bfloat16 inputs), NHWC in and out."""
    (wc1, bc1), (wc2, bc2), (wf1, bf1), (wf2, bf2), (wo, bo) = convs
    flo_c = flow.permute(0, 3, 1, 2)
    cor = F.relu(conv2d(corr.permute(0, 3, 1, 2), wc1, bc1))
    cor = F.relu(conv2d(cor, wc2, bc2, padding=1))
    flo = F.relu(conv2d(flo_c, wf1, bf1, padding=3))
    flo = F.relu(conv2d(flo, wf2, bf2, padding=1))
    out = F.relu(conv2d(torch.cat([cor, flo], dim=1), wo, bo, padding=1))
    return torch.cat([out, flo_c], dim=1).permute(0, 2, 3, 1).contiguous()


def pack_weights(convs) -> tuple:
    """The kernel's weight layout (``ops/conv_pack.py``): ``(wc1, bc1,
    wc2, bc2, wf1, bf1, wf2, bf2, wo, bo)``, each K x N matrix transposed
    and split into TF32 hi and lo, ``(2, ldw, rows)``. wc1's K rows are Cc
    rows then zero rows up to a multiple of 16. wf1's are 49 taps x 2 flow
    channels, then 14 zero rows (112). The fusing conv's rows hold, per tap,
    the cor row group (192) and then the flo row group (64), the order of
    its ``[cor | flo]`` input buffer; its 126 columns are padded to 128."""
    return tuple(t for w, b in convs for t in pack_conv(w, b))


def pack_weights_bf16(convs) -> tuple:
    """``pack_weights``' layout for the bf16 forms of this kernel and the
    step kernel (``conv_pack.pack_conv_bf16``): each matrix one bfloat16
    ``(ldw, rows)``, each bias float32 holding bfloat16 values."""
    return tuple(t for w, b in convs for t in pack_conv_bf16(w, b))


def packed_shapes(cc: int, bf16: bool = False) -> list:
    """Shapes of ``pack_weights`` (or ``pack_weights_bf16``) output for Cc
    correlation channels."""
    cins = (cc, WIDTHS[0], 2, WIDTHS[2], WIDTHS[1] + WIDTHS[3])
    shapes = []
    for cin, k, n in zip(cins, KSIZES, WIDTHS):
        ldw = round_up(n, bf16_block_n(n) if bf16 else BN)
        w = (ldw, packed_rows(cin, k * k))
        shapes += [w if bf16 else (2, *w), (ldw,)]
    return shapes


def check_packed(packed, cc: int, device, bf16: bool = False) -> None:
    """Raise unless ``packed`` is ``pack_weights`` (``bf16``:
    ``pack_weights_bf16``) output for Cc = ``cc`` on ``device``."""
    shapes = packed_shapes(cc, bf16)
    if len(packed) != len(shapes):
        raise ValueError(f"expected {len(shapes)} packed motion tensors, "
                         f"got {len(packed)}")
    for n, (t, s) in enumerate(zip(packed, shapes)):
        check_operand(f"motion packed[{n}]", t, s, device,
                      torch.bfloat16 if bf16 and n % 2 == 0 else None)


_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# the bf16 form's: the tile plan (ops/conv_tile.py) before the stream
_ARGTYPES_BF16 = _ARGTYPES[:-1] + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                   ctypes.c_void_p]


def motion_encoder_cuda(flow: torch.Tensor, corr: torch.Tensor,
                        packed) -> torch.Tensor:
    """Launch the kernel of ``csrc/motion_fwd.cu`` on the current stream:
    its float32 form, or its bf16 form when ``corr`` is bfloat16.

    ``flow`` (B, H, W, 2) and ``corr`` (B, H, W, Cc): both float32 or both
    bfloat16, contiguous, on one CUDA device, Cc a multiple of 4.
    ``packed`` is ``pack_weights`` (bfloat16: ``pack_weights_bf16``)
    output on the same device. Returns (B, H, W, 128) in that dtype, the
    JAX output dtype ``promote(compute dtype, flow.dtype)`` with the
    compute dtype corr's; a flow of another dtype than corr's is refused.
    """
    global launches, bf16_launches
    if flow.dtype != corr.dtype:
        raise ValueError(f"the motion kernel takes flow and corr of one "
                         f"dtype, got {flow.dtype} and {corr.dtype}")
    if corr.device.type != "cuda":
        raise ValueError(f"the motion kernel needs CUDA tensors, got "
                         f"{corr.device}")
    bf16 = corr.dtype == torch.bfloat16
    B, H, W, cc = corr.shape
    if cc % 4:
        raise ValueError(f"Cc must be a multiple of 4, got {cc}")
    dev = corr.device
    dt = torch.bfloat16 if bf16 else None
    check_operand("corr", corr, (B, H, W, cc), dev, dt)
    check_operand("flow", flow, (B, H, W, 2), dev, dt)
    check_packed(packed, cc, dev, bf16)
    out = torch.empty(B, H, W, OUT_CHANNELS, device=dev, dtype=corr.dtype)
    scratch = torch.empty(B * H * W * SCRATCH, device=dev, dtype=corr.dtype)
    symbol = "raft_motion_fwd_bf16" if bf16 else "raft_motion_fwd"
    plan = c_plan("motion", cc) if bf16 else ()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.bind("motion_fwd", symbol,
                         _ARGTYPES_BF16 if bf16 else _ARGTYPES)(
            corr.data_ptr(), flow.data_ptr(), *[t.data_ptr() for t in packed],
            scratch.data_ptr(), out.data_ptr(), B, H, W, cc, *plan, stream)
    if err:
        raise RuntimeError(f"{symbol} failed: cudaError {err}")
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return out


def motion_encoder_autograd(flow: torch.Tensor, corr: torch.Tensor, convs,
                            run) -> torch.Tensor:
    """The encoder as a ``RecomputeFn``: ``run(flow, corr)`` in the forward
    (the kernel, or the plain version in a CPU test), the gradients of
    ``motion_encoder_plain`` for flow, corr and the five convolutions'
    weights and biases in the backward."""
    def plain(flow, corr, *w):
        return motion_encoder_plain(flow, corr, pairs(w))

    return RecomputeFn.apply(lambda *a: run(*a[:2]), plain, flow, corr,
                             *flatten(convs))


def motion_encoder(flow: torch.Tensor, corr: torch.Tensor, convs,
                   packed) -> torch.Tensor:
    """The motion encoder: the plain version (``convs``) for a CPU tensor,
    the CUDA kernel (``packed``, from ``pack_weights(convs)``, or
    ``pack_weights_bf16(convs)`` for bfloat16 tensors) for a CUDA tensor,
    differentiable either way."""
    if corr.device.type == "cpu":
        return motion_encoder_plain(flow, corr, convs)
    return motion_encoder_autograd(
        flow, corr, convs, lambda f, c: motion_encoder_cuda(f, c, packed))
