"""Multi-scale deformable attention on the card: the wrappers of the CUDA
kernels ``csrc/msda_fwd.cu`` and ``csrc/msda_bwd.cu`` (counterparts of
``raft_tpu/ops/msda_pallas.py``'s ``_fwd_kernel`` and ``_bwd_kernel``) and
their autograd Function.

``ms_deform_attn_cuda`` and ``ms_deform_attn_bwd_cuda`` check their
operands, launch their kernel on the current stream and count the launch in
``launches`` and ``bwd_launches``; they raise on inputs the kernels do not
take and on a failed launch. ``MSDeformAttnFn`` makes the pair a node of the
autograd graph, with gradients to the value, the sampling locations and the
attention weights. The plain versions are ``ops/msda.py``'s
``ms_deform_attn_plain`` and ``ms_deform_attn_bwd_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.build import check_operand

launches = 0          # forward kernel launches (ms_deform_attn_cuda)
bwd_launches = 0      # backward kernel launches (ms_deform_attn_bwd_cuda)
MAX_LEVELS = 16
CHANNELS = (4, 8, 16)     # head widths D the kernel takes

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int)] * 3
                 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _check(value, spatial_shapes, sampling_locations, attention_weights):
    """Raise unless the kernels take these operands; returns the levels'
    heights, widths and first rows of S."""
    if value.device.type != "cuda":
        raise ValueError(f"the MSDA kernel needs CUDA tensors, got "
                         f"{value.device}")
    if value.dim() != 4 or sampling_locations.dim() != 6:
        raise ValueError(f"value must be (B, S, M, D) and the locations "
                         f"(B, Lq, M, L, P, 2), got {tuple(value.shape)} and "
                         f"{tuple(sampling_locations.shape)}")
    B, S, M, D = value.shape
    L = len(spatial_shapes)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels, got {L}")
    if D not in CHANNELS:
        raise ValueError(f"head width D must be one of {CHANNELS}, got {D}")
    hs = [int(h) for h, _ in spatial_shapes]
    ws = [int(w) for _, w in spatial_shapes]
    if S != sum(h * w for h, w in zip(hs, ws)):
        raise ValueError(f"value has S={S}, the levels {list(spatial_shapes)}"
                         f" sum to {sum(h * w for h, w in zip(hs, ws))}")
    Lq, P = sampling_locations.shape[1], sampling_locations.shape[4]
    dev = value.device
    check_operand("value", value, (B, S, M, D), dev)
    check_operand("sampling_locations", sampling_locations,
                  (B, Lq, M, L, P, 2), dev)
    check_operand("attention_weights", attention_weights, (B, Lq, M, L, P),
                  dev)
    starts = [sum(h * w for h, w in zip(hs[:i], ws[:i])) for i in range(L)]
    ints = ctypes.c_int * L
    return ints(*hs), ints(*ws), ints(*starts)


def ms_deform_attn_cuda(value: torch.Tensor, spatial_shapes,
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/msda_fwd.cu``: ``value`` (B, S, M, D), locations
    (B, Lq, M, L, P, 2), weights (B, Lq, M, L, P), float32, contiguous, on
    one CUDA device; D in ``CHANNELS``; 1 to ``MAX_LEVELS`` levels whose
    sizes sum to S. Returns (B, Lq, M*D) float32."""
    global launches
    levels = _check(value, spatial_shapes, sampling_locations,
                    attention_weights)
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    dev = value.device
    out = torch.empty(B, Lq, M * D, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.bind("msda_fwd", "raft_msda_fwd", _ARGTYPES)(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), out.data_ptr(), *levels, L, B, S,
            Lq, M, D, P, stream)
    if err:
        raise RuntimeError(f"msda_fwd kernel failed: cudaError {err}")
    launches += 1
    return out


def ms_deform_attn_bwd_cuda(value: torch.Tensor, spatial_shapes,
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor,
                            grad: torch.Tensor):
    """Launch ``csrc/msda_bwd.cu``: the gradients of
    ``ms_deform_attn_cuda`` for the cotangent ``grad`` (B, Lq, M*D).
    Operands as for the forward, ``grad`` float32 and contiguous too.
    Returns ``(d_value (B, S, M, D), d_loc (B, Lq, M, L, P, 2), d_aw
    (B, Lq, M, L, P))``, float32. ``d_value`` is summed with atomics, so
    it is not bit-reproducible from run to run."""
    global bwd_launches
    levels = _check(value, spatial_shapes, sampling_locations,
                    attention_weights)
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    dev = value.device
    check_operand("grad", grad, (B, Lq, M * D), dev)
    d_value = torch.zeros_like(value)
    d_loc = torch.empty_like(sampling_locations)
    d_aw = torch.empty_like(attention_weights)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.bind("msda_bwd", "raft_msda_bwd", _BWD_ARGTYPES)(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), grad.data_ptr(), d_value.data_ptr(),
            d_loc.data_ptr(), d_aw.data_ptr(), *levels, L, B, S, Lq, M, D, P,
            stream)
    if err:
        raise RuntimeError(f"msda_bwd kernel failed: cudaError {err}")
    bwd_launches += 1
    return d_value, d_loc, d_aw


class MSDeformAttnFn(torch.autograd.Function):
    """The sampling core as an autograd node: ``forward(fwd, bwd, value,
    spatial_shapes, sampling_locations, attention_weights)`` returns
    ``fwd(value, spatial_shapes, sampling_locations, attention_weights)``
    and its backward ``bwd(value, spatial_shapes, sampling_locations,
    attention_weights, grad)``: the kernels on the card
    (``ms_deform_attn_cuda``, ``ms_deform_attn_bwd_cuda``); the tests pass
    the plain versions. It saves only its inputs."""

    @staticmethod
    def forward(ctx, fwd, bwd, value, spatial_shapes, sampling_locations,
                attention_weights):
        ctx.bwd, ctx.spatial_shapes = bwd, spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return fwd(value, spatial_shapes, sampling_locations,
                   attention_weights)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        value, loc, aw = ctx.saved_tensors
        d_value, d_loc, d_aw = ctx.bwd(value, ctx.spatial_shapes, loc, aw,
                                       grad.contiguous())
        return None, None, d_value, None, d_loc, d_aw
