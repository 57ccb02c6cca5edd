"""Multi-scale deformable attention on the card: the wrapper of the CUDA
kernel ``csrc/msda_fwd.cu`` (counterpart of
``raft_tpu/ops/msda_pallas.py``'s forward) and its autograd Function.

``ms_deform_attn_cuda`` checks its operands, launches the kernel on the
current stream and counts the launch in ``launches``; it raises on inputs the
kernel does not take and on a failed launch. ``MSDeformAttnFn`` makes it a
node of the autograd graph; its backward (the TPU's ``_bwd_kernel``) is not
ported yet and raises rather than give no gradient. The plain version is
``ops/msda.py``'s ``ms_deform_attn_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.build import check_operand

launches = 0          # kernel launches (ms_deform_attn_cuda)
MAX_LEVELS = 16
CHANNELS = (4, 8, 16)     # head widths D the kernel takes

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def ms_deform_attn_cuda(value: torch.Tensor, spatial_shapes,
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/msda_fwd.cu``: ``value`` (B, S, M, D), locations
    (B, Lq, M, L, P, 2), weights (B, Lq, M, L, P), float32, contiguous, on
    one CUDA device; D in ``CHANNELS``; 1 to ``MAX_LEVELS`` levels whose
    sizes sum to S. Returns (B, Lq, M*D) float32."""
    global launches
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
    out = torch.empty(B, Lq, M * D, device=dev)
    ints = ctypes.c_int * L
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.bind("msda_fwd", "raft_msda_fwd", _ARGTYPES)(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), out.data_ptr(), ints(*hs),
            ints(*ws), ints(*starts), L, B, S, Lq, M, D, P, stream)
    if err:
        raise RuntimeError(f"msda_fwd kernel failed: cudaError {err}")
    launches += 1
    return out


class MSDeformAttnFn(torch.autograd.Function):
    """The sampling core as an autograd node: ``forward(fwd, value,
    spatial_shapes, sampling_locations, attention_weights)`` returns
    ``fwd(value, spatial_shapes, sampling_locations, attention_weights)``
    (the kernel on the card; the tests pass the plain version). The
    backward kernel comes with the sparse family's training slice: until
    then ``backward`` raises instead of returning no gradient."""

    @staticmethod
    def forward(ctx, fwd, value, spatial_shapes, sampling_locations,
                attention_weights):
        return fwd(value, spatial_shapes, sampling_locations,
                   attention_weights)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        raise NotImplementedError(
            "the MSDA backward kernel (msda_pallas._bwd_kernel) is not "
            "ported yet: it comes with the sparse family's training slice")
