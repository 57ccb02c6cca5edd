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

The forward gathers each sample's corners from L2, a group of
``fwd_slots`` slots of D/4 lanes per (image, query, head). The backward's
blocks own their (image, head, level)'s d_value, or bands of its rows
(``BAND_BYTES``), in shared memory; ``plan`` sets the bands and whether a
cluster of two blocks takes each, from the shapes and the card's SM count
(``sm_count``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.build import check_operand

launches = 0          # forward kernel launches (ms_deform_attn_cuda)
bwd_launches = 0      # backward kernel launches (ms_deform_attn_bwd_cuda)
MAX_LEVELS = 16
CHANNELS = (4, 8, 16)     # head widths D the kernel takes
# The dynamic shared memory a block may hold on an H100 (227 KB less 1 KB of
# static shared memory; msda_tile.cuh's kMaxSmem).
SMEM_BYTES = 232448 - 1024
# Slots of D/4 lanes the forward gives each (image, query, head), at most a
# warp. Measured on an H100 (scripts/corr_tile_bench.py msda, PERF.md
# section 6): within 8% of the best of 1-16 slots at the decoder's and the
# encoder's shapes, on incoherent and coherent samples; one slot took up to
# 1.7x the time, a warp up to 1.7x.
FWD_SLOTS = 4
# The shared memory of one backward block: its band of a level's d_value
# and two chunks of samples.
BAND_BYTES = SMEM_BYTES
BWD_CHUNK = 2048      # csrc/msda_bwd.cu's kChunk: samples a chunk

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
             + [ctypes.c_int] * 8 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int)] * 4
                 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def _align4(x: int) -> int:
    return (x + 3) // 4 * 4


def bwd_block_bytes(npx: int, queries: int, points: int,
                    channels: int) -> int:
    """Shared memory of a backward block whose band holds ``npx`` pixels
    (``csrc/msda_bwd.cu``'s ``layout``): the band's d_value, two buffers of
    a chunk's cotangent rows, locations and weights, the pixels' counts,
    and the chunk's touched pixels, slice starts, slots and entries."""
    qc = max(1, min(queries, BWD_CHUNK // points))
    ns = qc * points
    chunk = qc * channels + _align4(2 * ns) + _align4(ns)
    entries, touched = 4 * ns, min(npx, 4 * ns)
    return 4 * (npx * channels + 2 * chunk + _align4(npx) + _align4(touched)
                + _align4(touched // 2 + 1) + 2 * _align4(entries // 2))


def sm_count(device) -> int:
    """The streaming multiprocessors of ``device``'s card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def fwd_slots(channels: int) -> int:
    """The forward's slots of D/4 lanes per (image, query, head)."""
    return min(FWD_SLOTS, 128 // channels)


def plan(spatial_shapes, batch: int, queries: int, heads: int, points: int,
         channels: int, sms: int) -> dict:
    """The backward's launch on a card of ``sms`` SMs: ``band_rows`` (the
    rows of each level a band owns) and ``bwd_split`` (the blocks that take
    a band's chunks together), with the shared memory a block needs
    (``bwd_bytes``), as ``csrc/msda_bwd.cu`` computes it."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return dict(_plan(shapes, batch, queries, heads, points, channels, sms,
                      BAND_BYTES))


@functools.lru_cache(maxsize=256)
def _plan(shapes, batch, queries, heads, points, channels, sms,
          band_bytes) -> dict:
    rows, bwd_bytes = [], 0
    for h, w in shapes:
        n = max(h, 1)
        while n > 1 and bwd_block_bytes(n * w, queries, points,
                                        channels) > band_bytes:
            n -= 1
        rows.append(n)
        bwd_bytes = max(bwd_bytes, bwd_block_bytes(n * w, queries, points,
                                                   channels))
    # A launch with fewer bands than two waves of SMs, each band of 4
    # chunks or more, splits each band over a cluster of two blocks (at the
    # encoder shape 0.88x the time of one block a band, four blocks 1.19x;
    # at 3 chunks two blocks took 1.05x).
    bands = sum(-(-h // n) for (h, _), n in zip(shapes, rows))
    chunks = -(-queries // max(1, min(queries, BWD_CHUNK // points)))
    split = 2 if batch * heads * bands < 2 * sms and chunks >= 4 else 1
    return {"band_rows": tuple(rows), "bwd_split": split,
            "bwd_bytes": bwd_bytes}


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
            Lq, M, D, P, fwd_slots(D), stream)
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
    One row of the widest level must fit a block's shared memory beside a
    chunk of samples. Returns ``(d_value (B, S, M, D), d_loc (B, Lq, M,
    L, P, 2), d_aw (B, Lq, M, L, P))``, float32, each written whole by the
    kernel. ``d_loc`` and ``d_aw`` are bit-reproducible; ``d_value`` is
    not: the order of its sums comes from shared-memory atomics."""
    global bwd_launches
    levels = _check(value, spatial_shapes, sampling_locations,
                    attention_weights)
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    dev = value.device
    check_operand("grad", grad, (B, Lq, M * D), dev)
    widest = max(int(w) for _, w in spatial_shapes)
    if bwd_block_bytes(widest, Lq, P, D) > SMEM_BYTES:
        raise ValueError(f"a level {widest} pixels wide at D={D}: one row of "
                         f"its d_value must fit {SMEM_BYTES} bytes of shared "
                         f"memory")
    d_value = torch.empty_like(value)
    d_loc = torch.empty_like(sampling_locations)
    d_aw = torch.empty_like(attention_weights)
    p = plan(spatial_shapes, B, Lq, M, P, D, sm_count(dev))
    rows = (ctypes.c_int * L)(*p["band_rows"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.bind("msda_bwd", "raft_msda_bwd", _BWD_ARGTYPES)(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), grad.data_ptr(), d_value.data_ptr(),
            d_loc.data_ptr(), d_aw.data_ptr(), *levels, rows, L, B, S, Lq, M,
            D, P, p["bwd_split"], stream)
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
