"""On-demand windowed correlation: the CUDA kernels and their plain version.

Counterpart of ``raft_tpu/ops/corr_pallas.py``. For each query pixel,
``fmap1[q]`` is dotted with bilinear samples (zero padding) of every pooled
``fmap2`` level in a (2r+1)^2 window around ``coords[q] / 2^l``, divided by
sqrt(C); the levels are concatenated level-major, and window channel
``i*(2r+1)+j`` samples ``(x + i - r, y + j - r)``. ``rescale=False`` samples
every level around ``coords[q]`` itself: the sparse family's lookup, which
dropped the per-level rescale.

``windowed_correlation_fused`` is the entry point: a tensor on the CPU goes
to the plain PyTorch version (differentiated by autograd, coords
included), a CUDA tensor to ``WindowedCorrelationFn``, whose forward is the
kernel in ``csrc/corr_fwd.cu`` and whose backward is the kernel in
``csrc/corr_bwd.cu``, with no gradient for the coordinates (the contract of
the JAX custom VJP ``_windowed_bwd``; RAFT detaches them every iteration,
the sparse family samples at fixed centres). Both kernels take both lookups
and the same widths. Nothing else runs on the card: the wrappers raise on
inputs the kernels do not take.
``launches`` and ``bwd_launches`` count the kernels' launches.

Each kernel block takes a tile of 8 x 8 queries at one level. Where the
tile's windows at that level fit a box of at most ``TILE_BUDGET`` pixels,
the block multiplies the tile by the box on the tensor cores (the shared
path); otherwise it runs one warp per query (the warp path).
``path_counts`` reads how many blocks took each path since
``reset_path_counts``.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.build import check_operand
from raft_tpu_torch.ops.sampling import bilinear_sampler

launches = 0          # forward kernel launches (windowed_correlation_cuda)
bwd_launches = 0      # backward kernel launches (windowed_correlation_bwd_cuda)
MAX_LEVELS = 4
CHANNELS = (128, 192, 256, 384, 512)   # and any C under 128
# The largest box (pixels of one level) a tile takes the shared path with,
# in both kernels; C = 64 and the widths in CHANNELS have that path, another
# C under 128 only the warp path. 1024 was the fastest of 256-2048 for both
# kernels on coherent and incoherent flows (scripts/corr_tile_bench.py).
TILE_BUDGET = 1024
_path_counts: dict = {}   # device -> int64 (4,): fwd shared, warp, bwd shared, warp


def _window_delta(radius: int, device=None) -> torch.Tensor:
    """(2r+1, 2r+1, 2) offsets; the first axis moves x."""
    off = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    ox, oy = torch.meshgrid(off, off, indexing="ij")
    return torch.stack([ox, oy], dim=-1)


def windowed_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor,
                         coords: torch.Tensor, radius: int,
                         scale: bool = True) -> torch.Tensor:
    """One level of the on-demand lookup, in plain PyTorch.

    ``fmap1`` (B, H, W, C) queries; ``fmap2`` (B, H2, W2, C) this level;
    ``coords`` (B, H, W, 2) at this level's scale. Returns
    (B, H, W, (2r+1)^2) float32.
    """
    B, H, W, C = fmap1.shape
    win = 2 * radius + 1
    delta = _window_delta(radius, coords.device).reshape(1, 1, 1, win, win, 2)
    pts = (coords[:, :, :, None, None, :] + delta).reshape(B, H * W * win * win, 2)
    samples = bilinear_sampler(fmap2.float(), pts).reshape(B, H, W, win * win, C)
    corr = torch.einsum("bhwc,bhwkc->bhwk", fmap1.float(), samples)
    if scale:
        corr = corr / torch.sqrt(torch.tensor(float(C)))
    return corr


def windowed_correlation_fused_plain(fmap1, pyramid2, coords, radius: int,
                                     scale: bool = True,
                                     rescale: bool = True) -> torch.Tensor:
    """All levels of the lookup, looped in plain PyTorch: level l samples at
    ``coords / 2**l`` (at ``coords`` with ``rescale=False``); a level pooled
    to zero size gives zero windows. Returns (B, H, W, L*(2r+1)^2)
    float32."""
    win = 2 * radius + 1
    out = []
    for lvl, f2 in enumerate(pyramid2):
        if f2.shape[1] == 0 or f2.shape[2] == 0:
            B, H, W = coords.shape[:3]
            out.append(torch.zeros(B, H, W, win * win, device=coords.device))
            continue
        lvl_coords = coords / (2 ** lvl) if rescale else coords
        out.append(windowed_correlation(fmap1, f2, lvl_coords, radius,
                                        scale))
    return torch.cat(out, dim=-1)


def windowed_correlation_bwd_plain(fmap1, pyramid2, coords, grad,
                                   radius: int, scale: bool = True,
                                   rescale: bool = True):
    """The plain version of the backward kernel: autograd through
    ``windowed_correlation_fused_plain`` for the cotangent ``grad``.
    Returns ``(df1, (df2_l, ...))`` like ``windowed_correlation_bwd_cuda``
    (the plain lookup would also give the coordinates a gradient; the
    kernel's contract has none)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (fmap1, *pyramid2)]
        out = windowed_correlation_fused_plain(leaves[0], leaves[1:], coords,
                                               radius, scale, rescale)
        grads = torch.autograd.grad(out, leaves, grad)
    return grads[0], tuple(grads[1:])


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int]
             + [ctypes.c_void_p] * 2)


def _counts(device) -> torch.Tensor:
    if device not in _path_counts:
        # a normal tensor even under inference mode, so that
        # reset_path_counts may zero it anywhere
        with torch.inference_mode(False):
            _path_counts[device] = torch.zeros(4, dtype=torch.int64,
                                               device=device)
    return _path_counts[device]


def reset_path_counts() -> None:
    """Zero the kernels' path counts on every device."""
    for counts in _path_counts.values():
        counts.zero_()


def path_counts() -> dict:
    """Blocks, one per (tile of queries, level), that took the shared and
    the warp path since ``reset_path_counts``, summed over the devices:
    ``{"fwd": (shared, warp), "bwd": (shared, warp)}``. Synchronises with
    the device."""
    total = [0, 0, 0, 0]
    for counts in _path_counts.values():
        total = [a + int(b) for a, b in zip(total, counts.tolist())]
    return {"fwd": tuple(total[:2]), "bwd": tuple(total[2:])}


def _check_lookup(fmap1, pyramid2, coords, radius: int) -> list:
    """Raise unless the kernels take these operands: C in ``CHANNELS`` or
    under 128. Returns the levels' (h, w) pairs padded with zeros to
    ``MAX_LEVELS``."""
    if fmap1.device.type != "cuda":
        raise ValueError(f"the corr kernels need CUDA tensors, got "
                         f"{fmap1.device}")
    B, H, W, C = fmap1.shape
    L = len(pyramid2)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels, got {L}")
    if not (0 < C < 128 or C in CHANNELS):
        raise ValueError(f"C must be under 128 or one of {CHANNELS}, "
                         f"got {C}")
    if radius not in (3, 4):
        raise ValueError(f"radius must be 3 or 4, got {radius}")
    dev = fmap1.device
    check_operand("fmap1", fmap1, (B, H, W, C), dev)
    check_operand("coords", coords, (B, H, W, 2), dev)
    dims = []
    for lvl, f2 in enumerate(pyramid2):
        check_operand(f"level {lvl}", f2, (B, f2.shape[1], f2.shape[2], C),
                      dev)
        dims += [f2.shape[1], f2.shape[2]]
    return dims + [0, 0] * (MAX_LEVELS - L)


def _padded(levels) -> list:
    """The levels' tensors padded to ``MAX_LEVELS`` with the first (a
    level of size 0 x 0 is never read)."""
    return list(levels) + [levels[0]] * (MAX_LEVELS - len(levels))


def _scale_div(C: int, scale: bool) -> float:
    return float(torch.sqrt(torch.tensor(float(C)))) if scale else 1.0


def windowed_correlation_cuda(fmap1, pyramid2, coords, radius: int,
                              scale: bool = True,
                              rescale: bool = True) -> torch.Tensor:
    """Launch the kernel of ``csrc/corr_fwd.cu`` on the current stream.

    ``fmap1`` (B, H, W, C), each level (B, H_l, W_l, C), ``coords``
    (B, H, W, 2) at level-0 scale: float32, contiguous, on one CUDA device;
    C under 128 or in ``CHANNELS``, radius 3 or 4, 1 to 4 levels.
    Returns
    (B, H, W, L*(2r+1)^2) float32.
    """
    global launches
    dims = _check_lookup(fmap1, pyramid2, coords, radius)
    B, H, W, C = fmap1.shape
    dev = fmap1.device
    win = 2 * radius + 1
    out = torch.empty(B, H, W, len(pyramid2) * win * win, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counts = _counts(dev)
    with torch.cuda.device(dev):
        err = build.bind("corr_fwd", "raft_corr_fwd", _ARGTYPES)(
            fmap1.data_ptr(), *[f.data_ptr() for f in _padded(pyramid2)],
            *dims, len(pyramid2), coords.data_ptr(), out.data_ptr(), B,
            H, W, C, radius, int(rescale), _scale_div(C, scale), TILE_BUDGET,
            counts.data_ptr(), stream)
    if err:
        raise RuntimeError(f"corr_fwd kernel failed: cudaError {err}")
    launches += 1
    return out


_BWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 2)


def windowed_correlation_bwd_cuda(fmap1, pyramid2, coords, grad,
                                  radius: int, scale: bool = True,
                                  rescale: bool = True):
    """Launch the kernel of ``csrc/corr_bwd.cu`` on the current stream: the
    gradients of ``windowed_correlation_cuda`` for the cotangent ``grad``
    (B, H, W, L*(2r+1)^2). Operands as for the forward, ``grad`` float32
    and contiguous too. Returns ``(df1 (B, H, W, C), (df2_l (B, H_l, W_l,
    C), ...))``, float32; the coordinates get no gradient. df1 (over the
    levels) and the df2 levels are summed with atomics, so they are not
    bit-reproducible from run to run."""
    global bwd_launches
    dims = _check_lookup(fmap1, pyramid2, coords, radius)
    B, H, W, C = fmap1.shape
    dev = fmap1.device
    win = 2 * radius + 1
    check_operand("grad", grad, (B, H, W, len(pyramid2) * win * win), dev)
    df1 = torch.zeros_like(fmap1)
    df2s = tuple(torch.zeros_like(f2) for f2 in pyramid2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counts = _counts(dev)
    with torch.cuda.device(dev):
        err = build.bind("corr_bwd", "raft_corr_bwd", _BWD_ARGTYPES)(
            fmap1.data_ptr(), *[f.data_ptr() for f in _padded(pyramid2)],
            *dims, len(pyramid2), coords.data_ptr(), grad.data_ptr(),
            df1.data_ptr(), *[d.data_ptr() for d in _padded(df2s)], B,
            H, W, C, radius, int(rescale), 1.0 / _scale_div(C, scale),
            TILE_BUDGET, counts.data_ptr() + 16, stream)
    if err:
        raise RuntimeError(f"corr_bwd kernel failed: cudaError {err}")
    bwd_launches += 1
    return df1, df2s


class WindowedCorrelationFn(torch.autograd.Function):
    """The lookup on the card, differentiable: forward
    ``windowed_correlation_cuda``, backward ``windowed_correlation_bwd_cuda``
    (gradients for fmap1 and every level, ``None`` for the coordinates).
    It saves only its inputs."""

    @staticmethod
    def forward(ctx, fmap1, coords, radius, scale, rescale, *pyramid2):
        ctx.radius, ctx.scale, ctx.rescale = radius, scale, rescale
        ctx.save_for_backward(fmap1, coords, *pyramid2)
        return windowed_correlation_cuda(fmap1, pyramid2, coords, radius,
                                         scale, rescale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        fmap1, coords, *pyramid2 = ctx.saved_tensors
        df1, df2s = windowed_correlation_bwd_cuda(
            fmap1, pyramid2, coords, grad.contiguous(), ctx.radius,
            ctx.scale, ctx.rescale)
        return (df1, None, None, None, None, *df2s)


def windowed_correlation_fused(fmap1, pyramid2, coords, radius: int,
                               scale: bool = True,
                               rescale: bool = True) -> torch.Tensor:
    """All pyramid levels of the on-demand lookup: the plain version for a
    CPU tensor, the CUDA kernels (``WindowedCorrelationFn``) for a CUDA
    tensor."""
    if fmap1.device.type == "cpu":
        return windowed_correlation_fused_plain(fmap1, pyramid2, coords,
                                                radius, scale, rescale)
    return WindowedCorrelationFn.apply(fmap1, coords, radius, scale, rescale,
                                       *pyramid2)
