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

The bf16 forms serve the mixed-precision policy. The forward's
(``windowed_correlation_bf16_cuda``, ``csrc/corr_fwd_bf16.cu``, the TPU
kernel's ``mxu_dtype="bfloat16"``) takes float32 or bfloat16 feature maps,
multiplies bfloat16 operands with float32 sums (a float32 map is rounded
to bfloat16 in the kernel; a bfloat16 one is taken as it is, with either
``mxu_dtype``, since its products are exact in either form) and emits the
windows in the maps' dtype, as the port's lookup asks for them. Its
kernel is its own (the same tile, box and path rule; each block stages
its tile's F1 once and the box in chunks over the whole C,
``tests/test_torch_corr_fwd_bf16_tile.py``). The
backward's (``windowed_correlation_bwd_bf16_cuda``,
``csrc/corr_bwd_bf16.cu``) takes bfloat16 maps with ``mxu_dtype``
"float32" or "bfloat16", or float32 maps with "bfloat16", and a float32 or
bfloat16 cotangent; it sums in float32 and rounds df1 and each df2 once to
the maps' dtype, as the JAX ``_windowed_bwd`` does.
``WindowedCorrelationFn`` joins each form's two under autograd. Their plain versions are
``windowed_correlation_fused_plain`` and ``windowed_correlation_bwd_plain``
with the same dtypes; ``bf16_launches`` and ``bwd_bf16_launches`` count
their launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.build import check_operand
from raft_tpu_torch.ops.sampling import bilinear_sampler

launches = 0          # forward kernel launches (windowed_correlation_cuda)
bwd_launches = 0      # backward kernel launches (windowed_correlation_bwd_cuda)
bf16_launches = 0     # bf16-form launches (windowed_correlation_bf16_cuda)
bwd_bf16_launches = 0  # bf16 backward (windowed_correlation_bwd_bf16_cuda)
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


class _RoundCotangent(torch.autograd.Function):
    """The identity, whose backward rounds the cotangent to bfloat16 (kept
    float32): where the TPU kernel's backward at ``mxu_dtype="bfloat16"``
    casts the cotangent of each dot, ``g2``, before its products."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def _round_maps(x: torch.Tensor) -> torch.Tensor:
    """A feature map rounded to bfloat16 for the products, in its dtype,
    its gradient passed through as it is: the TPU kernel rounds float32
    maps inside and sums their gradients in float32, unrounded."""
    if x.dtype == torch.bfloat16:
        return x
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


def windowed_correlation_dots(fmap1, fmap2, coords, radius: int,
                              scale: bool = True) -> torch.Tensor:
    """One level of the lookup in the kernels' own form: the dot of
    ``fmap1[q]`` with each of the (2r+2)^2 integer neighbours of the
    window's corner (zero off the level, and for a centre that is not
    finite or lies 1e8 px or more out), then each window the four bilinear
    corner weights of those dots. Inputs and result as
    ``windowed_correlation``'s, the maps in float32. Each dot's cotangent
    is rounded to bfloat16 (``_RoundCotangent``): the bf16 forms' plain
    version, which gets the TPU kernel's gradient at
    ``mxu_dtype="bfloat16"`` under autograd."""
    B, H, W, C = fmap1.shape
    h2, w2 = fmap2.shape[1:3]
    d = 2 * radius + 2
    fx, fy = torch.floor(coords[..., 0]), torch.floor(coords[..., 1])
    near = (fx.abs() < 1e8) & (fy.abs() < 1e8)
    dx = torch.where(near, coords[..., 0] - fx, 0.0)[..., None, None]
    dy = torch.where(near, coords[..., 1] - fy, 0.0)[..., None, None]
    steps = torch.arange(d, device=coords.device)
    xs = torch.where(near, fx, 0.0).long()[..., None] - radius + steps
    ys = torch.where(near, fy, 0.0).long()[..., None] - radius + steps
    inside = (((ys >= 0) & (ys < h2))[..., :, None]
              & ((xs >= 0) & (xs < w2))[..., None, :] & near[..., None, None])
    idx = (ys.clamp(0, h2 - 1)[..., :, None] * w2
           + xs.clamp(0, w2 - 1)[..., None, :]).reshape(B, -1)
    nb = torch.gather(fmap2.reshape(B, h2 * w2, C), 1,
                      idx[..., None].expand(-1, -1, C))
    dots = torch.einsum("bqc,bqnc->bqn", fmap1.reshape(B, H * W, C),
                        nb.reshape(B, H * W, d * d, C))
    dots = _RoundCotangent.apply(dots).reshape(B, H, W, d, d) * inside
    # dots[..., j, i]: neighbour (x0 + i, y0 + j); window (a, b) reads its
    # corner (a, b) and the three after it; channels a * (2r+1) + b
    win = ((1 - dx) * (1 - dy) * dots[..., :-1, :-1]
           + dx * (1 - dy) * dots[..., :-1, 1:]
           + (1 - dx) * dy * dots[..., 1:, :-1]
           + dx * dy * dots[..., 1:, 1:])
    win = win.transpose(-1, -2).reshape(B, H, W, (d - 1) ** 2)
    if scale:
        win = win / torch.sqrt(torch.tensor(float(C)))
    return win


def windowed_correlation_fused_plain(fmap1, pyramid2, coords, radius: int,
                                     scale: bool = True,
                                     rescale: bool = True,
                                     mxu_dtype: str = "float32",
                                     out_dtype: torch.dtype = torch.float32
                                     ) -> torch.Tensor:
    """All levels of the lookup, looped in plain PyTorch: level l samples at
    ``coords / 2**l`` (at ``coords`` with ``rescale=False``); a level pooled
    to zero size gives zero windows. Returns (B, H, W, L*(2r+1)^2) in
    ``out_dtype``. ``mxu_dtype="bfloat16"`` rounds the feature maps to
    bfloat16 first (a float32 map's gradient passes that rounding as it is,
    summed in float32 as the TPU kernel's) and takes each level in the
    kernels' form
    (``windowed_correlation_dots``, whose gradient rounds each dot's
    cotangent to bfloat16 as the TPU kernel does); the sums are float32
    either way, so this is the bf16 forms' plain version. The maps are
    cast to float32 once, so that autograd sums df1 over the levels in
    float32 and rounds it once to its dtype, as the JAX ``_windowed_bwd``
    does."""
    level = windowed_correlation
    if mxu_dtype == "bfloat16":
        fmap1 = _round_maps(fmap1)
        pyramid2 = [_round_maps(f2) for f2 in pyramid2]
        level = windowed_correlation_dots
    fmap1 = fmap1.float()
    pyramid2 = [f2.float() for f2 in pyramid2]
    win = 2 * radius + 1
    out = []
    for lvl, f2 in enumerate(pyramid2):
        if f2.shape[1] == 0 or f2.shape[2] == 0:
            B, H, W = coords.shape[:3]
            out.append(torch.zeros(B, H, W, win * win, device=coords.device))
            continue
        lvl_coords = coords / (2 ** lvl) if rescale else coords
        out.append(level(fmap1, f2, lvl_coords, radius, scale))
    return torch.cat(out, dim=-1).to(out_dtype)


def windowed_correlation_bwd_plain(fmap1, pyramid2, coords, grad,
                                   radius: int, scale: bool = True,
                                   rescale: bool = True,
                                   mxu_dtype: str = "float32"):
    """The plain version of the backward kernels: autograd through
    ``windowed_correlation_fused_plain`` (with ``mxu_dtype``, the windows in
    ``grad``'s dtype) for the cotangent ``grad``. Returns ``(df1, (df2_l,
    ...))`` in the maps' dtypes like ``windowed_correlation_bwd_cuda`` and
    ``windowed_correlation_bwd_bf16_cuda`` (the plain lookup would also
    give the coordinates a gradient; the kernels' contract has none)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (fmap1, *pyramid2)]
        out = windowed_correlation_fused_plain(leaves[0], leaves[1:], coords,
                                               radius, scale, rescale,
                                               mxu_dtype, grad.dtype)
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


def _check_lookup(fmap1, pyramid2, coords, radius: int,
                  dtype=torch.float32) -> list:
    """Raise unless the kernels take these operands: C in ``CHANNELS`` or
    under 128, the maps in ``dtype``. Returns the levels' (h, w) pairs
    padded with zeros to ``MAX_LEVELS``."""
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
    check_operand("fmap1", fmap1, (B, H, W, C), dev, dtype)
    check_operand("coords", coords, (B, H, W, 2), dev)
    dims = []
    for lvl, f2 in enumerate(pyramid2):
        check_operand(f"level {lvl}", f2, (B, f2.shape[1], f2.shape[2], C),
                      dev, dtype)
        dims += [f2.shape[1], f2.shape[2]]
    return dims + [0, 0] * (MAX_LEVELS - L)


def _padded(levels) -> list:
    """The levels' tensors padded to ``MAX_LEVELS`` with the first (a
    level of size 0 x 0 is never read)."""
    return list(levels) + [levels[0]] * (MAX_LEVELS - len(levels))


def _scale_div(C: int, scale: bool) -> float:
    """sqrt(C) rounded once to float32, or 1: for every C the kernels take
    the float32 that the plain versions divide by (torch.sqrt)."""
    return ctypes.c_float(math.sqrt(C)).value if scale else 1.0


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


# the bf16 form: the forward's arguments, then in_bf16
_BF16_ARGTYPES = _ARGTYPES[:-2] + [ctypes.c_int] + _ARGTYPES[-2:]
BF16_CHANNELS = (128, 256)   # RAFT-small's and RAFT-large's feature widths


def windowed_correlation_bf16_cuda(fmap1, pyramid2, coords, radius: int,
                                   scale: bool = True, rescale: bool = True,
                                   out_dtype: torch.dtype = torch.float32
                                   ) -> torch.Tensor:
    """Launch the bf16 form, ``csrc/corr_fwd_bf16.cu``, on the current
    stream: bfloat16 products (m16n8k16 tensor-core MMAs on the shared
    path) with float32 sums, the windows emitted in ``out_dtype`` (the
    bilinear weights, then 1/sqrt(C), in float32).

    ``fmap1`` and the levels all float32 (rounded to bfloat16 in the
    kernel) or all bfloat16; ``out_dtype`` the maps' dtype; C in
    ``BF16_CHANNELS``; the rest as ``windowed_correlation_cuda``. Its
    gradient is ``windowed_correlation_bwd_bf16_cuda``
    (``WindowedCorrelationFn``).
    """
    global bf16_launches
    in_bf16 = fmap1.dtype == torch.bfloat16
    if out_dtype != fmap1.dtype:
        raise ValueError(f"the bf16 form emits its windows in the maps' "
                         f"dtype {fmap1.dtype}, got out_dtype {out_dtype}")
    if fmap1.shape[-1] not in BF16_CHANNELS:
        raise ValueError(f"the bf16 form takes C in {BF16_CHANNELS}, got "
                         f"{fmap1.shape[-1]}")
    dims = _check_lookup(fmap1, pyramid2, coords, radius,
                         torch.bfloat16 if in_bf16 else torch.float32)
    B, H, W, C = fmap1.shape
    dev = fmap1.device
    win = 2 * radius + 1
    out = torch.empty(B, H, W, len(pyramid2) * win * win, device=dev,
                      dtype=out_dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counts = _counts(dev)
    with torch.cuda.device(dev):
        err = build.bind("corr_fwd_bf16", "raft_corr_fwd_bf16",
                         _BF16_ARGTYPES)(
            fmap1.data_ptr(), *[f.data_ptr() for f in _padded(pyramid2)],
            *dims, len(pyramid2), coords.data_ptr(), out.data_ptr(), B,
            H, W, C, radius, int(rescale), _scale_div(C, scale), TILE_BUDGET,
            int(in_bf16), counts.data_ptr(), stream)
    if err:
        raise RuntimeError(f"corr_fwd bf16 kernel failed: cudaError {err}")
    bf16_launches += 1
    return out


# the backward entries share one signature: the forward's arguments with
# grad and df1, df2_l, then maps_bf16, grad_bf16, mxu_bf16 (0 for corr_bwd)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                 + [ctypes.c_float] + [ctypes.c_int] * 4
                 + [ctypes.c_void_p] * 2)


def _launch_bwd(lib: str, fmap1, pyramid2, coords, grad, radius: int,
                scale: bool, rescale: bool, mxu_bf16: bool):
    """Launch the backward entry ``raft_<lib>`` on the current stream into
    zeroed float32 gradients; returns ``(df1, (df2_l, ...))`` float32."""
    dims = _check_lookup(fmap1, pyramid2, coords, radius, fmap1.dtype)
    B, H, W, C = fmap1.shape
    dev = fmap1.device
    win = 2 * radius + 1
    check_operand("grad", grad, (B, H, W, len(pyramid2) * win * win), dev,
                  grad.dtype)
    df1 = torch.zeros(fmap1.shape, device=dev)
    df2s = tuple(torch.zeros(f2.shape, device=dev) for f2 in pyramid2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counts = _counts(dev)
    with torch.cuda.device(dev):
        err = build.bind(lib, f"raft_{lib}", _BWD_ARGTYPES)(
            fmap1.data_ptr(), *[f.data_ptr() for f in _padded(pyramid2)],
            *dims, len(pyramid2), coords.data_ptr(), grad.data_ptr(),
            df1.data_ptr(), *[d.data_ptr() for d in _padded(df2s)], B,
            H, W, C, radius, int(rescale), 1.0 / _scale_div(C, scale),
            TILE_BUDGET, int(fmap1.dtype == torch.bfloat16),
            int(grad.dtype == torch.bfloat16), int(mxu_bf16),
            counts.data_ptr() + 16, stream)
    if err:
        raise RuntimeError(f"{lib} kernel failed: cudaError {err}")
    return df1, df2s


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
    if fmap1.dtype != torch.float32 or grad.dtype != torch.float32:
        raise ValueError(f"corr_bwd takes float32 maps and cotangent, got "
                         f"{fmap1.dtype} and {grad.dtype}")
    out = _launch_bwd("corr_bwd", fmap1, pyramid2, coords, grad, radius,
                      scale, rescale, False)
    bwd_launches += 1
    return out


def windowed_correlation_bwd_bf16_cuda(fmap1, pyramid2, coords, grad,
                                       radius: int, scale: bool = True,
                                       rescale: bool = True,
                                       mxu_dtype: str = "bfloat16",
                                       out_dtype: torch.dtype = None):
    """Launch the bf16 backward, ``csrc/corr_bwd_bf16.cu``, on the current
    stream: the gradients of the lookup for the cotangent ``grad`` (B, H,
    W, L*(2r+1)^2), float32 or bfloat16, contiguous.

    ``fmap1`` and the levels all bfloat16 (``mxu_dtype`` "float32": the
    products at float32 precision, the TPU kernel's default in training;
    "bfloat16": the cotangent of each dot rounded to bfloat16 and bfloat16
    products) or all float32 with ``mxu_dtype="bfloat16"`` (rounded to
    bfloat16 in the kernel; float32 maps with float32 products are
    ``windowed_correlation_bwd_cuda``'s); C in ``BF16_CHANNELS``; the rest
    as ``windowed_correlation_bwd_cuda``. Sums in float32 (with atomics: not
    bit-reproducible from run to run) and returns ``(df1, (df2_l, ...))``,
    each rounded once to ``out_dtype``, by default the maps' dtype (float32
    reads the sums as they are); the coordinates get no gradient."""
    global bwd_bf16_launches
    if mxu_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"mxu_dtype must be 'float32' or 'bfloat16', got "
                         f"{mxu_dtype!r}")
    if fmap1.dtype != torch.bfloat16 and mxu_dtype == "float32":
        raise ValueError("float32 maps with float32 products are "
                         "windowed_correlation_bwd_cuda's")
    if fmap1.shape[-1] not in BF16_CHANNELS:
        raise ValueError(f"the bf16 form takes C in {BF16_CHANNELS}, got "
                         f"{fmap1.shape[-1]}")
    if grad.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grad must be float32 or bfloat16, got "
                         f"{grad.dtype}")
    df1, df2s = _launch_bwd("corr_bwd_bf16", fmap1, pyramid2, coords, grad,
                            radius, scale, rescale, mxu_dtype == "bfloat16")
    bwd_bf16_launches += 1
    dt = fmap1.dtype if out_dtype is None else out_dtype
    return df1.to(dt), tuple(d.to(dt) for d in df2s)


class WindowedCorrelationFn(torch.autograd.Function):
    """The lookup on the card, differentiable, with the backward's
    ``mxu_dtype``: float32 maps at "float32" run ``windowed_correlation_cuda``
    and ``windowed_correlation_bwd_cuda``; bfloat16 maps, or "bfloat16",
    the bf16 forms ``windowed_correlation_bf16_cuda`` (windows in the maps'
    dtype) and ``windowed_correlation_bwd_bf16_cuda``. Gradients for fmap1
    and every level in their dtypes, ``None`` for the coordinates. It saves
    only its inputs."""

    @staticmethod
    def forward(ctx, fmap1, coords, radius, scale, rescale, mxu_dtype,
                *pyramid2):
        ctx.radius, ctx.scale, ctx.rescale = radius, scale, rescale
        ctx.mxu_dtype = mxu_dtype
        ctx.save_for_backward(fmap1, coords, *pyramid2)
        if fmap1.dtype == torch.float32 and mxu_dtype == "float32":
            return windowed_correlation_cuda(fmap1, pyramid2, coords, radius,
                                             scale, rescale)
        return windowed_correlation_bf16_cuda(fmap1, pyramid2, coords, radius,
                                              scale, rescale, fmap1.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        fmap1, coords, *pyramid2 = ctx.saved_tensors
        args = (fmap1, pyramid2, coords, grad.contiguous(), ctx.radius,
                ctx.scale, ctx.rescale)
        if fmap1.dtype == torch.float32 and ctx.mxu_dtype == "float32":
            df1, df2s = windowed_correlation_bwd_cuda(*args)
        else:
            df1, df2s = windowed_correlation_bwd_bf16_cuda(*args,
                                                           ctx.mxu_dtype)
        return (df1, None, None, None, None, None, *df2s)


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
                                       "float32", *pyramid2)


def windowed_correlation_bf16(fmap1, pyramid2, coords, radius: int,
                              scale: bool = True, rescale: bool = True,
                              out_dtype: torch.dtype = torch.float32,
                              mxu_dtype: str = "bfloat16") -> torch.Tensor:
    """All pyramid levels of the on-demand lookup in its bf16 forms: the
    plain version for a CPU tensor, ``WindowedCorrelationFn`` for a CUDA
    tensor, differentiable either way; the windows in ``out_dtype``,
    on the card the maps' dtype. The forward's products are bfloat16
    (exact for bfloat16 maps); ``mxu_dtype`` is the backward's: "float32"
    takes bfloat16 maps only."""
    if fmap1.device.type == "cpu":
        return windowed_correlation_fused_plain(fmap1, pyramid2, coords,
                                                radius, scale, rescale,
                                                mxu_dtype, out_dtype)
    if out_dtype != fmap1.dtype:
        raise ValueError(f"the bf16 form emits its windows in the maps' "
                         f"dtype {fmap1.dtype}, got out_dtype {out_dtype}")
    return WindowedCorrelationFn.apply(fmap1, coords, radius, scale, rescale,
                                       mxu_dtype, *pyramid2)
