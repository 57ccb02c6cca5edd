"""Sampling and grid numerics, the counterpart of ``raft_tpu/ops/sampling.py``.

Coordinate grids, bilinear lookup with zero padding in pixel units (the
semantics of torch ``grid_sample(align_corners=True, padding_mode='zeros')``
after RAFT's pixel-to-[-1, 1] normalisation, written here as a gather so a
width-1 level cannot divide by zero), the windowed lookup of the all-pairs
pyramid, align-corners resizing, and RAFT's convex 8x upsampling.

Layout: images and features are NHWC; flow fields are ``(B, H, W, 2)``
with the last axis ordered (x, y).
"""

from __future__ import annotations

import torch


def coords_grid(batch: int, ht: int, wd: int, device=None) -> torch.Tensor:
    """Pixel coordinate grid ``(batch, ht, wd, 2)``, last axis (x, y)."""
    y = torch.arange(ht, dtype=torch.float32, device=device)
    x = torch.arange(wd, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)[None].expand(batch, ht, wd, 2)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (B, H, W, C) at pixel coordinates ``coords``
    (B, ..., 2), last axis (x, y). A sample at an integer point returns that
    pixel exactly; corners outside the image contribute zero. Returns
    (B, ..., C)."""
    B, H, W, C = img.shape
    lead = coords.shape[1:-1]
    x = coords[..., 0].reshape(B, -1)
    y = coords[..., 1].reshape(B, -1)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx1 = x - x0f
    wy1 = y - y0f
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    x0 = x0f.long()
    y0 = y0f.long()
    flat = img.reshape(B, H * W, C)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return vals * valid[..., None].to(img.dtype)

    out = (gather(y0, x0) * (wx0 * wy0)[..., None]
           + gather(y0, x0 + 1) * (wx1 * wy0)[..., None]
           + gather(y0 + 1, x0) * (wx0 * wy1)[..., None]
           + gather(y0 + 1, x0 + 1) * (wx1 * wy1)[..., None])
    return out.reshape(B, *lead, C)


def interp_axis_weights(t: torch.Tensor, n: int) -> torch.Tensor:
    """Dense bilinear weights along one axis: ``w[..., x] = relu(1 - |t -
    x|)`` for x in [0, n), the weight a zero-padded align-corners sample at
    ``t`` places on source index x."""
    x = torch.arange(n, dtype=torch.float32, device=t.device)
    return torch.clamp(1.0 - torch.abs(t[..., None] - x), min=0.0)


def windowed_bilinear_matmul(img: torch.Tensor, cx: torch.Tensor,
                             cy: torch.Tensor, radius: int) -> torch.Tensor:
    """Windowed bilinear lookup into ``img`` (Q, H, W): ``out[q, i, j]`` is
    the sample of ``img[q]`` at ``(cx[q] + i - r, cy[q] + j - r)`` (the first
    window axis moves x), as two batched matmuls with separable weights.
    Returns (Q, 2r+1, 2r+1)."""
    Q, H, W = img.shape
    off = torch.arange(-radius, radius + 1, dtype=torch.float32,
                       device=img.device)
    wx = interp_axis_weights(cx[:, None] + off, W)      # (Q, win, W)
    wy = interp_axis_weights(cy[:, None] + off, H)      # (Q, win, H)
    tmp = torch.bmm(wx, img.float().transpose(1, 2))    # (Q, win, H)
    return torch.bmm(tmp, wy.transpose(1, 2))           # (Q, win, win)


def resize_bilinear_align_corners(x: torch.Tensor, new_ht: int,
                                  new_wd: int) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` with align_corners=True semantics."""
    B, H, W, C = x.shape
    sy = (H - 1) / max(new_ht - 1, 1)
    sx = (W - 1) / max(new_wd - 1, 1)
    dev = x.device
    wy = interp_axis_weights(
        torch.arange(new_ht, dtype=torch.float32, device=dev) * sy, H)
    wx = interp_axis_weights(
        torch.arange(new_wd, dtype=torch.float32, device=dev) * sx, W)
    out = torch.einsum("oh,bhwc->bowc", wy, x.float())
    return torch.einsum("pw,bowc->bopc", wx, out)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x bilinear upsampling of ``flow`` (B, H, W, 2), values scaled by 8."""
    B, H, W, _ = flow.shape
    return 8.0 * resize_bilinear_align_corners(flow, 8 * H, 8 * W)


def _neighborhood3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 9, C): the zero-padded 3x3 neighbourhood in
    row-major (dy, dx) order, the order of ``F.unfold(kernel=3, padding=1)``."""
    H, W = x.shape[1], x.shape[2]
    p = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([p[:, dy:dy + H, dx:dx + W]
                        for dy in range(3) for dx in range(3)], dim=3)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination 8x upsampling: each fine pixel is a softmax-
    weighted combination of the 3x3 coarse neighbourhood of ``8 * flow``.

    ``flow`` (B, H, W, 2); ``mask`` (B, H, W, 576) logits whose channels
    factor as (9, 8, 8) = (neighbour, sub_y, sub_x). Returns (B, 8H, 8W, 2).
    """
    B, H, W, _ = flow.shape
    m = torch.softmax(mask.reshape(B, H, W, 9, 64), dim=3)
    nb = _neighborhood3x3(8.0 * flow)                        # (B,H,W,9,2)
    up = torch.einsum("bhwks,bhwkc->bhwsc", m, nb)            # (B,H,W,64,2)
    up = up.reshape(B, H, W, 8, 8, 2).permute(0, 1, 3, 2, 4, 5)
    return up.reshape(B, 8 * H, 8 * W, 2)


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool over axes 1 and 2 of a (N, H, W, ...)
    tensor, flooring odd sizes (VALID): 55 -> 27 -> 13 -> 6."""
    h2, w2 = x.shape[1] // 2, x.shape[2] // 2
    x = x[:, :2 * h2, :2 * w2]
    x = x.reshape(x.shape[0], h2, 2, w2, 2, *x.shape[3:])
    return x.sum(dim=(2, 4)) * 0.25


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Clamped logit, the working space of the sparse model's iterative
    flow refinement."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def linear_resize_weights(n_in: int, n_out: int,
                          device=None) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(..., "linear")`` along one
    axis (JAX's ``scale_and_translate`` with antialiasing): a triangle
    kernel at half-pixel centres, widened by the shrink factor when
    shrinking, normalised per output, zero for an output whose centre lies
    outside the input."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = torch.clamp(1.0 - (sample[None] - src[:, None]).abs() / kernel_scale,
                    min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None], w, torch.zeros_like(w))


def resize_linear(x: torch.Tensor, shape) -> torch.Tensor:
    """What ``jax.image.resize(x, shape, method="linear")`` computes: each
    axis whose size changes is contracted with ``linear_resize_weights``
    (antialiased when it shrinks, which no ``F.interpolate`` mode
    reproduces). Returns float32 of ``shape``."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} axes, "
                         f"x has {x.ndim}")
    out = x.float()
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = linear_resize_weights(n_in, n_out, x.device)
        out = torch.tensordot(out.movedim(axis, -1), w, dims=1).movedim(-1,
                                                                       axis)
    return out
