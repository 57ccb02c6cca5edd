"""Warm-start flow propagation for video sequences, a copy of
``raft_tpu/utils/warm_start.py`` (numpy and scipy only: the port imports
nothing of the JAX package).

Reference semantics: ``core/utils/utils.py:26-54`` (``forward_interpolate``) —
forward-splat the previous frame's flow to initialize the next pair's
refinement, filling holes with nearest-neighbor interpolation. This is a
host-side (numpy) preprocessing step; the result is fed to the model as
``flow_init``.

The reference implements the splat with ``scipy.interpolate.griddata``,
which builds a KD-tree over every valid source point per call — a
multi-second host cost per frame at Sintel resolution, unusable in the
serving hot path (one call per warm frame per stream). This module
replaces it with a vectorized numpy scatter: round each advected
coordinate to its nearest grid cell, scatter-average collisions with
``np.add.at``, and fill the remaining holes by iterative 8-neighbor
dilation (both flow channels always take the same source cells, like
nearest-neighbor fill). Sub-millisecond at stream resolutions, no scipy
import on the serving path. The JAX package keeps the ``griddata``
implementation as its oracle; the port keeps only this function.
"""

from __future__ import annotations

import numpy as np


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """Forward-propagate a flow field along itself (vectorized numpy).

    Args:
      flow: ``(H, W, 2)`` numpy flow, last axis (x, y).
    Returns:
      ``(H, W, 2)`` propagated float32 flow.
    """
    flow = np.asarray(flow, np.float32)
    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    y0, x0 = np.meshgrid(np.arange(ht), np.arange(wd), indexing="ij")

    x1 = x0 + dx
    y1 = y0 + dy

    # Same validity rule as the reference (strict: the open interval, so
    # a zero-flow border pixel counts as leaving the frame and becomes a
    # hole, filled from its neighbors below).
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    if not valid.any():
        return np.zeros((ht, wd, 2), np.float32)

    xi = np.clip(np.rint(x1[valid]).astype(np.int64), 0, wd - 1)
    yi = np.clip(np.rint(y1[valid]).astype(np.int64), 0, ht - 1)
    lin = yi * wd + xi
    acc = np.zeros((ht * wd, 2), np.float64)
    cnt = np.zeros(ht * wd, np.int64)
    np.add.at(acc[:, 0], lin, dx[valid])
    np.add.at(acc[:, 1], lin, dy[valid])
    np.add.at(cnt, lin, 1)

    filled = cnt > 0
    vals = np.zeros((ht * wd, 2), np.float32)
    vals[filled] = (acc[filled] / cnt[filled, None]).astype(np.float32)
    return _fill_holes(vals.reshape(ht, wd, 2),
                       filled.reshape(ht, wd))


def _fill_holes(vals: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Fill ``~mask`` cells by iterative joint 8-neighbor dilation: each
    hole takes the mean of its already-filled neighbors, both channels
    from the same cells. Converges in at most max(H, W) rounds (every
    round grows the filled region by one ring; ``forward_interpolate``
    guarantees at least one filled cell)."""
    h, w, _ = vals.shape
    vals = vals.copy()
    for _ in range(max(h, w)):
        if mask.all():
            break
        pv = np.zeros((h + 2, w + 2, 2), vals.dtype)
        pm = np.zeros((h + 2, w + 2), bool)
        pv[1:-1, 1:-1] = vals
        pm[1:-1, 1:-1] = mask
        acc = np.zeros_like(vals)
        cnt = np.zeros((h, w), np.int32)
        for oy in (0, 1, 2):
            for ox in (0, 1, 2):
                if oy == 1 and ox == 1:
                    continue
                m = pm[oy:oy + h, ox:ox + w]
                acc += np.where(m[..., None], pv[oy:oy + h, ox:ox + w], 0)
                cnt += m
        grow = (~mask) & (cnt > 0)
        vals[grow] = acc[grow] / cnt[grow, None]
        mask = mask | grow
    return vals

