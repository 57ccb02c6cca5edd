"""The bf16 forward's block (``csrc/corr_fwd_bf16.cu``), emulated on the CPU.

A block takes one 8 x 8 query tile and walks ``kLevelsPerBlock`` pyramid
levels (one by default: the grid is one block a (tile, level), two an SM;
a block over several runs alone on its SM). It stages the tile's F1 once
in bfloat16. At each level the tile's box (the bounding box of its
queries' (2r+2)^2 integer neighbours, clipped to the level; a centre that
is not finite or lies 1e8 px out adds nothing) takes the shared path if it
holds at most ``budget`` pixels: the box in chunks of ``kChunk`` pixels
over the whole C, each chunk's dots F1 . chunk^T from bfloat16 operands
with float32 sums, each dot that is one of its query's neighbours into S
(D x D a query, stale between levels); then the level's windows (the four
bilinear weights, then 1/sqrt(C), in float32, a neighbour off the level
read as zero) into O. A larger box takes the warp path: a query's
neighbours dotted one by one. O holds the block's windows at the output's
alignment modulo 16 bytes, in units with a shift each: a tile row of
whole rows when the block takes every level (one contiguous run of the
output), else a query's levels; the block's threads write each unit's run
in 16-byte words, single elements at each end.

The emulation follows that block by block, with S filled with NaN where
the kernel would hold stale dots, the byte offsets of every run checked,
and every output element written exactly once, and holds it against the
plain lookup, ``windowed_correlation_fused_plain(mxu_dtype="bfloat16")``,
at chip_smoke's bars (1 bf16 eps of max(1, max|plain|) for bfloat16
windows, ``TOL`` for float32 ones). Its constants are read from the
kernel's source. The ``cuda`` tests force each path of the kernel on the
card against the plain version; they skip without one:

    python -m pytest --noconftest tests/test_torch_corr_fwd_bf16_tile.py -m cuda
"""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from raft_tpu_torch.models import corr
from raft_tpu_torch.ops import corr_cuda

TILE = 8
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "raft_tpu_torch", "csrc", "corr_fwd_bf16.cu")
H, W = 13, 21     # ragged tiles (2 x 3), an odd width: runs off 16-byte words
H100_SMS = 132
SMEM_LIMIT = 232448           # bytes a block may take on an H100
TILE_QUERIES_BYTES = 1816     # sizeof(TileQueries): corr_tile.cuh


def _constant(name):
    with open(SOURCE) as f:
        text = f.read()
    value = re.search(rf"constexpr int {name} = (\w+);", text).group(1)
    return int(value)


LEVELS_PER_BLOCK = _constant("kLevelsPerBlock")
CHUNK = _constant("kChunk")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads while this file runs: the suite's xdist workers
    share one CPU (as tests/test_torch_corr.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def round16(n):
    return -(-n // 16) * 16


def units(r, esize, levels=LEVELS_PER_BLOCK):
    """O's unit bytes (Layout): a tile row of whole rows, a query's levels."""
    ww = (2 * r + 1) ** 2
    return (round16(TILE * levels * ww * esize) + 16, round16(levels * ww * esize) + 16)


def layout(r, c, esize, levels=LEVELS_PER_BLOCK):
    """The kernel's Layout<R, C, M> for blocks over ``levels`` levels:
    (ring stages, dynamic bytes, blocks an SM). S, then the ring (F1 staged
    in its last stage first), O over the ring in a block over one level
    (two an SM), apart in one over more (one an SM)."""
    blocks = 2 if levels == 1 else 1
    d, ld = 2 * r + 2, c + 8
    dyn_max = ((232448 if blocks == 1 else 233472 // 2 - 1024)
               - levels * TILE_QUERIES_BYTES)
    row_unit, query_unit = units(r, esize, levels)
    o = max(TILE * row_unit, TILE * TILE * query_unit)
    over = levels == 1
    fixed = TILE * TILE * d * d * 4 + (0 if over else o)
    stage = CHUNK * ld * 2
    n = 4
    while n > 2 and fixed + max(n * stage, o if over else 0) > dyn_max:
        n -= 1
    return n, fixed + max(n * stage, o if over else 0), blocks


def level_queries(coords, b, ty, tx, lvl, r, h2, w2, rescale):
    """load_levels at one level, over the tile's 64 slots: the global
    query (-1 past the image), x0, y0, dx, dy, near, and the box (x_lo,
    y_lo, width, pixels), or None if it is empty."""
    d = 2 * r + 2
    _, h, w, _ = coords.shape
    s = torch.arange(TILE * TILE)
    y, x = ty * TILE + s // TILE, tx * TILE + s % TILE
    valid = (y < h) & (x < w)
    q = torch.where(valid, (b * h + y) * w + x, -1)
    c = coords[b, y.clamp(max=h - 1), x.clamp(max=w - 1)]
    c = c / (2.0 ** lvl if rescale else 1.0)
    f = torch.floor(c)
    near = valid & (f.abs() < 1e8).all(-1)
    first = torch.where(near[:, None], f, 0.0).long() - r
    x0, y0 = torch.where(near, first[:, 0], 0), torch.where(near, first[:, 1], 0)
    dxy = torch.where(near[:, None], c - f, 0.0)
    xl, xh = x0.clamp(min=0), (x0 + d - 1).clamp(max=w2 - 1)
    yl, yh = y0.clamp(min=0), (y0 + d - 1).clamp(max=h2 - 1)
    keep = near & (xl <= xh) & (yl <= yh)
    box = None
    if keep.any():
        lo = (int(xl[keep].min()), int(yl[keep].min()))
        bw = int(xh[keep].max()) - lo[0] + 1
        box = (*lo, bw, bw * (int(yh[keep].max()) - lo[1] + 1))
    return q, x0, y0, dxy[:, 0], dxy[:, 1], near, box


def windows(x0, y0, dx, dy, near, dots, r, h2, w2):
    """window() for every slot (rows of dots, D x D a slot): the four
    bilinear weights in float32, in the kernel's order, a neighbour off the
    level read as zero (its stale dot never read); zero where not near."""
    d, win = 2 * r + 2, 2 * r + 1
    i = torch.arange(win).repeat_interleave(win)   # window k = i * win + j
    j = torch.arange(win).repeat(win)
    total = torch.zeros(dots.shape[0], win * win)
    for wt, (a, b) in (((1 - dx) * (1 - dy), (0, 0)), (dx * (1 - dy), (1, 0)),
                       ((1 - dx) * dy, (0, 1)), (dx * dy, (1, 1))):
        x, y = x0[:, None] + i + a, y0[:, None] + j + b
        ok = (x >= 0) & (x < w2) & (y >= 0) & (y < h2)
        v = dots.gather(1, ((j + b) * d + i + a).expand(dots.shape[0], -1))
        total = total + wt[:, None] * torch.where(ok, v, 0.0)
    return torch.where(near[:, None], total, 0.0)


def emulate(f1, pyramid, coords, r, budget, rescale=True, levels=LEVELS_PER_BLOCK):
    """The kernel's output, block by block, with the byte offsets of its O
    units and runs checked and every output element written exactly once.
    Returns (output, path counts)."""
    bsz, h, w, c = f1.shape
    dt = f1.dtype
    esize = 2 if dt == torch.bfloat16 else 4
    nlev, d, ww = len(pyramid), 2 * r + 2, (2 * r + 1) ** 2
    row_elems = nlev * ww
    f1b = torch.cat([f1.bfloat16().float().reshape(-1, c), torch.full((1, c), float("nan"))])
    maps = [p.bfloat16().float() for p in pyramid]
    inv_scale = 1.0 / torch.tensor(corr_cuda._scale_div(c, True))   # float32, as the kernel
    out = torch.zeros(bsz * h * w * row_elems, dtype=dt)
    written = torch.zeros(out.numel(), dtype=torch.int32)
    row_unit, query_unit = units(r, esize, levels)
    slots = torch.arange(TILE * TILE)
    paths = [0, 0]
    for b in range(bsz):
        for ty in range(-(-h // TILE)):
            for tx in range(-(-w // TILE)):
                first = (b * h + ty * TILE) * w + tx * TILE
                for l_lo in range(0, nlev, levels):
                    nl = min(levels, nlev - l_lo)
                    e_lo = l_lo * ww
                    # O in units: a tile row of whole rows, or a query's
                    # levels; unit u at u * unit bytes + its shift
                    whole = nl == nlev
                    unit = slots // TILE if whole else slots
                    lead = unit * TILE if whole else unit        # the unit's first slot
                    out_first = ((first + (lead // TILE) * w + lead % TILE) * row_elems
                                 + e_lo)
                    o_at = (unit * (row_unit if whole else query_unit)
                            + out_first * esize % 16
                            + ((slots % TILE) * row_elems * esize if whole else 0))
                    assert bool((o_at % esize == 0).all())
                    o_at = o_at // esize                    # element (slot, 0)
                    O = torch.zeros(max(TILE * row_unit, TILE * TILE * query_unit) // esize,
                                    dtype=dt)
                    S = torch.full((TILE * TILE, d * d), float("nan"))   # stale
                    warp_levels = []

                    def put(li, q, win):
                        at = (o_at[:, None] + li * ww + torch.arange(ww))[q >= 0]
                        O[at.reshape(-1)] = win[q >= 0].reshape(-1)

                    for li in range(nl):
                        lvl = l_lo + li
                        f2 = maps[lvl][b]
                        h2, w2 = f2.shape[:2]
                        q, x0, y0, dx, dy, near, box = level_queries(
                            coords, b, ty, tx, lvl, r, h2, w2, rescale)
                        nb = 0 if box is None else box[3]
                        shared = nb <= budget
                        paths[0 if shared else 1] += 1
                        if not shared:
                            warp_levels.append((li, (q, x0, y0, dx, dy, near), f2))
                            continue
                        a = f1b[q]                           # F1, staged once
                        for n0 in range(0, nb, CHUNK):
                            pix = torch.arange(n0, min(n0 + CHUNK, nb))
                            px, py = box[0] + pix % box[2], box[1] + pix // box[2]
                            dots = a @ f2[py, px].t()    # bfloat16 values, float32 sums
                            i, j = px[None, :] - x0[:, None], py[None, :] - y0[:, None]
                            hit = near[:, None] & (i >= 0) & (i < d) & (j >= 0) & (j < d)
                            qs, ps = hit.nonzero(as_tuple=True)
                            S[qs, j[qs, ps] * d + i[qs, ps]] = dots[qs, ps]
                        put(li, q, (windows(x0, y0, dx, dy, near, S, r, h2, w2)
                                    * inv_scale).to(dt))
                    for li, (q, x0, y0, dx, dy, near), f2 in warp_levels:
                        h2, w2 = f2.shape[:2]
                        xs = x0[:, None] + torch.arange(d)           # (slot, i)
                        ys = y0[:, None] + torch.arange(d)           # (slot, j)
                        ok = (near[:, None, None] & ((ys >= 0) & (ys < h2))[:, :, None]
                              & ((xs >= 0) & (xs < w2))[:, None, :]).reshape(-1, d * d)
                        nbr = f2[ys.clamp(0, h2 - 1)[:, :, None], xs.clamp(0, w2 - 1)[:, None, :]]
                        dots = torch.einsum("snc,sc->sn", nbr.reshape(-1, d * d, c), f1b[q])
                        S = torch.where(ok, dots, S)          # the stale rest never read
                        put(li, q, (windows(x0, y0, dx, dy, near, S, r, h2, w2)
                                    * inv_scale).to(dt))
                    # the runs: a tile row of whole rows, or a query's levels,
                    # in 16-byte words, single elements at each end
                    for run in range(TILE if whole else TILE * TILE):
                        qi = run * TILE if whole else run
                        y, x = ty * TILE + qi // TILE, tx * TILE + qi % TILE
                        if y >= h or x >= w:
                            continue
                        n = min(TILE, w - tx * TILE) * row_elems if whole else nl * ww
                        g, s0 = int(out_first[qi]), int(o_at[qi])
                        assert (g - s0) * esize % 16 == 0, "a run and its copy share words"
                        head = min(n, (16 - g * esize % 16) % 16 // esize)
                        words = (n - head) * esize // 16
                        assert (g + head) * esize % 16 == 0
                        assert (n - head - words * 16 // esize) * esize < 16
                        out[g:g + n] = O[s0:s0 + n]
                        written[g:g + n] += 1
    assert bool((written == 1).all()), "every window written exactly once"
    return out.reshape(bsz, h, w, row_elems), paths


def inputs(c, flow, seed, b=1, h=H, w=W, max_px=None):
    """float32 maps and coordinates: a smooth flow (coherent) or per-pixel
    draws (incoherent), one NaN centre and two far ones."""
    rng = np.random.default_rng(seed)
    f1 = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=torch.float32)
    f2 = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=torch.float32)
    pyramid = corr.build_feature_pyramid(f2, 4)
    max_px = max_px or (3.0 if flow == "coherent" else 12.0)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    move = (chip_smoke.smooth_flow(rng, b, h, w, max_px) if flow == "coherent"
            else rng.uniform(-max_px, max_px, (b, h, w, 2)))
    coords = np.stack([xs, ys], -1)[None] + move
    coords[0, 1, 2] = np.nan
    coords[0, 5, 17] = (3e9, -4.0)
    coords[0, 12, 0] = (7.0, -2e8)
    return f1, pyramid, torch.tensor(coords, dtype=torch.float32)


def bar(want, maps):
    top = float(want.float().abs().max())
    return (chip_smoke.BF16_EPS if maps == torch.bfloat16 else chip_smoke.TOL) * max(1.0, top)


@pytest.mark.parametrize("c, r, maps, flow", [
    (256, 4, torch.bfloat16, "coherent"),
    (256, 4, torch.float32, "incoherent"),
    (128, 3, torch.bfloat16, "incoherent"),
    (128, 3, torch.float32, "coherent"),
])
def test_block_matches_plain_on_both_paths(c, r, maps, flow):
    """The block's schedule, both routes' rounding, ragged tiles, NaN and
    far centres: the default budget, and each path forced."""
    f1, pyramid, coords = inputs(c, flow, seed=c + r)
    f1, pyramid = f1.to(maps), tuple(p.to(maps) for p in pyramid)
    want = corr_cuda.windowed_correlation_fused_plain(
        f1, pyramid, coords, r, mxu_dtype="bfloat16", out_dtype=maps)
    tiles = -(-H // TILE) * -(-W // TILE)
    for budget, path in ((corr_cuda.TILE_BUDGET, None), (0, 1), (10 ** 8, 0)):
        got, paths = emulate(f1, pyramid, coords, r, budget)
        assert got.dtype == maps
        assert not torch.isnan(got.float()).any()
        d = float((got.float() - want.float()).abs().max())
        assert d <= bar(want, maps), (budget, d)
        assert sum(paths) == tiles * len(pyramid)
        if path is not None:
            # an empty box is "shared" at budget 0 too (nb <= budget)
            assert paths[path] >= (tiles * len(pyramid) if path == 0 else 1)


def test_grids_agree_and_runs_tile_the_output():
    """One block a tile over all levels, a (tile, two levels) and a (tile,
    level): the same windows; float32 windows of a chunk-spanning box."""
    f1, pyramid, coords = inputs(128, "coherent", seed=7, h=17, w=19, max_px=2.0)
    outs = [emulate(f1, pyramid, coords, 4, 10 ** 8, levels=n)[0] for n in (4, 2, 1)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    want = corr_cuda.windowed_correlation_fused_plain(
        f1, pyramid, coords, 4, mxu_dtype="bfloat16")
    assert float((outs[0] - want).abs().max()) <= bar(want, torch.float32)


def test_rescale_off_and_fewer_levels():
    """The sparse family's lookup form (every level at the level-0 centre)
    and a two-level pyramid, bfloat16 windows."""
    f1, pyramid, coords = inputs(256, "coherent", seed=3)
    f1, pyramid = f1.bfloat16(), tuple(p.bfloat16() for p in pyramid[:2])
    want = corr_cuda.windowed_correlation_fused_plain(
        f1, pyramid, coords, 3, rescale=False, mxu_dtype="bfloat16",
        out_dtype=torch.bfloat16)
    got, _ = emulate(f1, pyramid, coords, 3, corr_cuda.TILE_BUDGET, rescale=False)
    assert float((got.float() - want.float()).abs().max()) <= bar(want, torch.bfloat16)


def test_layout_fits_the_sm_and_the_grid():
    """Every instantiation's shared memory (F1, S, the ring, O and the
    static TileQueries) fits its blocks on an H100's SM (228 KB, 1 KB a
    block, 227 KB at most) with a ring of at least two stages, for each
    grid: blocks over 1 level (two an SM, O over the ring), 2 and 4 (one an
    SM). The default grid's blocks at Sintel B=1 and the chairs shape (B=8,
    46x62) fill 132 SMs twice over."""
    for levels in (1, 2, 4):
        for r in (3, 4):
            for c in (128, 256):
                for esize in (2, 4):
                    stages, dyn, blocks = layout(r, c, esize, levels)
                    assert 2 <= stages <= 4
                    static = levels * TILE_QUERIES_BYTES
                    assert dyn + static <= min(SMEM_LIMIT, 233472 // blocks - 1024)
    assert layout(4, 256, 2, 1)[::2] == (2, 2) and layout(3, 128, 4, 1)[::2] == (4, 2)
    assert layout(4, 256, 2, 4)[:1] == (4,) and layout(4, 256, 4, 4)[:1] == (3,)
    sintel = 1 * -(-55 // TILE) * -(-128 // TILE)
    chairs = 8 * -(-46 // TILE) * -(-62 // TILE)
    assert (sintel, chairs) == (112, 384)
    groups = -(-4 // LEVELS_PER_BLOCK)
    slots = H100_SMS * layout(4, 256, 2)[2]
    assert sintel * groups > slots and chairs * groups > 2 * slots


@pytest.mark.cuda
@pytest.mark.parametrize("path, budget", [("warp", 0), ("shared", 10 ** 8)])
def test_kernel_matches_plain_on_card(cuda, monkeypatch, path, budget):
    """The kernel with each path forced at the Sintel shape (C=256 r=4)
    and RAFT-small's (C=128 r=3), both routes, against the plain version
    at chip_smoke's bars, and through the default grid's path counts."""
    monkeypatch.setattr(corr_cuda, "TILE_BUDGET", budget)
    for c, r, flow in ((256, 4, "incoherent"), (128, 3, "coherent")):
        f1, pyramid, coords = inputs(c, flow, seed=c, h=55, w=128, max_px=8.0)
        for maps in (torch.bfloat16, torch.float32):
            f1m = f1.to(cuda, maps)
            pyr = tuple(p.to(cuda, maps) for p in pyramid)
            corr_cuda.reset_path_counts()
            before = corr_cuda.bf16_launches
            with torch.inference_mode():
                got = corr_cuda.windowed_correlation_bf16_cuda(
                    f1m, pyr, coords.to(cuda), r, out_dtype=maps)
                want = corr_cuda.windowed_correlation_fused_plain(
                    f1m, pyr, coords.to(cuda), r, mxu_dtype="bfloat16", out_dtype=maps)
            assert corr_cuda.bf16_launches == before + 1 and got.dtype == maps
            d = float((got.float() - want.float()).abs().max())
            assert d <= bar(want, maps), (c, r, maps, d)
            counts = corr_cuda.path_counts()["fwd"]
            assert sum(counts) == 112 * 4      # one a (tile, level), whatever the grid
            assert counts[{"warp": 1, "shared": 0}[path]] > counts[{"warp": 0, "shared": 1}[path]]
