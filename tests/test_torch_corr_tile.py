"""The windowed-correlation kernels' shared query tile (``csrc/corr_tile.cuh``,
``csrc/corr_fwd.cu``, ``csrc/corr_bwd.cu``), emulated on the CPU.

A kernel block takes a tile of 8 x 8 queries of one image at one level.
The tile's *box* is the bounding box of its queries' (2r+2)^2 integer
neighbours at that level, each query's neighbours clipped to the level
first; a centre that fails the ``near`` test (far or NaN) adds nothing.
A box of at most ``budget`` pixels takes the shared path:

- forward: ``S = F1_tile . F2_box^T`` in 3xTF32, then each query gathers
  its neighbours' entries of S and applies the four bilinear weights;
- backward: the dense ``G`` (tile x box) of the neighbours' cotangent
  coefficients, ``df1_tile = G . F2_box`` and ``df2_box = G^T . F1_tile``.

Each k8 step of a product takes its large term (hi x hi) into a fresh
tensor-core sum, added to the total in float32, and chains its small terms
in a second sum (``mma3``). The emulation rounds each sum to nearest; the
card's tensor cores round toward zero, whose bias in a long chain the
fresh sums keep out of the result (``tests/test_torch_train.py``'s
parameters after AdamW's first update hold that on the card).

A larger box takes the warp path (per query dots in float32). The
emulation below follows both in torch ops and holds them against the plain
lookup, ``windowed_correlation_fused_plain``, and its autograd at
``chip_smoke.TOL`` and ``chip_smoke.CORR_BWD_REL``, the bars of the kernels
on the card. The ``cuda`` tests force each path of the kernels on the card
against the plain versions; they skip without one:

    python -m pytest --noconftest tests/test_torch_corr_tile.py -m cuda
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from raft_tpu_torch.models import corr
from raft_tpu_torch.ops import conv_pack, corr_cuda

TILE = 8
STEP = 8        # the MMA's k
H, W = 13, 20   # ragged tiles: 2 x 3 of them, the last row and column cut


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


def _trunc(x):
    """The top 11 significand bits of x: what the tensor core reads of a
    float32 register given as a TF32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = conv_pack.tf32_rna(x)
    return hi, _trunc(x - hi)


def _operands(a, b):
    """a and b split hi and lo, K padded with zeros to a multiple of 8, as
    the kernels' staged tiles are."""
    pad = -a.shape[1] % STEP
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    return (*_split(a), *_split(b))


def mma3(a, b):
    """a (M, K) . b (K, N) as the tile's 3xTF32 (corr_tile.cuh,
    mma_3xtf32): per k8 step, the 8 products a_hi b_hi (exact in float64)
    into a fresh float32 sum added to ``big``, the products a_lo b_hi and
    then a_hi b_lo added to ``small``; the result is big + small."""
    ah, al, bh, bl = _operands(a, b)
    big = torch.zeros(a.shape[0], b.shape[1])
    small = torch.zeros_like(big)
    for s in range(0, ah.shape[1], STEP):
        k = slice(s, s + STEP)
        big = big + (ah[:, k].double() @ bh[k].double()).float()
        for x, y in ((al, bh), (ah, bl)):
            small = (small.double() + x[:, k].double() @ y[k].double()).float()
    return big + small


def centres(coords, lvl, radius, rescale):
    """The kernels' per-query rule at one level, as numpy arrays: (dx, dy)
    (float32), the first integer neighbour x0 and y0, and ``near``."""
    c = (coords / (2 ** lvl) if rescale else coords).numpy()
    f = np.floor(c)
    with np.errstate(invalid="ignore"):
        near = (np.abs(f) < 1e8).all(-1)
    first = np.where(near[..., None], f - radius, 0).astype(np.int64)
    return c - f, first[..., 0], first[..., 1], near


def tiles(b, h, w):
    """(image, [(slot, y, x) of its queries]) of every tile."""
    for bi in range(b):
        for ty in range(0, h, TILE):
            for tx in range(0, w, TILE):
                yield bi, [((y - ty) * TILE + x - tx, y, x)
                           for y in range(ty, min(ty + TILE, h))
                           for x in range(tx, min(tx + TILE, w))]


def box(queries, bi, x0, y0, near, h2, w2, d):
    """The tile's box (x_lo, y_lo, width, height), or None if empty."""
    ys = np.array([y for _, y, _ in queries])
    xs = np.array([x for _, _, x in queries])
    qx, qy = x0[bi, ys, xs], y0[bi, ys, xs]
    xl, xh = np.maximum(qx, 0), np.minimum(qx + d - 1, w2 - 1)
    yl, yh = np.maximum(qy, 0), np.minimum(qy + d - 1, h2 - 1)
    keep = near[bi, ys, xs] & (xl <= xh) & (yl <= yh)
    if not keep.any():
        return None
    lo = (int(xl[keep].min()), int(yl[keep].min()))
    return (*lo, int(xh[keep].max()) - lo[0] + 1,
            int(yh[keep].max()) - lo[1] + 1)


def neighbour_index(bx, x0, y0, d):
    """(D, D) [j, i]: the box pixel of neighbour (i, j), -1 outside it."""
    x = x0 + np.arange(d) - bx[0]
    y = y0 + np.arange(d) - bx[1]
    inside = ((x >= 0) & (x < bx[2]))[None, :] & ((y >= 0) & (y < bx[3]))[:, None]
    return torch.from_numpy(np.where(inside, y[:, None] * bx[2] + x[None, :], -1))


def bilinear_weights(dxy):
    dx, dy = float(dxy[0]), float(dxy[1])
    t = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return (t(1.0 - dx) * t(1.0 - dy), t(dx) * t(1.0 - dy),
            t(1.0 - dx) * t(dy), t(dx) * t(dy))


def tile_forward(f1, pyramid, coords, radius, rescale, budget):
    """The kernel's forward, block by block. Returns (out, blocks on the
    shared path, blocks on the warp path)."""
    b, h, w, c = f1.shape
    d, win = 2 * radius + 2, 2 * radius + 1
    scale_div = torch.tensor(corr_cuda._scale_div(c, True))
    out = torch.zeros(b, h, w, len(pyramid) * win * win)
    paths = [0, 0]
    for lvl, f2 in enumerate(pyramid):
        h2, w2 = f2.shape[1:3]
        dxy, x0, y0, near = centres(coords, lvl, radius, rescale)
        for bi, queries in tiles(b, h, w):
            bx = box(queries, bi, x0, y0, near, h2, w2, d)
            nb = 0 if bx is None else bx[2] * bx[3]
            shared = nb <= budget
            paths[0 if shared else 1] += 1
            if shared and nb:
                f1_tile = torch.zeros(TILE * TILE, c)
                for slot, y, x in queries:
                    f1_tile[slot] = f1[bi, y, x]
                f2_box = f2[bi, bx[1]:bx[1] + bx[3], bx[0]:bx[0] + bx[2]].reshape(nb, c)
                s = mma3(f1_tile, f2_box.t())
            for slot, y, x in queries:
                dots = torch.zeros(d, d)
                if near[bi, y, x] and nb:
                    idx = neighbour_index(bx, x0[bi, y, x], y0[bi, y, x], d)
                    hit = idx >= 0
                    if shared:
                        dots[hit] = s[slot, idx[hit]]
                    else:
                        rows = f2[bi, bx[1]:bx[1] + bx[3], bx[0]:bx[0] + bx[2]].reshape(nb, c)
                        dots[hit] = rows[idx[hit]] @ f1[bi, y, x]
                w00, w10, w01, w11 = bilinear_weights(dxy[bi, y, x])
                # window (i, j) is out[i * win + j]: dots are [y, x]
                v = (w00 * dots[:win, :win] + w10 * dots[:win, 1:]
                     + w01 * dots[1:, :win] + w11 * dots[1:, 1:]).t()
                out[bi, y, x, lvl * win * win:(lvl + 1) * win * win] = (
                    v.reshape(-1) / scale_div)
    return out, paths


def coefficients(g, dxy, radius, inv_scale):
    """(D, D) [j, i]: the cotangent of neighbour (i, j)'s dot, the
    kernel's fold of the window's cotangents g (win * win, i-major)."""
    win = 2 * radius + 1
    gw = g.reshape(win, win).t()    # [j, i]
    w00, w10, w01, w11 = bilinear_weights(dxy)
    c = torch.zeros(win + 1, win + 1)
    c[:win, :win] += w00 * gw
    c[:win, 1:] += w10 * gw
    c[1:, :win] += w01 * gw
    c[1:, 1:] += w11 * gw
    return c * inv_scale


def tile_backward(f1, pyramid, coords, grad, radius, rescale, budget):
    """The kernel's backward, block by block. Returns (df1, df2 levels,
    blocks on the shared path, blocks on the warp path)."""
    b, h, w, c = f1.shape
    d, win = 2 * radius + 2, 2 * radius + 1
    inv_scale = torch.tensor(1.0 / corr_cuda._scale_div(c, True))
    df1 = torch.zeros_like(f1)
    df2s = [torch.zeros_like(f2) for f2 in pyramid]
    paths = [0, 0]
    for lvl, f2 in enumerate(pyramid):
        h2, w2 = f2.shape[1:3]
        dxy, x0, y0, near = centres(coords, lvl, radius, rescale)
        for bi, queries in tiles(b, h, w):
            bx = box(queries, bi, x0, y0, near, h2, w2, d)
            nb = 0 if bx is None else bx[2] * bx[3]
            shared = nb <= budget
            paths[0 if shared else 1] += 1
            if not nb:
                continue
            f2_box = f2[bi, bx[1]:bx[1] + bx[3], bx[0]:bx[0] + bx[2]].reshape(nb, c)
            g_tile = torch.zeros(TILE * TILE, nb)
            f1_tile = torch.zeros(TILE * TILE, c)
            for slot, y, x in queries:
                f1_tile[slot] = f1[bi, y, x]
                if near[bi, y, x]:
                    idx = neighbour_index(bx, x0[bi, y, x], y0[bi, y, x], d)
                    coef = coefficients(
                        grad[bi, y, x, lvl * win * win:(lvl + 1) * win * win],
                        dxy[bi, y, x], radius, inv_scale)
                    g_tile[slot, idx[idx >= 0]] = coef[idx >= 0]
            if shared:
                d1 = mma3(g_tile, f2_box)
                d2 = mma3(g_tile.t().contiguous(), f1_tile)
            else:
                d1 = g_tile @ f2_box
                d2 = g_tile.t() @ f1_tile
            for slot, y, x in queries:
                df1[bi, y, x] += d1[slot]
            df2s[lvl][bi, bx[1]:bx[1] + bx[3], bx[0]:bx[0] + bx[2]] += (
                d2.reshape(bx[3], bx[2], c))
    return df1, df2s, paths


def make_inputs(c, rescale, seed=0):
    """fmap1, the pyramid (4 levels, or the fork lookup's 2) and centres of
    a smooth flow up to 3 px on a 13 x 20 map: windows partly off the
    level at the borders, one centre 40 px off (wholly off every level),
    one NaN centre, and one tile (the first) whose flows scatter up to 9 px
    so that its box at level 0 outgrows the others'."""
    rng = np.random.default_rng(seed)
    f1 = torch.from_numpy(rng.standard_normal((1, H, W, c)).astype(np.float32))
    f2 = torch.from_numpy(rng.standard_normal((1, H, W, c)).astype(np.float32))
    pyramid = corr.build_feature_pyramid(f2, 4 if rescale else 2)
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)[None]
    flow = chip_smoke.smooth_flow(rng, 1, H, W, 3.0)
    flow[0, :TILE, :TILE] = rng.uniform(-9.0, 9.0, (TILE, TILE, 2))
    coords = grid + flow + (0.5 if not rescale else 0.0)
    coords[0, 9, 12] = (12 + 40.0, 9 + 0.25)
    coords[0, 10, 3, 0] = np.nan
    return f1, pyramid, torch.from_numpy(coords.astype(np.float32))


def level0_budget(coords, radius, rescale):
    """A budget between the first tile's box at level 0 and the others':
    the first tile takes the warp path there, the rest the shared one."""
    _, x0, y0, near = centres(coords, 0, radius, rescale)
    d = 2 * radius + 2
    sizes = [bx[2] * bx[3] for bx in (box(q, 0, x0, y0, near, H, W, d)
                                      for _, q in tiles(1, H, W))]
    assert sizes[0] > max(sizes[1:]), sizes
    return max(sizes[1:])


# each width, radius and lookup, and both widths and radii in each lookup
# (C, r, rescale): RAFT-small's lookup is C=128 at r=3
CASES = [(192, 3, True), (256, 4, True), (192, 4, False), (256, 3, False),
         (128, 3, True)]
IDS = [f"C{c}-r{r}-{'raft' if rs else 'fork'}" for c, r, rs in CASES]


@pytest.mark.parametrize("rescale", [True, False], ids=["raft", "fork"])
@pytest.mark.parametrize("radius", [3, 4])
def test_box_holds_every_in_level_neighbour_and_stays_in_the_level(radius,
                                                                   rescale):
    """Brute force over every query of every tile and level: each in-level
    neighbour of a near centre lies in its tile's box, the box lies in the
    level, and a box is empty only if no query has an in-level neighbour."""
    f1, pyramid, coords = make_inputs(16, rescale)
    d = 2 * radius + 2
    for lvl, f2 in enumerate(pyramid):
        h2, w2 = f2.shape[1:3]
        _, x0, y0, near = centres(coords, lvl, radius, rescale)
        for bi, queries in tiles(1, H, W):
            bx = box(queries, bi, x0, y0, near, h2, w2, d)
            hit = np.zeros((h2, w2), bool)
            for _, y, x in queries:
                if near[bi, y, x]:
                    xs = x0[bi, y, x] + np.arange(d)
                    ys = y0[bi, y, x] + np.arange(d)
                    hit[np.ix_(ys[(ys >= 0) & (ys < h2)],
                               xs[(xs >= 0) & (xs < w2)])] = True
            if bx is None:
                assert not hit.any()
                continue
            assert 0 <= bx[0] and bx[0] + bx[2] <= w2
            assert 0 <= bx[1] and bx[1] + bx[3] <= h2
            ys, xs = np.nonzero(hit)
            assert (xs.min(), ys.min(), xs.max() - xs.min() + 1,
                    ys.max() - ys.min() + 1) == bx


@pytest.mark.parametrize("c,radius,rescale", CASES, ids=IDS)
def test_tile_forward_matches_plain_lookup(c, radius, rescale):
    """Both paths together against the plain lookup at chip_smoke.TOL, the
    NaN centre's windows NaN in both, the far one's zero."""
    f1, pyramid, coords = make_inputs(c, rescale)
    budget = level0_budget(coords, radius, rescale)
    got, paths = tile_forward(f1, pyramid, coords, radius, rescale, budget)
    want = corr_cuda.windowed_correlation_fused_plain(f1, pyramid, coords,
                                                      radius, rescale=rescale)
    assert paths[0] > 0 and paths[1] == 1, paths
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[0, 10, 3]).all()
    assert not got[0, 9, 12].any()
    ok = ~torch.isnan(want)
    err = float((got[ok] - want[ok]).abs().max())
    assert err <= chip_smoke.TOL, err


@pytest.mark.parametrize("c,radius,rescale", CASES, ids=IDS)
def test_tile_backward_matches_plain_autograd(c, radius, rescale):
    """Both paths together against autograd through the plain lookup, each
    gradient within chip_smoke.CORR_BWD_REL of its largest entry. A NaN
    centre gives no gradient in the kernels, as a far one: the plain side
    takes the far centre in its place (autograd through a NaN weight would
    spread NaN)."""
    f1, pyramid, coords = make_inputs(c, rescale, seed=1)
    budget = level0_budget(coords, radius, rescale)
    win = 2 * radius + 1
    grad = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, H, W, len(pyramid) * win * win)).astype(np.float32))
    df1, df2s, paths = tile_backward(f1, pyramid, coords, grad, radius,
                                     rescale, budget)
    far = coords.clone()
    far[0, 10, 3, 0] = 1e9
    want1, want2 = corr_cuda.windowed_correlation_bwd_plain(
        f1, pyramid, far, grad, radius, rescale=rescale)
    assert paths[0] > 0 and paths[1] == 1, paths
    for got, want in zip((df1, *df2s), (want1, *want2)):
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= chip_smoke.CORR_BWD_REL, rel


def test_three_tf32_passes_hold_the_bar_at_c512():
    """The widest lookup, C = 512, on features of norm sqrt(C): the
    kernels' 3xTF32 product is within a fiftieth of chip_smoke.TOL of
    float64 after the 1/sqrt(C) scale, as close as a float32 matmul of the
    same operands (1.1e-6 and 1.5e-6); one TF32 pass (hi only) is not
    within the bar (1.1e-3)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((512, 96)).astype(np.float32))
    want = (a.double() @ b.double()) / math.sqrt(512)
    three = float((mma3(a, b).double() / math.sqrt(512) - want).abs().max())
    one = float((conv_pack.tf32_rna(a).double() @ conv_pack.tf32_rna(b).double()
                 / math.sqrt(512) - want).abs().max())
    f32 = float(((a @ b).double() / math.sqrt(512) - want).abs().max())
    assert three <= min(chip_smoke.TOL / 50, f32), (three, f32)
    assert one > chip_smoke.TOL, one


def _card_inputs(cuda, c, rescale, seed):
    f1, pyramid, coords = make_inputs(c, rescale, seed)
    return (f1.to(cuda), tuple(p.to(cuda) for p in pyramid),
            coords.to(cuda).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("budget,path", [(0, 1), (10 ** 8, 0)],
                         ids=["warp", "shared"])
@pytest.mark.parametrize("c,radius,rescale", CASES, ids=IDS)
def test_forced_path_matches_plain_on_card(cuda, monkeypatch, budget, path,
                                           c, radius, rescale):
    """Each path alone (a budget of 0 forces the warp path on every block
    with a non-empty box, a large one the shared path on all) against the
    plain versions on the card."""
    monkeypatch.setattr(corr_cuda, "TILE_BUDGET", budget)
    f1, pyramid, coords = _card_inputs(cuda, c, rescale, 0)
    win = 2 * radius + 1
    g = torch.randn(1, H, W, len(pyramid) * win * win, device=cuda)
    corr_cuda.reset_path_counts()
    got = corr_cuda.windowed_correlation_cuda(f1, pyramid, coords, radius,
                                              rescale=rescale)
    got_d = corr_cuda.windowed_correlation_bwd_cuda(f1, pyramid, coords, g,
                                                    radius, rescale=rescale)
    counts = corr_cuda.path_counts()
    assert counts["fwd"][path] > counts["fwd"][1 - path], counts
    assert counts["bwd"][path] > counts["bwd"][1 - path], counts
    want = corr_cuda.windowed_correlation_fused_plain(f1, pyramid, coords,
                                                      radius, rescale=rescale)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert float((got[ok] - want[ok]).abs().max()) <= chip_smoke.TOL
    far = coords.clone()
    far[0, 10, 3, 0] = 1e9
    want_d = corr_cuda.windowed_correlation_bwd_plain(f1, pyramid, far, g,
                                                      radius, rescale=rescale)
    for a, b in zip((got_d[0], *got_d[1]), (want_d[0], *want_d[1])):
        assert float((a - b).abs().max() / b.abs().max()) <= \
            chip_smoke.CORR_BWD_REL
