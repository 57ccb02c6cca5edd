"""The deformable-attention kernels' partition of the work
(``csrc/msda_fwd.cu``, ``csrc/msda_bwd.cu``, ``csrc/msda_tile.cuh``),
emulated on the CPU.

- forward: a group of ``msda_cuda.fwd_slots`` slots of D/4 lanes per
  (image, query, head), whose slots take the samples in turn and are
  summed by a shuffle tree;
- backward: a block per band of rows of an (image, head, level) owns that
  band of d_value in shared memory (zeroed, summed into, written once)
  and takes its samples in chunks, whose shares it sorts by pixel; the
  band of a sample's clamped top row writes its d_aw and d_loc.
  ``msda_cuda.plan`` sets the bands and the clusters from the shapes and
  the card's SM count.

The emulations below follow that partition in torch ops, fill the
outputs with NaN where nothing was written, count who owns each sample
and who writes each d_value pixel, and hold the results against
``ms_deform_attn_plain`` and its autograd at ``chip_smoke.TOL`` and
``chip_smoke.CORR_BWD_REL``, the bars of the kernels on the card. The
``cuda`` tests of ``tests/test_torch_msda.py`` force each launch of the
kernels on the card.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from raft_tpu_torch.ops import msda, msda_cuda

SHAPES = [(5, 7), (3, 4)]
LARGE = [(13, 20), (7, 10)]   # a level cut into bands below
SPARSE = [(44, 60), (22, 30), (11, 15)] * 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads while this file runs: the suite's xdist workers
    share one CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_inputs(shapes, d=8, b=2, m=2, lq=37, p=3, seed=0):
    """Seeded inputs with locations over [-0.2, 1.2]; a sample 40 (level
    widths) off, a NaN location, zero weights on one query and whole-pixel
    locations on another."""
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    value = t(rng.standard_normal((b, s, m, d)))
    loc = t(rng.uniform(-0.2, 1.2, (b, lq, m, len(shapes), p, 2)))
    aw = torch.softmax(t(rng.standard_normal((b, lq, m, len(shapes) * p))), -1)
    aw = aw.reshape(b, lq, m, len(shapes), p).contiguous()
    loc[0, 3, 0, 0, 0] = 40.0
    loc[1, 4, 1, 1, 1, 0] = float("nan")
    aw[:, 5] = 0.0
    for lvl, (h, w) in enumerate(shapes):
        loc[:, 6, :, lvl, :, 0] = (torch.arange(p) % w + 0.5) / w
        loc[:, 6, :, lvl, :, 1] = (torch.arange(p) % h + 0.5) / h
    return value, loc, aw


def plain_loc(loc):
    """The kernels' NaN location has no corner: the plain version's
    equivalent is a far one (autograd through NaN would spread it)."""
    out = loc.clone()
    out[torch.isnan(out)] = 40.0
    return out


def locate(loc, h, w):
    """The kernels' ``locate`` on (..., 2) float32 locations: top-left
    corner, fractions, validity and the in-range mask of each corner (in
    the order (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1))."""
    px = loc[..., 0] * w - 0.5
    py = loc[..., 1] * h - 0.5
    fx, fy = torch.floor(px), torch.floor(py)
    valid = (fx.abs() < 1e8) & (fy.abs() < 1e8)
    x0 = torch.where(valid, fx, 0.0).long()
    y0 = torch.where(valid, fy, 0.0).long()
    dx = torch.where(valid, px - fx, 0.0)
    dy = torch.where(valid, py - fy, 0.0)
    xin = [(x0 + i >= 0) & (x0 + i < w) for i in (0, 1)]
    yin = [(y0 + i >= 0) & (y0 + i < h) for i in (0, 1)]
    mask = [valid & yin[c >> 1] & xin[c & 1] for c in range(4)]
    wk = [(1 - dx) * (1 - dy), dx * (1 - dy), (1 - dx) * dy, dx * dy]
    return x0, y0, valid, dx, dy, mask, wk


def starts(shapes):
    return np.cumsum([0] + [h * w for h, w in shapes])[:-1].tolist()


def gather_forward(value, shapes, loc, aw, slots):
    """The forward: a group of ``slots`` slots per (b, q, m), sample e in
    slot e % slots, the slots summed by the kernel's shuffle tree."""
    B, _, M, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    part = torch.zeros(B, Lq, M, slots, D)
    for lvl, ((h, w), s0) in enumerate(zip(shapes, starts(shapes))):
        x0, y0, _, _, _, mask, wk = locate(loc[:, :, :, lvl], h, w)
        v = value[:, s0:s0 + h * w]                           # (B, hw, M, D)
        for pt in range(P):
            e = lvl * P + pt
            for c in range(4):
                pix = ((y0 + (c >> 1)) * w + x0 + (c & 1))[..., pt]
                pix = torch.where(mask[c][..., pt], pix, 0)   # (B, Lq, M)
                vals = torch.gather(v, 1, pix[..., None].expand(B, Lq, M, D))
                coef = torch.where(mask[c][..., pt], (aw[:, :, :, lvl, pt]
                                                      * wk[c][..., pt]), 0.0)
                part[:, :, :, e % slots] += coef[..., None] * vals
    off = 1
    while off < slots:   # __shfl_xor_sync over the slots
        part = part + part[:, :, :, torch.arange(slots) ^ off]
        off *= 2
    assert L * P > 0
    return part[:, :, :, 0].reshape(B, Lq, M * D)


def banded_backward(value, shapes, loc, aw, grad, p):
    """The backward, band by band and chunk by chunk of queries. A chunk's
    d_value shares are summed as the kernel sums them: each in-band corner
    with a non-zero share takes the next slot of its pixel, in a seeded
    order (the shared-memory atomics' order), the touched pixels' counts
    are scanned into slices of a list, each (sample, corner) entry goes to
    its pixel's start plus its slot, and each touched pixel sums its slice.
    Returns the three gradients, how many bands own each sample and how
    many write each d_value pixel."""
    gen = torch.Generator().manual_seed(0)
    B, S, M, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    qc = max(1, min(Lq, msda_cuda.BWD_CHUNK // P))
    nan = float("nan")
    d_value = torch.full_like(value, nan)
    d_loc = torch.full_like(loc, nan)
    d_aw = torch.full_like(aw, nan)
    owned = torch.zeros(B, Lq, M, L, P, dtype=torch.long)
    written = torch.zeros(B, S, M, dtype=torch.long)
    for lvl, ((h, w), s0) in enumerate(zip(shapes, starts(shapes))):
        rows = p["band_rows"][lvl]
        for b in range(B):
            for m in range(M):
                for band in range(-(-h // rows)):
                    y_lo, y_hi = band * rows, min(band * rows + rows, h)
                    npx = (y_hi - y_lo) * w
                    # a cluster's blocks take halves of the chunks into
                    # partial bands, summed in rank order
                    chunks, split = -(-Lq // qc), p["bwd_split"]
                    partial = [torch.zeros(npx, D) for _ in range(split)]
                    for c0 in range(0, Lq, qc):
                        dv = partial[next(r for r in range(split) if r * chunks
                                          // split <= c0 // qc
                                          < (r + 1) * chunks // split)]
                        q = torch.arange(c0, min(c0 + qc, Lq))
                        x0, y0, valid, dx, dy, mask, wk = locate(
                            loc[b, q, m, lvl], h, w)
                        a = aw[b, q, m, lvl]
                        g = grad[b, q, m * D:(m + 1) * D][:, None, :]
                        oy = torch.where(valid, y0.clamp(0, h - 1), 0)
                        owner = oy // rows == band
                        gd, entries = [], []
                        for c in range(4):
                            y, x = y0 + (c >> 1), x0 + (c & 1)
                            read = owner & mask[c]
                            src, pix = value[b, s0:s0 + h * w, m], y * w + x
                            vals = src[torch.where(read, pix, 0)]
                            vals = torch.where(read[..., None], vals, 0.0)
                            gd.append((g * vals).sum(-1))
                            add = (mask[c] & (y >= y_lo) & (y < y_hi)
                                   & (a * wk[c] != 0))
                            entries.append((((y - y_lo) * w + x)[add],
                                            (a * wk[c])[add],
                                            torch.nonzero(add)[:, 0]))
                        # the kernel's sort of the chunk's entries: slots
                        # per pixel and touched pixels in the atomics'
                        # order, their slices, the list, the sums
                        atomics = torch.randperm(sum(len(e[0]) for e in
                                                     entries), generator=gen)
                        pix = torch.cat([e[0] for e in entries])[atomics]
                        coef = torch.cat([e[1] for e in entries])[atomics]
                        qi = torch.cat([e[2] for e in entries])[atomics]
                        slot, touched, seen = [], [], {}
                        for px_i in pix.tolist():
                            slot.append(seen.get(px_i, 0))
                            if px_i not in seen:
                                touched.append(px_i)
                            seen[px_i] = slot[-1] + 1
                        counts = torch.tensor([seen[t] for t in touched],
                                              dtype=torch.long)
                        first = torch.cumsum(counts, 0) - counts
                        at = dict(zip(touched, first.tolist()))
                        order = torch.empty(len(pix), dtype=torch.long)
                        for r, (px_i, k) in enumerate(zip(pix.tolist(), slot)):
                            order[at[px_i] + k] = r
                        for t, st, n in zip(touched, first.tolist(),
                                            counts.tolist()):
                            r = order[st:st + n]
                            assert (pix[r] == t).all()   # the slice is its own
                            dv[t] += (coef[r, None] * g[qi[r], 0]).sum(0)
                        daw = (wk[0] * gd[0] + wk[1] * gd[1] + wk[2] * gd[2]
                               + wk[3] * gd[3])
                        dpx = (1 - dy) * (gd[1] - gd[0]) + dy * (gd[3] - gd[2])
                        dpy = (1 - dx) * (gd[2] - gd[0]) + dx * (gd[3] - gd[1])
                        sel = q[:, None].expand_as(owner)[owner]
                        pts = torch.arange(P).expand_as(owner)[owner]
                        d_aw[b, sel, m, lvl, pts] = daw[owner]
                        d_loc[b, sel, m, lvl, pts] = torch.stack(
                            [a * dpx * w, a * dpy * h], -1)[owner]
                        owned[b, q, m, lvl] += owner.long()
                    rng_px = slice(s0 + y_lo * w, s0 + y_hi * w)
                    d_value[b, rng_px, m] = sum(partial[1:], partial[0])
                    written[b, rng_px, m] += 1
    return (d_value, d_loc, d_aw), owned, written


def _close_bwd(got, want):
    for name, a, b in zip(("value", "locations", "weights"), got, want):
        rel = float((a - b).abs().max() / b.abs().max())
        assert rel <= chip_smoke.CORR_BWD_REL, (name, rel)


# -- the rule ------------------------------------------------------------------

H100_SMS = 132


@pytest.mark.parametrize("label,b,lq,d,split,bwd_bytes", [
    ("decoder", 8, 100, 16, 1, msda_cuda.bwd_block_bytes(2640, 100, 4, 16)),
    ("encoder", 4, 6930, 8, 2, msda_cuda.bwd_block_bytes(2640, 6930, 4, 8))])
def test_plan_at_the_sparse_family_shapes(label, b, lq, d, split, bwd_bytes):
    """The forward gives each (image, query, head) 4 slots of D/4 lanes at
    both shapes; on an H100's 132 SMs the backward holds each level whole
    beside its chunks, and the encoder's 192 bands, fewer than two waves of
    SMs, each take a cluster of two blocks (the decoder's 384 bands of one
    chunk do not)."""
    assert msda_cuda.fwd_slots(d) == 4
    p = msda_cuda.plan(SPARSE, b, lq, 8, 4, d, H100_SMS)
    assert p == {"band_rows": tuple(h for h, _ in SPARSE),
                 "bwd_split": split, "bwd_bytes": bwd_bytes}, (label, p)


def test_plan_forced_paths_and_bands(monkeypatch):
    """FWD_SLOTS sets the forward's slots a group, up to a warp of lanes
    (32 at D=4, 16 at D=8, 8 at D=16); a level too large for shared memory
    (Sintel's 55x128 at D=16, 450 KB) is cut into bands of the most rows
    that fit in the backward; BAND_BYTES sets the band; a launch with fewer
    bands than two waves of SMs, each of 4 chunks or more, splits each over
    2 blocks."""
    for forced, want in ((1, [1, 1, 1]), (2, [2, 2, 2]), (32, [32, 16, 8])):
        monkeypatch.setattr(msda_cuda, "FWD_SLOTS", forced)
        assert [msda_cuda.fwd_slots(d) for d in (4, 8, 16)] == want
    # the encoder's 192 bands of 14 chunks; a sixth of its queries, 3 chunks
    assert msda_cuda.plan(SPARSE, 4, 6930 // 6, 8, 4, 8,
                          H100_SMS)["bwd_split"] == 1
    for sms, split in ((1, 1), (H100_SMS, 2)):
        assert msda_cuda.plan(SPARSE, 4, 6930, 8, 4, 8, sms)["bwd_split"] \
            == split
    big = msda_cuda.plan([(55, 128), (28, 64)], 2, 100, 8, 4, 16, H100_SMS)
    n = big["band_rows"][0]
    assert n < 55 and big["band_rows"][1] == 28, big   # the second fits whole
    assert [msda_cuda.bwd_block_bytes(r * 128, 100, 4, 16)
            <= msda_cuda.SMEM_BYTES for r in (n, n + 1)] == [True, False]
    monkeypatch.setattr(msda_cuda, "BAND_BYTES", msda_cuda.bwd_block_bytes(
        128, 100, 4, 16))
    assert msda_cuda.plan([(55, 128)], 2, 100, 8, 4, 16,
                          H100_SMS)["band_rows"] == (1,)


@pytest.mark.parametrize("d", [4, 8, 16])
def test_plan_stays_in_shared_memory(d):
    """Over level widths up to the widest the backward takes (one row of
    d_value beside a chunk of samples in shared memory) and depths up to
    300 rows, dense and sparse, every plan needs at most SMEM_BYTES (the
    kernel refuses more) and bands of at least one row."""
    for lq in (1, 100, 50000):
        widest = max(w for w in range(1, 4000)
                     if msda_cuda.bwd_block_bytes(w, lq, 4, d)
                     <= msda_cuda.SMEM_BYTES)
        for w in (1, 15, 60, 128, 500, widest):
            for h in (1, 2, 44, 300):
                p = msda_cuda.plan([(h, w), (h // 2 + 1, w // 2 + 1)], 2,
                                   lq, 8, 4, d, H100_SMS)
                assert p["bwd_bytes"] <= msda_cuda.SMEM_BYTES, (w, h, lq, p)
                assert all(r >= 1 for r in p["band_rows"])


# -- the partition against the plain version -----------------------------------

FWD_CASES = {"tiny": (SHAPES, 8, 37), "large-level": (LARGE, 16, 300),
             "D4": (SHAPES, 4, 700)}


@pytest.mark.parametrize("case", list(FWD_CASES))
@pytest.mark.parametrize("width", ["one-slot", "two-slots", "warp"])
def test_gather_forward_matches_plain(case, width):
    """The forward's slots and shuffle tree, with one slot a group, two,
    and a warp (32 / G), Lq off every block, NaN, far, zero-weight and
    whole-pixel samples included."""
    shapes, d, lq = FWD_CASES[case]
    value, loc, aw = make_inputs(shapes, d=d, lq=lq)
    slots = {"one-slot": 1, "two-slots": 2, "warp": 32 // (d // 4)}[width]
    got = gather_forward(value, shapes, loc, aw, slots)
    want = msda.ms_deform_attn_plain(value, shapes, plain_loc(loc), aw)
    assert float((got - want).abs().max()) <= chip_smoke.TOL


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("band", ["whole", "one-row", "two-rows"])
def test_banded_backward_matches_plain(monkeypatch, d, band):
    """Bands of whole levels, of one row and of two (the last one short):
    each sample owned by exactly one band, each d_value pixel written by
    exactly one, each chunk's shares sorted into their pixels' slices, and
    all three gradients within CORR_BWD_REL of the plain version's
    autograd; a zero-weight sample gets d_loc 0 and its d_aw. 2100
    queries of 3 points are four chunks, taken by a cluster of two blocks
    whose partial bands are summed."""
    shapes, lq = LARGE, 2100
    value, loc, aw = make_inputs(shapes, d=d, lq=lq)
    w = max(w for _, w in shapes)
    n = {"whole": None, "one-row": 1, "two-rows": 2}[band]
    if n is not None:   # n rows of d_value beside the chunks
        monkeypatch.setattr(msda_cuda, "BAND_BYTES",
                            msda_cuda.bwd_block_bytes(n * w, lq, 3, d))
    p = msda_cuda.plan(shapes, 2, lq, 2, 3, d, H100_SMS)
    assert p["band_rows"][0] == (n or shapes[0][0]) and p["bwd_split"] == 2
    grad = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, lq, 2 * d)).astype(np.float32))
    got, owned, written = banded_backward(value, shapes, loc, aw, grad, p)
    assert (owned == 1).all() and (written == 1).all()
    assert not got[1][:, 5].any() and got[2][:, 5].abs().sum() > 0
    want = msda.ms_deform_attn_bwd_plain(value, shapes, plain_loc(loc), aw,
                                         grad)
    _close_bwd(got, want)
