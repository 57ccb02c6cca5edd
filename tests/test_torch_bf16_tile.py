"""The bf16 conv tile (the bf16 form of ``csrc/conv_phase.cuh``, run by
``update_step_bf16``, ``sepconv_gru_bf16`` and ``motion_fwd_bf16``) and its
plan (``raft_tpu_torch/ops/conv_tile.py``), emulated on the CPU.

A block computes a row segment, 64 pixels of one image row (the pixels
past W masked), x ``block_n`` output channels of one convolution, split
between two consumer warpgroups; K advances in stages of 64 bfloat16
entries. The weights (B) come by a TMA box of 64 K x ``block_n`` rows of
the bf16 pack, zero past K. The activations (A) come by a TMA box too
where every part's channels are a multiple of 64: a stage is 64 channels
of one (tap, part), the box (64 channels, 64 pixels) of the part seen as
(C, W, H, B) at the tap's shift, zero outside the tensor. Otherwise the
producer's 128 threads gather them: thread ``tid`` copies the 16-byte
column ``tid % 8`` (chunk ``a_q`` of the stage, entries ``a_f`` .. ``a_f +
7``) of pixels ``tid // 8 + 16 i``, walking its chunks tap by tap without
a division; each part's copy width is the plan's (16 bytes, two 8-byte
halves for the lookup's 324 channels, 4 bytes a tap pair for the flow).

The emulation below follows that walk in torch ops, and holds:

- the plan against the kernels' rules (``make_program_h``) and the packs'
  shapes, and its tiles: each output (pixel, channel) owned once per
  phase, each tile taken by one block of the grid, at the Sintel shape at
  B=1, 2 and 4, the chairs training shape (B=8, 46x62) and a ragged M;
- each producer thread's chunk walk: the stages cover the packed rows
  once, in the packs' order; a TMA stage lies in one tap and part;
- the parts' routes by their strides, and every copy's width against its
  part's pixel stride and alignment;
- the gathered A stages (TMA boxes or copies), zero-filled at the image
  edge, past W and past K, against ``tests/torch_conv_replay.py``'s
  columns;
- the whole bf16 step computed tile by tile and stage by stage on the bf16
  packs against the plain bf16 versions (8 bf16 eps of max(1,
  max|plain|), and 1e-3 on the 2-norm, which the float32 plain version,
  the control, must exceed), and the packs replayed whole likewise.

The card tests of the three bf16 forms are in ``tests/test_torch_mixed.py``
and ``tests/test_torch_mixed_chain.py``.
"""

import os

import numpy as np
import pytest
import torch

import torch_conv_replay as replay
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.ops import (conv_pack, conv_tile, gru_cuda, motion_cuda,
                                step_cuda)
from raft_tpu_torch.weights import load_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "assets", "golden", "weights.npz")
EPS = 2.0 ** -7           # bfloat16 epsilon
NORM_REL = 1e-3           # tests/test_torch_mixed_chain.py's 2-norm bar
SMS = 132                 # an H100's SMs: one bf16 block an SM
C, CI, CC = 128, 128, 324
# (batch, height, width): the Sintel feature shape at B=1, 2 and 4, the
# chairs training shape at B=8 (62 of a segment's 64 pixels real), and a
# ragged one (17 of 64)
SHAPES = {"sintel B=1": (1, 55, 128), "sintel B=2": (2, 55, 128),
          "sintel B=4": (4, 55, 128), "chairs B=8": (8, 46, 62),
          "ragged": (3, 13, 17)}
KC, BKH, BM = conv_pack.KC, conv_tile.BKH, conv_tile.BM


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads per xdist worker, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _programs():
    return {"motion": conv_tile.motion_phases(CC),
            "gru": conv_tile.gru_phases(C, (CI, C)),
            "step mg": conv_tile.step_phases(C, CI, CC, False),
            "step mgf": conv_tile.step_phases(C, CI, CC, True)}


def _convs():
    """Every distinct tiled conv of the step program at 'mgf', by name."""
    return {c.name: c for phase in _programs()["step mgf"] for c in phase}


# -- the producer's walk --------------------------------------------------------

def _per_tap(conv):
    return sum(-(-c // KC) for c in conv.cins)


def chunk_walk(conv, a_q):
    """``produce_tile``'s walk for a thread of chunk ``a_q`` (0..3): per
    stage, ``(q, tap, w)`` with w the chunk within the tap, or ``(q, None,
    None)`` past the packed rows."""
    per_tap, nchunks = _per_tap(conv), conv.krows // KC
    w_ty = w_tx = 0
    w_c = a_q
    while w_c >= per_tap:
        w_c -= per_tap
        w_tx += 1
        if w_tx == conv.kx:
            w_tx, w_ty = 0, w_ty + 1
    out = []
    for kt in range(-(-conv.krows // BKH)):
        q = kt * (BKH // KC) + a_q
        if q >= nchunks:
            out.append((q, None, None))
            continue
        out.append((q, w_ty * conv.kx + w_tx, w_c))
        w_c += BKH // KC
        while w_c >= per_tap:
            w_c -= per_tap
            w_tx += 1
            if w_tx == conv.kx:
                w_tx, w_ty = 0, w_ty + 1
    return out


def _part_of(conv, w):
    """(part, first channel) of chunk ``w`` within a tap."""
    for p, c in enumerate(conv.cins):
        n = -(-c // KC)
        if w < n:
            return p, w * KC
        w -= n
    raise AssertionError(w)


def segments(b, h, w):
    """The row segments of a (b, h, w) batch in the kernels' order:
    (image row b * h + y, first column x0)."""
    xt = -(-w // BM)
    return [(t // xt, (t % xt) * BM) for t in range(b * h * xt)]


def gather(conv, parts, seg, bhw, plan=None, copies=None):
    """The A operand the producer gathers for row segment ``seg`` (image
    row, x0) over every stage: (64, stages * 64) float32, in the K order of
    the packs; by TMA boxes where the plan says so, else by the producer's
    copies. ``parts`` are the (b, h, w, cin) activations; ``copies``, if a
    list, gets each copy's (part, width, byte offset)."""
    plan = plan or conv_tile.plan_conv(conv)
    b, h, w = bhw
    row, x0 = seg
    y, img = row % h, row // h
    x = x0 + torch.arange(BM)
    out = torch.zeros(BM, plan.stages * BKH)

    def shifted(p, dy, dx, ch):
        """Part p's channels ``ch`` at (y + dy, x + dx) of the segment's
        pixels, zero outside the image or past W."""
        ok = (x < w) & (x + dx >= 0) & (x + dx < w) & (0 <= y + dy < h)
        xs = (x + dx).clamp(0, w - 1)
        vals = parts[p][img, min(max(y + dy, 0), h - 1)][xs][:, ch]
        return torch.where(ok[:, None], vals, 0.0), ok, xs

    if plan.a_tma:
        for kt, (q, tap, wc) in enumerate(chunk_walk(conv, 0)):
            p, c0 = _part_of(conv, wc)
            assert c0 % BKH == 0 and c0 + BKH <= conv.cins[p]
            for k in range(4):   # the stage's four chunks: one tap and part
                assert chunk_walk(conv, k)[kt][1:] == (tap, wc + k)
            dy, dx = tap // conv.kx - conv.ky // 2, tap % conv.kx - conv.kx // 2
            out[:, kt * BKH:(kt + 1) * BKH] = shifted(p, dy, dx, slice(c0, c0 + BKH))[0]
        return out
    for l_c in range(8):
        a_q, a_f = l_c // 2, (l_c % 2) * 8
        for kt, (q, tap, wc) in enumerate(chunk_walk(conv, a_q)):
            col = kt * BKH + l_c * 8
            if plan.copies[0] == 4:     # the flow: 4 taps of 2 channels
                t0 = (q * KC + a_f) // 2
                for e in range(4):
                    t = t0 + e
                    if t >= conv.taps:
                        continue
                    dy, dx = t // conv.kx - conv.ky // 2, t % conv.kx - conv.kx // 2
                    vals, ok, xs = shifted(0, dy, dx, slice(0, 2))
                    out[:, col + 2 * e:col + 2 * e + 2] = vals
                    if copies is not None:
                        copies += [(0, 4, 4 * ((row + dy) * w + int(s)))
                                   for s in xs[ok]]
                continue
            if tap is None:
                continue
            p, c0 = _part_of(conv, wc)
            r = c0 + a_f
            cin = conv.cins[p]
            dy, dx = tap // conv.kx - conv.ky // 2, tap % conv.kx - conv.kx // 2
            width = plan.copies[p]
            for half in ((0, 8),) if width == 16 else ((0, 4), (4, 8)):
                lo, hi = r + half[0], r + half[1]
                if lo >= cin:       # padding channels: zero fill
                    continue
                vals, ok, xs = shifted(p, dy, dx, slice(lo, hi))
                out[:, col + half[0]:col + half[1]] = vals
                if copies is not None:
                    copies += [(p, width, 2 * (((row + dy) * w + int(s)) * cin + lo))
                               for s in xs[ok][:4]]
    return out


def tile_conv(parts, wmat, bias, ky, kx, n, owned=None):
    """One bf16 convolution as the tile computes it: for each row segment,
    N tile and consumer, the f32 sum over the stages of the gathered A
    stage times the pack's B stage (TMA: rows n0 .., K zero past the packed
    rows), then each output rounded to bfloat16, the bfloat16 bias added
    and rounded (``rb(rb(acc) + b)``). ``parts`` are (B, H, W, cin) float32
    holding bfloat16 values; ``owned`` (B, H, W, ldw) counts each output's
    writes."""
    cins = tuple(p.shape[-1] for p in parts)
    conv = conv_tile.Conv("conv", ky, kx, cins, n)
    plan = conv_tile.plan_conv(conv)
    parts = [p.float() for p in parts]
    b, h, w = parts[0].shape[:3]
    wk = torch.nn.functional.pad(wmat.float(), (0, plan.stages * BKH - conv.krows))
    assert wk.shape[0] == conv.ldw
    acc = torch.full((b, h, w, conv.ldw), float("nan"))
    segs = segments(b, h, w)
    assert plan.tiles(b, h, w) == len(segs) * (conv.ldw // plan.block_n)
    for t in range(plan.tiles(b, h, w)):
        (row, x0), n0 = segs[t % len(segs)], (t // len(segs)) * plan.block_n
        a = gather(conv, parts, (row, x0), (b, h, w), plan)
        live = min(BM, w - x0)
        for cons in range(conv_tile.CONSUMERS):
            c0 = n0 + cons * plan.consumer_n
            s = torch.zeros(BM, plan.consumer_n)
            for kt in range(plan.stages):
                k = slice(kt * BKH, (kt + 1) * BKH)
                s += a[:, k] @ wk[c0:c0 + plan.consumer_n, k].t()
            acc[row // h, row % h, x0:x0 + live, c0:c0 + plan.consumer_n] = s[:live]
            if owned is not None:
                owned[row // h, row % h, x0:x0 + live, c0:c0 + plan.consumer_n] += 1
    assert not torch.isnan(acc).any()
    return replay.rb(replay.rb(acc[..., :n]) + bias[:n])


# -- the plan -------------------------------------------------------------------

@pytest.mark.parametrize("program", ["motion", "gru", "step mg", "step mgf"])
def test_plan_follows_the_kernels_rules(program):
    """Each conv's block_n is a multiple of 64 up to 256 dividing its
    packed columns, split in two consumer widths of a wgmma (n32-n128); A by
    TMA exactly where every part's channels are a multiple of 64; the plan
    array is what ``make_program_h`` takes; the boxes fit TMA's 128-byte
    swizzle."""
    phases = _programs()[program]
    ints = conv_tile.plan_array(phases)
    assert len(ints) == len(phases) * conv_tile.MAX_CONVS * conv_tile.PLAN_INTS
    for i, phase in enumerate(conv_tile.plan(phases)):
        for slot in range(conv_tile.MAX_CONVS):
            at = (i * conv_tile.MAX_CONVS + slot) * conv_tile.PLAN_INTS
            got = ints[at:at + conv_tile.PLAN_INTS]
            if slot >= len(phase):
                assert got == (0,) * conv_tile.PLAN_INTS
                continue
            p = phase[slot]
            c = p.conv
            rule = [4 if c.cins == (2,) else 16 if cin % 8 == 0 else 8
                    for cin in c.cins]
            assert list(got[2:2 + len(c.cins)]) == rule
            assert got[2 + len(c.cins):] == (0,) * (3 - len(c.cins))
            assert p.stages == -(-c.krows // BKH)
            tma = c.cins != (2,) and all(cin % 64 == 0 for cin in c.cins)
            assert got[:2] == (p.block_n, int(tma)) and p.a_tma == tma
            assert p.block_n % 64 == 0 and p.block_n <= 256
            assert c.ldw % p.block_n == 0 and c.ldw == -(-c.n // 64) * 64
            assert p.consumer_n in (32, 64, 96, 128)
            assert p.consumer_n * conv_tile.CONSUMERS == p.block_n
            assert BKH * 2 == 128 and (2 * c.krows) % 16 == 0
            if tma:                 # 16-byte pixel strides
                assert all((2 * cin) % 16 == 0 for cin in c.cins)


def test_plan_matches_the_bf16_packs():
    """The bf16 packs' shapes are the plan's (ldw, packed rows) for every
    tiled conv of the step, and the lookup and flow take the narrow
    copies."""
    torch.manual_seed(0)
    block = RAFT(RAFTConfig()).update_block
    packed = step_cuda.pack_bf16((block.encoder.convs(), block.gru.convs(),
                                  block.flow_head.convs()))
    mats = [t for group in packed for t in group[::2]]
    convs = _convs()
    names = ["convc1", "convc2", "convf1", "convf2", "conv",
             "gates1", "cand1", "gates2", "cand2", "fh1", "fh2"]
    for name, mat in zip(names, mats):
        c = convs[name]
        assert tuple(mat.shape) == (c.ldw, c.krows), name
        assert mat.dtype == torch.bfloat16
    assert tuple(motion_cuda.packed_shapes(CC, bf16=True)[0]) == (256, 336)
    routes = {n: conv_tile.plan_conv(c).routes for n, c in convs.items()}
    assert routes["convc1"] == ("cp.async8",)      # 324 channels, 648-byte pixels
    assert routes["convf1"] == ("cp.async4",)      # the flow
    assert routes["gates1"] == ("tma",) * 3        # h, inp, [motion | flow]
    assert routes["convc2"] == routes["conv"] == routes["fh1"] == ("tma",)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("program", ["gru", "step mgf"])
def test_each_output_is_owned_once_per_phase(shape, program):
    """Each phase's tiles (row segments x N tiles), shared out by block
    (block b takes tiles b, b + grid, ...) over the launch's grid (132
    blocks, or the busiest phase's work), cover every (pixel, channel) of
    each conv exactly once, and the waves are what ``conv_tile.waves``
    reports."""
    b, h, w = SHAPES[shape]
    phases = _programs()[program]
    plans = conv_tile.plan(phases)
    work = max(sum(p.tiles(b, h, w) for p in ph) for ph in plans)
    grid = min(SMS, work)
    segs = segments(b, h, w)
    for ph, report in zip(plans, conv_tile.waves(phases, b, h, w, grid)):
        total = sum(p.tiles(b, h, w) for p in ph)
        taken = np.zeros(total, np.int64)
        for blk in range(grid):
            taken[blk::grid] += 1
        assert (taken == 1).all()
        for p in ph:
            owned = np.zeros((b * h, w + BM, p.conv.ldw), np.int8)
            for t in range(p.tiles(b, h, w)):
                (row, x0), n0 = segs[t % len(segs)], (t // len(segs)) * p.block_n
                for cons in range(conv_tile.CONSUMERS):
                    c0 = n0 + cons * p.consumer_n
                    owned[row, x0:x0 + BM, c0:c0 + p.consumer_n] += 1
            assert (owned[:, :w] == 1).all(), p.conv.name
        assert report["tiles"] == total
        assert report["waves"] == total / grid
    if shape == "sintel B=1":   # 110 segments: one tile a block
        assert max(sum(p.tiles(b, h, w) for p in ph) for ph in plans[3:7]) == 110


@pytest.mark.parametrize("name", ["convc1", "convf1", "convc2", "conv",
                                  "gates1", "cand2", "fh1"])
def test_stages_cover_the_packed_rows_once(name):
    """The four chunk columns' walks visit every chunk of the packed rows
    once, chunk q at tap q // per_tap, in the packs' tap-major order."""
    conv = _convs()[name]
    seen = []
    for a_q in range(4):
        for q, tap, w in chunk_walk(conv, a_q):
            if tap is None:
                assert q >= conv.krows // KC
                continue
            assert (tap, w) == divmod(q, _per_tap(conv))
            seen.append(q)
    if conv.cins == (2,):
        assert conv.krows == -(-2 * conv.taps // KC) * KC
    else:
        assert sorted(seen) == list(range(conv.krows // KC))


# -- the gather ----------------------------------------------------------------

def _acts(rng, b, h, w, cins):
    return [torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(
        np.float32)).to(torch.bfloat16).float() for c in cins]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", ["convc1", "convf1", "convf2", "gates1",
                                  "cand2", "fh1"])
def test_gather_zero_fills_edges_and_past_w(shape, name):
    """The gathered A of the first segment, the last one of the first
    image (its bottom row) and the last (ragged where W is not a multiple
    of 64) against the replay's columns: zero at the image edge, past W
    and past the packed rows; each copy aligned to its width, the width
    dividing its part's pixel stride."""
    conv = _convs()[name]
    b, h, w = SHAPES[shape]
    rng = np.random.default_rng(len(name) + b)
    segs = segments(b, h, w)
    xt = -(-w // BM)
    for t in sorted({0, h * xt - 1, len(segs) - 1}):
        row, x0 = segs[t]
        img = row // h
        acts = _acts(rng, 1, h, w, conv.cins)
        # the segment's image, the others zero (never read)
        parts = [torch.zeros(b, h, w, c) for c in conv.cins]
        for p, a in zip(parts, acts):
            p[img] = a[0]
        copies = []
        got = gather(conv, parts, (row, x0), (b, h, w), copies=copies)
        cols = replay.columns(acts, conv.ky, conv.kx, conv.krows)[0, row % h]
        want = torch.zeros(BM, got.shape[1])
        live = min(BM, w - x0)
        want[:live, :conv.krows] = cols[x0:x0 + live]
        assert torch.equal(got, want), (name, shape, t)
        for p, width, offset in copies:
            assert offset % width == 0 and (2 * conv.cins[p]) % width == 0


# -- the arithmetic ---------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_block():
    model = RAFT(RAFTConfig())
    model.load_state_dict(load_npz(WEIGHTS))
    return model.update_block.eval()


def _inputs(b, h, w, seed):
    rng = np.random.default_rng(seed)
    acts = [np.tanh(rng.standard_normal((b, h, w, C))),
            np.maximum(rng.standard_normal((b, h, w, CI)), 0),
            rng.standard_normal((b, h, w, CC)),
            rng.uniform(-20, 20, (b, h, w, 2))]
    return [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            for a in acts]


def _held(got, want, control):
    got, want, control = got.float(), want.float(), control.float()
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 8 * EPS * max(1.0, top)
    assert float((got - want).norm() / want.norm()) <= NORM_REL
    assert float((control - want).norm() / want.norm()) > NORM_REL


def _held_delta(got, want):
    bar = 8 * EPS * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= bar


@pytest.mark.parametrize("bhw", [(1, 16, 24), (2, 7, 70)],
                         ids=["B=1", "two segments a row"])
def test_tiled_bf16_step_matches_plain(golden_block, bhw, monkeypatch):
    """The bf16 step at 'mgf' computed tile by tile and stage by stage on
    the bf16 packs (the gather above, each consumer's columns) against the
    plain bf16 step: h2 within 8 bf16 eps of max(1, max|plain|) and 1e-3
    on the 2-norm (the float32 plain step above it), delta within 8 eps of
    max|plain|; every output of every conv written once."""
    block = golden_block
    net, inp, cor, flow = _inputs(*bhw, seed=sum(bhw))
    convs = (block.encoder.convs(), block.gru.convs(), block.flow_head.convs())
    motion, gru, head = step_cuda.pack_bf16(convs)
    writes = []

    def conv(parts, wmat, bias, ky, kx, n):
        owned = torch.zeros(*parts[0].shape[:3], wmat.shape[0], dtype=torch.int32)
        out = tile_conv(parts, wmat, bias, ky, kx, n, owned)
        writes.append(owned)
        return out

    monkeypatch.setattr(replay, "conv", conv)
    mot = replay.motion(flow, cor, motion)
    h2 = replay.gru(net, (inp, mot), gru)
    delta = replay.flow_head(h2, head)
    assert len(writes) == 11 and all(bool((o == 1).all()) for o in writes)
    with torch.inference_mode():
        want_h2, want_delta = step_cuda.fused_step_plain(net, inp, cor, flow,
                                                         convs)
        control = step_cuda.fused_step_plain(
            *(t.float() for t in (net, inp, cor, flow)), convs)[0]
    assert torch.equal(mot[..., 126:], flow.float())
    _held(h2, want_h2, control)
    _held_delta(delta, want_delta)


def test_bf16_packs_replay_the_plain_versions(golden_block):
    """The bf16 packs at the tile's padding, replayed whole
    (``torch_conv_replay``: bf16 sums, the kernels' rounding points),
    against the plain bf16 motion encoder, GRU cell (x as the chain's
    parts) and flow head, with the float32 plain versions as the control
    of the 2-norm."""
    block = golden_block
    net, inp, cor, flow = _inputs(2, 12, 20, seed=3)
    enc, gru, head = block.encoder, block.gru, block.flow_head
    with torch.inference_mode():
        mot = replay.motion(flow, cor, enc.packed_weights_bf16())
        want = motion_cuda.motion_encoder_plain(flow, cor, enc.convs())
        ctrl = motion_cuda.motion_encoder_plain(flow.float(), cor.float(),
                                                enc.convs())
        _held(mot[..., :126], want[..., :126], ctrl[..., :126])
        assert torch.equal(mot[..., 126:], flow.float())
        parts = (inp, want)
        h2 = replay.gru(net, parts, gru.packed_weights_bf16())
        want_h2 = gru_cuda.sepconv_gru_plain(net, parts, gru.convs())
        ctrl_h2 = gru_cuda.sepconv_gru_plain(
            net.float(), tuple(p.float() for p in parts), gru.convs())
        _held(h2, want_h2, ctrl_h2)
        delta = replay.flow_head(want_h2, head.packed_weights_bf16())
        _held_delta(delta, step_cuda.flow_head_plain(want_h2, head.convs()))
