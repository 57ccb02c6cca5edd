"""The arithmetic of the bf16 corr backward's products at mxu "float32"
(``csrc/corr_tile_bf16.cuh``), emulated on the CPU.

On bfloat16 maps the backward's two products, ``df1 = G . F2_box`` (K = the
box pixels, in chunks of 64) and ``df2 = G^T . F1_tile`` (K = the 64
queries), take the float32 coefficients G at float32 precision. The map is
exact in bfloat16, so the kernel splits each coefficient into three
bfloat16 parts, c = hi + mid + lo (each the rounding of what the parts
before it left), and runs three bf16 passes with float32 sums, the
smallest part first; df1's sums over a chunk are a fresh sum added in
float32. The bf16 products of the parts are exact in float32, so only the
split and the sums round. The parent kernel split the coefficient into two
TF32 parts (hi rounded to TF32, lo the remainder's top 11 bits).

These tests hold the three-part split to every bit of a float32, the
emulated products to chip_smoke's ``CORR_BWD_BF16_BARS`` for bfloat16 maps
at mxu "float32" against float64, and below the two-TF32-part products'
error; one bfloat16 pass (mxu "bfloat16") is the control that lies above
the 2-norm bar. At mxu "bfloat16" the kernel rounds each folded
coefficient to bfloat16, and the plain version folds it in the same order
(``_BilinearWindows``), so that both round the same float32 value; the
last test holds that fold to an exact one. The card's own readings are
chip_smoke's.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from raft_tpu_torch.ops import conv_pack, corr_cuda

CHUNK = 64   # box pixels per chunk, and queries per tile
BARS = chip_smoke.CORR_BWD_BF16_BARS[("bfloat16", "float32")]


def split3(c):
    """The kernel's three bfloat16 parts of float32 c (split_coef)."""
    hi = c.to(torch.bfloat16)
    r1 = c - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def split_tf32(c):
    """The parent kernel's two TF32 parts: hi rounded to TF32, lo the top
    11 significand bits of the remainder (what the tensor core reads)."""
    hi = conv_pack.tf32_rna(c)
    lo = ((c - hi).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def bf16_passes(g, f, parts):
    """g (M, K) float32 . f (K, N) bfloat16 as the kernel sums it in
    ``parts`` (3: mxu "float32"; 1: mxu "bfloat16") bfloat16 planes: per
    chunk of 64 of K, the planes' products (smallest first) into a fresh
    float32 sum, added to the total in float32."""
    planes = split3(g) if parts == 3 else (g.to(torch.bfloat16),)
    total = torch.zeros(g.shape[0], f.shape[1])
    for k0 in range(0, g.shape[1], CHUNK):
        k = slice(k0, k0 + CHUNK)
        fresh = torch.zeros_like(total)
        for p in reversed(planes):
            fresh = fresh + p[:, k].float() @ f[k].float()
        total = total + fresh
    return total


def coefficients(rng, m, k):
    """Folded coefficients: bilinear weights times a cotangent over
    sqrt(C), spread over a few binades, a third of them zero (pixels that
    are no query's neighbour)."""
    c = rng.standard_normal((m, k)) * np.exp2(rng.integers(-6, 3, (m, k)))
    c[rng.random((m, k)) < 1 / 3] = 0.0
    return torch.from_numpy((c / 16).astype(np.float32))


def rel(got, want):
    """(max|got - want| / max|want|, |got - want| / |want| in 2-norms)."""
    d = got.double() - want
    return float(d.abs().max() / want.abs().max()), float(d.norm() / want.norm())


@pytest.mark.parametrize("scale", [2.0 ** -60, 1.0, 2.0 ** 60])
def test_three_parts_keep_every_bit_of_a_float32(scale):
    """hi + mid + lo is c to within 2^-24 of |c| (exactly, for almost every
    c: 8 + 8 + 8 significand bits), in binades far from the subnormals
    (whose lo part loses bits); two TF32 parts miss by up to 2^-23."""
    rng = np.random.default_rng(0)
    c = torch.from_numpy((rng.standard_normal(1 << 16) * scale).astype(np.float32))
    three = sum(p.double() for p in split3(c))
    two = sum(p.double() for p in split_tf32(c))
    err3 = float(((three - c.double()).abs() / c.double().abs()).max())
    err2 = float(((two - c.double()).abs() / c.double().abs()).max())
    assert err3 <= 2.0 ** -24, err3
    assert err2 > 2.0 ** -24, err2
    exact = float((three == c.double()).double().mean())
    assert exact > 0.99, exact


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("pixels", [64, 200, 1024])
def test_three_bf16_passes_hold_the_mxu_float32_bars(pixels, c):
    """df1 (K = the box's pixels: one chunk, a ragged last chunk, 16
    chunks) and df2 (K = the tile's 64 queries) by three bf16 passes
    against float64: within CORR_BWD_BF16_BARS for bfloat16 maps at mxu
    "float32", and closer in 2-norm than two TF32 passes."""
    rng = np.random.default_rng(pixels + c)
    g = coefficients(rng, CHUNK, pixels)
    f2 = torch.from_numpy(rng.standard_normal((pixels, c)).astype(np.float32)).bfloat16()
    f1 = torch.from_numpy(rng.standard_normal((CHUNK, c)).astype(np.float32)).bfloat16()
    for a, b in ((g, f2), (g.t().contiguous(), f1)):
        want = a.double() @ b.double()
        largest, norm = rel(bf16_passes(a, b, 3), want)
        assert largest <= BARS[0] and norm <= BARS[1], (largest, norm)
        hi, lo = split_tf32(a)
        _, norm_tf32 = rel(hi @ b.float() + lo @ b.float(), want)
        assert norm < norm_tf32, (norm, norm_tf32)


def test_one_bf16_pass_is_the_control():
    """One bf16 pass, the coefficient rounded to bfloat16 (mxu "bfloat16"),
    lies above the 2-norm bar: the bar tells a kernel that rounded the
    coefficient from one that kept it."""
    rng = np.random.default_rng(7)
    g = coefficients(rng, CHUNK, 320)
    f2 = torch.from_numpy(rng.standard_normal((320, 256)).astype(np.float32)).bfloat16()
    _, norm = rel(bf16_passes(g, f2, 1), g.double() @ f2.double())
    assert norm > BARS[1], norm


@pytest.mark.parametrize("scale", [True, False])
def test_plain_fold_is_the_exact_fold_rounded(scale):
    """The plain version's cotangent of each neighbour's dot at mxu
    "bfloat16" (``_BilinearWindows``: the float32 fold in the kernel's
    order, then bfloat16) against the same fold in float64 rounded once to
    bfloat16, at r=3 with neighbours off the level: equal but for the odd
    coefficient whose float32 fold lies across a rounding boundary from the
    exact one, and there one bfloat16 ulp apart; zero off the level."""
    rng = np.random.default_rng(3)
    b, h, w, r, c = 2, 5, 6, 3, 128
    d = 2 * r + 2
    dots = torch.zeros(b, h, w, d, d, requires_grad=True)
    inside = torch.from_numpy(rng.random((b, h, w, d, d)) > 0.2).float()
    dx, dy = (torch.from_numpy(rng.random((b, h, w, 1, 1)).astype(np.float32))
              for _ in range(2))
    g = torch.from_numpy(rng.standard_normal(
        (b, h, w, (d - 1) ** 2)).astype(np.float32))
    corr_cuda._BilinearWindows.apply(dots, inside, dx, dy, c,
                                     scale).backward(g)
    dots64 = torch.zeros(b, h, w, d, d, dtype=torch.float64,
                         requires_grad=True)
    x, y = dx.double(), dy.double()
    win = ((1 - x) * (1 - y) * dots64[..., :-1, :-1]
           + x * (1 - y) * dots64[..., :-1, 1:]
           + (1 - x) * y * dots64[..., 1:, :-1]
           + x * y * dots64[..., 1:, 1:]).transpose(-1, -2).reshape(
               b, h, w, -1)
    inv = 1 / corr_cuda._scale_div(c, scale) if scale else 1.0
    win.backward(g.double() * np.float32(inv))
    want = dots64.grad.float().bfloat16().float() * inside
    got = dots.grad
    assert torch.equal(got == 0, want == 0)
    ulp = torch.where(want != 0, want.abs() * 2.0 ** -7, 1.0)
    off = (got - want).abs()
    assert float((off / ulp).max()) <= 1.0
    assert float((off > 0).double().mean()) < 0.01
