"""The port's correlation and sampling numerics against the JAX package.

Same numpy inputs (from a seed) through ``raft_tpu_torch`` and ``raft_tpu``
on the CPU, forward and gradients. Tolerances: both sides compute in
float32 and sum in different orders (gathers vs hat-weight matmuls, torch
vs XLA reductions), so values of order 1-10 agree to about 1e-6; the bars
below leave a margin of ten. The CUDA kernels are held against their plain
versions in the ``cuda`` tests, which skip without a card.
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch.models import corr
from raft_tpu_torch.ops import corr_cuda, sampling

try:
    import jax
    import jax.numpy as jnp

    from raft_tpu.models import corr as jcorr
    from raft_tpu.ops import sampling as jsampling
    from raft_tpu.ops.corr_pallas import windowed_correlation_pallas_fused
except ModuleNotFoundError:
    # The card's machine has no JAX; only the ``cuda`` tests run there:
    #   python -m pytest --noconftest tests/test_torch_corr.py -m cuda
    jnp = None

TOL = 1e-5
B, H, W, C, R = 2, 6, 7, 16, 3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several xdist workers on one shared CPU; torch's
    default of one thread per core oversubscribes it (the CPU golden took
    39 s instead of 2 s next to six busy processes). Two threads each,
    restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def lookup_inputs():
    """fmap1, a 2-level pooled pyramid and coords with flows up to 6 px on a
    6x7 map: many windows lie partly or wholly outside the image."""
    rng = np.random.default_rng(0)
    f1 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)
    coords = (grid[None] + rng.uniform(-6, 6, (B, H, W, 2))).astype(np.float32)
    return f1, f2, coords


def test_plain_lookup_matches_jax(lookup_inputs):
    f1, f2, coords = lookup_inputs
    want = jcorr.alternate_lookup(
        jnp.asarray(f1), jcorr.build_feature_pyramid(jnp.asarray(f2), 2),
        jnp.asarray(coords), R, backend="jnp")
    got = corr.alternate_lookup(_t(f1), corr.build_feature_pyramid(_t(f2), 2),
                                _t(coords), R)
    assert got.shape == (B, H, W, 2 * (2 * R + 1) ** 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_plain_lookup_matches_pallas_interpret(lookup_inputs):
    """Against the TPU kernel itself, run by the Pallas interpreter."""
    f1, f2, coords = lookup_inputs
    pyr = jcorr.build_feature_pyramid(jnp.asarray(f2), 2)
    want = windowed_correlation_pallas_fused(
        jnp.asarray(f1), pyr, jnp.asarray(coords), R, interpret=True)
    got = corr_cuda.windowed_correlation_fused_plain(
        _t(f1), corr.build_feature_pyramid(_t(f2), 2), _t(coords), R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_single_level_matches_jax(lookup_inputs):
    f1, f2, coords = lookup_inputs
    want = jcorr.windowed_correlation(jnp.asarray(f1), jnp.asarray(f2),
                                      jnp.asarray(coords), R, scale=False)
    got = corr.windowed_correlation(_t(f1), _t(f2), _t(coords), R,
                                    scale=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_all_pairs_pyramid_and_lookup_match_jax(lookup_inputs):
    f1, f2, coords = lookup_inputs
    jpyr = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 3)
    pyr = corr.build_corr_pyramid(_t(f1), _t(f2), 3)
    for a, b in zip(pyr, jpyr):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0)
    want = jcorr.pyramid_lookup(jpyr, jnp.asarray(coords), R)
    got = corr.CorrBlock(_t(f1), _t(f2), 3, R)(_t(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    # and the two engines agree with each other
    alt = corr.AlternateCorrBlock(_t(f1), _t(f2), 3, R)(_t(coords))
    np.testing.assert_allclose(alt.numpy(), got.numpy(), atol=TOL, rtol=0)


def test_all_pairs_engine_is_differentiable(lookup_inputs):
    """The materialised engine (``CorrBlock``) gives fmap1 and fmap2 the
    gradients of the on-demand engine's plain version (bar as above)."""
    f1, f2, coords = lookup_inputs
    cot = _t(np.random.default_rng(4).standard_normal(
        (B, H, W, 3 * (2 * R + 1) ** 2)))
    grads = []
    for block in (corr.CorrBlock, corr.AlternateCorrBlock):
        a, b = _t(f1).requires_grad_(True), _t(f2).requires_grad_(True)
        (block(a, b, 3, R)(_t(coords)) * cot).sum().backward()
        grads.append((a.grad, b.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                                   rtol=0)


def test_degenerate_level_gives_zero_windows(lookup_inputs):
    """A 1-row map pools to an empty level: its windows are exactly zero,
    as in JAX, and the other levels are untouched."""
    f1, f2, coords = (a[:, :1] for a in lookup_inputs)
    pyr = corr.build_feature_pyramid(_t(f2), 2)
    assert pyr[1].shape[1] == 0
    got = corr.alternate_lookup(_t(f1), pyr, _t(coords), R)
    win = (2 * R + 1) ** 2
    assert torch.count_nonzero(got[..., win:]) == 0
    want = jcorr.alternate_lookup(
        jnp.asarray(f1), jcorr.build_feature_pyramid(jnp.asarray(f2), 2),
        jnp.asarray(coords), R, backend="jnp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_sampling_primitives_match_jax():
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 5, 1, 3)).astype(np.float32)  # width 1
    pts = rng.uniform(-2, 6, (2, 4, 9, 2)).astype(np.float32)
    pts[0, 0, 0] = [0.0, 3.0]                                   # exact pixel
    got = sampling.bilinear_sampler(_t(img), _t(pts))
    want = jsampling.bilinear_sampler(jnp.asarray(img), jnp.asarray(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    assert np.array_equal(got[0, 0, 0].numpy(), img[0, 3, 0])

    grid = sampling.coords_grid(2, 3, 4)
    np.testing.assert_array_equal(grid.numpy(),
                                  np.asarray(jsampling.coords_grid(2, 3, 4)))

    x = rng.standard_normal((1, 55, 9, 2)).astype(np.float32)
    sizes = []
    for _ in range(3):
        jx = jsampling.avg_pool2x2(jnp.asarray(x))
        x_t = sampling.avg_pool2x2(_t(x))
        np.testing.assert_allclose(x_t.numpy(), np.asarray(jx), atol=TOL,
                                   rtol=0)
        x = np.asarray(jx)
        sizes.append(x.shape[1])
    assert sizes == [27, 13, 6]

    flow = rng.standard_normal((2, 3, 4, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 3, 4, 576)).astype(np.float32)
    np.testing.assert_allclose(
        sampling.convex_upsample(_t(flow), _t(mask)).numpy(),
        np.asarray(jsampling.convex_upsample(jnp.asarray(flow),
                                             jnp.asarray(mask))),
        atol=TOL, rtol=0)
    np.testing.assert_allclose(
        sampling.upflow8(_t(flow)).numpy(),
        np.asarray(jsampling.upflow8(jnp.asarray(flow))), atol=TOL, rtol=0)


def test_cuda_wrapper_refuses_cpu_tensors(lookup_inputs):
    """The kernel's wrapper launches on CUDA tensors or raises: it never
    computes a CPU tensor with the plain version."""
    f1, f2, coords = lookup_inputs
    with pytest.raises(ValueError, match="CUDA"):
        corr_cuda.windowed_correlation_cuda(
            _t(f1), corr.build_feature_pyramid(_t(f2), 2), _t(coords), R)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(24, 32), (55, 128)])
def test_kernel_matches_plain_on_card(cuda, hw):
    """The kernel against its plain version on the card at the golden and
    Sintel feature shapes (C=256, 4 levels, r=4), flows up to 40 px. Bar
    1e-4: the two sum in different orders over 256 channels."""
    rng = np.random.default_rng(2)
    h, w = hw
    f1 = _t(rng.standard_normal((1, h, w, 256))).to(cuda)
    f2 = _t(rng.standard_normal((1, h, w, 256))).to(cuda)
    pyr = corr.build_feature_pyramid(f2, 4)
    coords = (sampling.coords_grid(1, h, w, cuda)
              + _t(rng.uniform(-40, 40, (1, h, w, 2))).to(cuda)).contiguous()
    before = corr_cuda.launches
    got = corr.alternate_lookup(f1, pyr, coords, 4)
    assert corr_cuda.launches == before + 1
    want = corr_cuda.windowed_correlation_fused_plain(f1, pyr, coords, 4)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def _compiled(fn, *args):
    """``jax.jit(fn)(*args)``, compiled at a low XLA optimisation level: it
    takes less compile time and rounds the same float32 arithmetic at most
    a few ulp differently."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


def _leaves(*arrays):
    return [_t(a).requires_grad_(True) for a in arrays]


def _grads(loss, leaves):
    return torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.fixture(scope="module")
def corr_case():
    """A 3-level lookup at r=3 on an 8x12 map, flows up to 6 px (many
    windows partly outside), and a cotangent: numpy arrays."""
    rng = np.random.default_rng(3)
    B, H, W, C, L, r = 1, 8, 12, 16, 3, 3
    f1 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)
    coords = (grid[None] + rng.uniform(-6, 6, (B, H, W, 2))).astype(
        np.float32)
    cot = rng.standard_normal((B, H, W, L * (2 * r + 1) ** 2)).astype(
        np.float32)
    return f1, f2, coords, cot, L, r


def test_corr_gradients_match_pallas_backward(corr_case):
    """df1 and the per-level df2 of the port's plain lookup (autograd)
    against ``jax.grad`` of the fused Pallas kernel, whose custom VJP runs
    the TPU backward kernel ``_bwd_kernel`` in the interpreter; and the
    gradient to fmap2 through the average-pooled pyramid. Bar 1e-5 of the
    largest gradient: float32 sums of a few hundred terms in other orders.
    """
    f1, f2, coords, cot, L, r = corr_case

    def jloss(a, levels):
        return jnp.sum(windowed_correlation_pallas_fused(
            a, levels, jnp.asarray(coords), r, interpret=True) * cot)

    def jgrads(a, b):
        levels, pool_vjp = jax.vjp(
            lambda b: jcorr.build_feature_pyramid(b, L), b)
        d1, dlevels = jax.grad(jloss, argnums=(0, 1))(a, levels)
        return d1, dlevels, pool_vjp(dlevels)[0]

    jd1, jd2s, jdf2 = _compiled(jgrads, jnp.asarray(f1), jnp.asarray(f2))

    t1, t2 = _leaves(f1, f2)
    levels = [lv.detach().requires_grad_(True)
              for lv in corr.build_feature_pyramid(t2, L)]
    out = corr_cuda.windowed_correlation_fused_plain(t1, levels, _t(coords),
                                                     r)
    got = _grads((out * _t(cot)).sum(), [t1, *levels])
    pooled = corr_cuda.windowed_correlation_fused_plain(
        t1, corr.build_feature_pyramid(t2, L), _t(coords), r)
    (got_f2,) = _grads((pooled * _t(cot)).sum(), [t2])

    for a, b in zip(got, [jd1, *jd2s]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    np.testing.assert_allclose(got_f2.numpy(), np.asarray(jdf2), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jdf2)).max())


def test_corr_function_wiring_and_no_coords_gradient(corr_case, monkeypatch):
    """``WindowedCorrelationFn`` with the plain forward and the plain
    backward injected for the two kernels: fmap1 and every level get the
    kernel's gradients, the coordinates get none (the zero-gradient
    contract of ``_windowed_bwd``), the forward equals the plain lookup
    bit for bit."""
    f1, f2, coords, cot, L, r = corr_case
    calls = []

    def bwd(*args, **kw):
        calls.append(args[3].shape)
        return corr_cuda.windowed_correlation_bwd_plain(*args, **kw)

    monkeypatch.setattr(corr_cuda, "windowed_correlation_cuda",
                        corr_cuda.windowed_correlation_fused_plain)
    monkeypatch.setattr(corr_cuda, "windowed_correlation_bwd_cuda", bwd)
    t1, t2, tc = _leaves(f1, f2, coords)
    levels = corr.build_feature_pyramid(t2, L)
    out = corr_cuda.WindowedCorrelationFn.apply(t1, tc, r, True, True,
                                                *levels)
    (out * _t(cot)).sum().backward()
    assert calls == [out.shape] and tc.grad is None

    p1, p2 = _leaves(f1, f2)
    plain = corr_cuda.windowed_correlation_fused_plain(
        p1, corr.build_feature_pyramid(p2, L), _t(coords), r)
    (plain * _t(cot)).sum().backward()
    assert torch.equal(out, plain)
    torch.testing.assert_close(t1.grad, p1.grad, rtol=0, atol=0)
    torch.testing.assert_close(t2.grad, p2.grad, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(24, 32), (55, 128)])
def test_corr_bwd_kernel_matches_plain_on_card(cuda, hw):
    """``csrc/corr_bwd.cu`` against autograd through the plain forward on
    the card (C=256, 4 levels, r=4, flows up to 40 px). Bar 1e-4 of the
    largest plain gradient: f32 atomics sum df2 in no fixed order."""
    rng = np.random.default_rng(8)
    h, w = hw
    f1 = _t(rng.standard_normal((1, h, w, 256))).to(cuda)
    pyr = corr.build_feature_pyramid(
        _t(rng.standard_normal((1, h, w, 256))).to(cuda), 4)
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]
    coords = _t(grid + rng.uniform(-40, 40, (1, h, w, 2))).to(cuda)
    g = _t(rng.standard_normal((1, h, w, 324))).to(cuda)
    before = corr_cuda.bwd_launches
    got = corr_cuda.windowed_correlation_bwd_cuda(f1, pyr, coords, g, 4)
    assert corr_cuda.bwd_launches == before + 1
    want = corr_cuda.windowed_correlation_bwd_plain(f1, pyr, coords, g, 4)
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
