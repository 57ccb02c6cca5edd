"""The port's multi-scale deformable attention against the JAX package.

The same seeded numpy inputs go through ``raft_tpu_torch.ops.msda`` and
``raft_tpu.ops.msda`` on the CPU: the jnp core (bar 1e-5: both sum a few
dozen float32 products of values of order 1 in other orders) and the TPU
kernel ``msda_pallas._fwd_kernel`` through the Pallas interpreter, as
``tests/test_msda_pallas.py`` runs it (bar 1e-4: its hat-weight matmuls sum
every column of a level, zeros included). Locations span [-0.2, 1.2], so
zero padding is exercised; Lq = 37 is off a multiple of 128. The module
``MSDeformAttn`` is held against flax's with the same weights, in both
reference-point forms. The gradients of the plain version, to the value,
the locations and the weights, are held against ``jax.grad`` through the
same two (bars 1e-5 and 1e-4 of each gradient's largest entry); the
locations are drawn at random, so no sample sits on an integer pixel, where
the bilinear derivative switches corners. The CUDA kernels are held against
the plain versions in the ``cuda`` tests, which skip without a card.
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch.models.deformable import MSDeformAttn
from raft_tpu_torch.ops import msda, msda_cuda

try:
    import jax
    import jax.numpy as jnp

    from raft_tpu.models import deformable as jdeformable
    from raft_tpu.ops.msda import ms_deform_attn as jax_msda
    from raft_tpu.ops.msda_pallas import ms_deform_attn_pallas
except ModuleNotFoundError:
    # The card's machine has no JAX; only the ``cuda`` tests run there:
    #   python -m pytest --noconftest tests/test_torch_msda.py -m cuda
    jnp = None

SHAPES = [(5, 7), (3, 4)]
B, M, LQ, P = 2, 2, 37, 3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads per xdist worker on the shared CPU, restored after
    this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _inputs(d, shapes=SHAPES, b=B, m=M, lq=LQ, p=P, seed=0, spread=0.2):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, s, m, d)).astype(np.float32)
    loc = rng.uniform(-spread, 1 + spread,
                      (b, lq, m, len(shapes), p, 2)).astype(np.float32)
    logits = rng.standard_normal((b, lq, m, len(shapes) * p))
    aw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, aw.reshape(b, lq, m, len(shapes), p).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    """Inputs at head width D = 8 and the port's plain output."""
    value, loc, aw = _inputs(8)
    got = msda.ms_deform_attn(_t(value), SHAPES, _t(loc), _t(aw))
    return value, loc, aw, got.numpy()


def test_plain_matches_jax_jnp(case):
    value, loc, aw, got = case
    want = jax.jit(lambda v, l, a: jax_msda(v, SHAPES, l, a, backend="jnp"))(
        value, loc, aw)
    assert got.shape == (B, LQ, M * value.shape[-1])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_plain_matches_pallas_interpret(case):
    value, loc, aw, got = case
    want = jax.jit(lambda v, l, a: ms_deform_attn_pallas(
        v, SHAPES, l, a, interpret=True))(value, loc, aw)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def grad_case(case):
    """A cotangent for ``case`` and the plain version's gradients to the
    value, the locations and the weights (autograd)."""
    value, loc, aw, got = case
    cot = np.random.default_rng(7).standard_normal(got.shape).astype(
        np.float32)
    leaves = [_t(a).requires_grad_(True) for a in (value, loc, aw)]
    out = msda.ms_deform_attn_plain(leaves[0], SHAPES, leaves[1], leaves[2])
    grads = torch.autograd.grad(out, leaves, _t(cot))
    return (value, loc, aw), cot, [g.numpy() for g in grads]


def _jax_grads(fn, arrays, cot):
    def loss(v, l, a):
        return jnp.sum(fn(v, l, a) * cot)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in arrays))


def _close_grads(got, want, rel):
    for name, a, b in zip(("value", "locations", "weights"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rel * float(np.abs(b).max()),
                                   err_msg=name)


def test_plain_gradients_match_jax_jnp(grad_case):
    """``jax.grad`` through the jnp core: the same bilinear corners in
    other summation orders, so 1e-5 of each gradient's largest entry."""
    arrays, cot, got = grad_case
    want = _jax_grads(lambda v, l, a: jax_msda(v, SHAPES, l, a,
                                               backend="jnp"), arrays, cot)
    _close_grads(got, want, 1e-5)


def test_plain_gradients_match_pallas_interpret(grad_case):
    """``jax.grad`` through ``ms_deform_attn_pallas``: its custom VJP runs
    the TPU's ``_bwd_kernel`` in the interpreter (hat-weight matmuls that
    sum every column of a level, and the corner-difference window of
    ``_corner`` for the locations), so 1e-4 of each gradient's largest
    entry."""
    arrays, cot, got = grad_case
    want = _jax_grads(lambda v, l, a: ms_deform_attn_pallas(
        v, SHAPES, l, a, interpret=True), arrays, cot)
    _close_grads(got, want, 1e-4)


def test_function_forward_is_its_callable_and_backward_raises(grad_case):
    """``MSDeformAttnFn`` with the plain forward and backward in the
    kernels' places: the forward's numbers, and the injected backward's
    gradients for the value, the locations and the weights, equal to
    plain autograd's (the same arithmetic)."""
    arrays, cot, want = grad_case
    value, loc, aw = (_t(a).requires_grad_(True) for a in arrays)
    out = msda_cuda.MSDeformAttnFn.apply(msda.ms_deform_attn_plain,
                                         msda.ms_deform_attn_bwd_plain,
                                         value, SHAPES, loc, aw)
    with torch.no_grad():
        plain = msda.ms_deform_attn_plain(value, SHAPES, loc, aw)
    assert torch.equal(out, plain)
    got = torch.autograd.grad(out, (value, loc, aw), _t(cot))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_dispatch_and_refusals():
    value, loc, aw = (_t(a) for a in _inputs(8))
    plain = msda.ms_deform_attn_plain(value, SHAPES, loc, aw)
    assert torch.equal(msda.ms_deform_attn(value, SHAPES, loc, aw), plain)
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.ms_deform_attn_cuda(value, SHAPES, loc, aw)
    with pytest.raises(ValueError, match="levels"):
        msda.ms_deform_attn_plain(value, SHAPES[:1], loc[:, :, :, :1],
                                  aw[:, :, :, :1])


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_module_matches_flax(ref_dim):
    """``MSDeformAttn`` against flax's with the same random weights (the
    flax init zeroes the two heads; random ones move the samples), with
    normalised points and with boxes as reference points. Bar 1e-5."""
    d_model, heads, levels, points, lq = 16, 2, len(SHAPES), 2, 9
    rng = np.random.default_rng(3)
    s = sum(h * w for h, w in SHAPES)
    query = rng.standard_normal((B, lq, d_model)).astype(np.float32)
    src = rng.standard_normal((B, s, d_model)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (B, lq, levels, ref_dim)).astype(np.float32)
    jmod = jdeformable.MSDeformAttn(d_model, levels, heads, points,
                                    backend="jnp")
    variables = jax.jit(jmod.init, static_argnums=4)(
        jax.random.PRNGKey(0), query, ref, src, tuple(SHAPES))
    params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.3,
        variables["params"])
    want, want_w = jax.jit(jmod.apply, static_argnums=4)(
        {"params": params}, query, ref, src, tuple(SHAPES))

    port = MSDeformAttn(d_model, levels, heads, points)
    port.load_state_dict({f"{name}.{'weight' if leaf == 'kernel' else leaf}":
                          _t(v.T if leaf == "kernel" else v)
                          for name, sub in params.items()
                          for leaf, v in sub.items()})
    with torch.no_grad():
        got, got_w = port(_t(query), _t(ref), _t(src), SHAPES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6,
                               rtol=0)


def test_init_matches_flax():
    """The heads' init: zero weights, the directional ring as the offsets'
    bias, zero attention logits."""
    port = MSDeformAttn(32, 6, 8, 4)
    np.testing.assert_array_equal(port.sampling_offsets.bias.detach().numpy(),
                                  jdeformable._directional_bias(8, 6, 4))
    for head in (port.sampling_offsets, port.attention_weights):
        assert not head.weight.any()
    assert not port.attention_weights.bias.any()


def test_cuda_wrapper_refuses_cpu_tensors():
    value, loc, aw = (_t(a) for a in _inputs(8))
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.ms_deform_attn_cuda(value, SHAPES, loc, aw)
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.ms_deform_attn_bwd_cuda(value, SHAPES, loc, aw,
                                          torch.zeros(B, LQ, M * 8))


# -- on the card ---------------------------------------------------------------

# The sparse family's levels at 352x480: strides 8, 16, 32 of both images.
LEVELS_352x480 = [(44, 60), (22, 30), (11, 15)] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,d", [
    (8, 100, 16),          # the decoder's cross-attention
    (4, 6930, 8),          # the dense-query encoder: every token a query
    (2, 37, 4)])
def test_kernel_matches_plain_on_card(cuda, b, lq, d):
    """``csrc/msda_fwd.cu`` against the plain version at the sparse
    family's shapes (M=8, P=4, six levels, locations over [-0.1, 1.1]). Bar
    1e-4: the two sum the same f32 products in other orders."""
    value, loc, aw = (_t(a).to(cuda) for a in _inputs(
        d, LEVELS_352x480, b=b, m=8, lq=lq, p=4, seed=5, spread=0.1))
    before = msda_cuda.launches
    got = msda.ms_deform_attn(value, LEVELS_352x480, loc, aw)
    assert msda_cuda.launches == before + 1
    want = msda.ms_deform_attn_plain(value, LEVELS_352x480, loc, aw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    value, loc, aw = (_t(a).to(cuda) for a in _inputs(6))
    with pytest.raises(ValueError, match="head width"):
        msda_cuda.ms_deform_attn_cuda(value, SHAPES, loc, aw)
    value, loc, aw = (_t(a).to(cuda) for a in _inputs(8))
    with pytest.raises(ValueError, match="contiguous"):
        msda_cuda.ms_deform_attn_cuda(value, SHAPES,
                                      loc.transpose(0, 1).contiguous()
                                      .transpose(0, 1), aw)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,d", [
    (8, 100, 16),          # the decoder's cross-attention
    (4, 6930, 8),          # the dense-query encoder: every token a query
    (2, 37, 4)])
def test_backward_kernel_matches_plain_on_card(cuda, b, lq, d):
    """``csrc/msda_bwd.cu`` through the dispatch's autograd against the
    plain version's gradients, at the sparse family's shapes (as
    ``test_kernel_matches_plain_on_card``): value, locations and weights
    each within 1e-4 of the largest plain gradient (other summation orders,
    and the value's by atomics)."""
    value, loc, aw = (_t(a).to(cuda).requires_grad_(True) for a in _inputs(
        d, LEVELS_352x480, b=b, m=8, lq=lq, p=4, seed=6, spread=0.1))
    cot = torch.randn(b, lq, 8 * d, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(0))
    before = msda_cuda.bwd_launches
    got = torch.autograd.grad(msda.ms_deform_attn(
        value, LEVELS_352x480, loc, aw), (value, loc, aw), cot)
    assert msda_cuda.bwd_launches == before + 1
    want = msda.ms_deform_attn_bwd_plain(value, LEVELS_352x480, loc, aw, cot)
    for name, g, w in zip(("value", "locations", "weights"), got, want):
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= 1e-4, (name, err)


@pytest.mark.cuda
def test_backward_kernel_zero_weights_and_far_samples(cuda):
    """Samples with a zero attention weight get no location gradient and
    add nothing to the value's; samples far outside every level (and
    queries at the edges) get zero gradients, no NaN."""
    value, loc, aw = (_t(a).to(cuda) for a in _inputs(
        8, LEVELS_352x480, b=2, m=8, lq=50, p=4, seed=8, spread=0.1))
    aw[:, :10] = 0.0
    loc[:, 10:20] = 40.0
    cot = torch.randn(2, 50, 64, device=cuda)
    d_value, d_loc, d_aw = msda_cuda.ms_deform_attn_bwd_cuda(
        value, LEVELS_352x480, loc, aw, cot)
    for g in (d_value, d_loc, d_aw):
        assert torch.isfinite(g).all()
    assert not d_loc[:, :10].any()
    assert not d_loc[:, 10:20].any() and not d_aw[:, 10:20].any()
    want = msda.ms_deform_attn_bwd_plain(value, LEVELS_352x480, loc, aw, cot)
    for g, w in zip((d_value, d_loc, d_aw), want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.cuda
def test_backward_kernel_at_whole_pixels(cuda):
    """Locations that land on whole pixels, as the decoder's initial
    reference grid does on some levels: there the location gradient is a
    one-sided corner difference, and the kernel picks the plain version's
    side (it rounds ``u * W - 0.5`` as the plain version does), so all
    three gradients stay within 1e-4 of the largest plain one."""
    value, loc, aw = (_t(a).to(cuda) for a in _inputs(
        8, LEVELS_352x480, b=2, m=8, lq=64, p=4, seed=9, spread=0.0))
    gen = torch.Generator(cuda).manual_seed(1)
    for lvl, (h, w) in enumerate(LEVELS_352x480):
        for axis, n in ((0, w), (1, h)):
            pix = torch.randint(0, n, loc[:, :, :, lvl, :, axis].shape,
                                generator=gen, device=cuda)
            loc[:, :, :, lvl, :, axis] = (pix + 0.5) / n
    cot = torch.randn(2, 64, 64, device=cuda, generator=gen)
    got = msda_cuda.ms_deform_attn_bwd_cuda(value, LEVELS_352x480, loc, aw,
                                            cot)
    want = msda.ms_deform_attn_bwd_plain(value, LEVELS_352x480, loc, aw, cot)
    for name, g, w in zip(("value", "locations", "weights"), got, want):
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= 1e-4, (name, err)


# The forward's slots a group forced (msda_cuda.FWD_SLOTS, at most a warp):
# one slot of D/4 lanes per (image, query, head), and a warp.
FORCE = {"one_slot": 1, "warp": 32}
# (B, Lq, D, levels): the decoder, the dense encoder, Lq off every chunk,
# and a Sintel-size level (55x128) too large for shared memory at D=16.
PATH_SHAPES = {
    "decoder": (8, 100, 16, LEVELS_352x480),
    "encoder": (4, 6930, 8, LEVELS_352x480),
    "ragged-D4": (2, 1037, 4, LEVELS_352x480),
    "large-level-D16": (2, 2000, 16, [(55, 128), (28, 64)]),
}


def _card_case(cuda, shape, seed, spread=0.1):
    b, lq, d, levels = PATH_SHAPES[shape]
    value, loc, aw = (_t(a).to(cuda) for a in _inputs(
        d, levels, b=b, m=8, lq=lq, p=4, seed=seed, spread=spread))
    return value, loc, aw, levels


def _bwd_errors(got, want):
    return {name: float((g - w).abs().max() / w.abs().max())
            for name, g, w in zip(("value", "locations", "weights"), got,
                                  want)}


def _bands(levels, rows):
    return sum(-(-h // r) for (h, _), r in zip(levels, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(PATH_SHAPES))
@pytest.mark.parametrize("path", list(FORCE))
def test_forced_path_matches_plain_on_card(cuda, monkeypatch, path, shape):
    """The forward with one slot a group and with a warp at each shape
    (1e-4), and the backward's three gradients (1e-4 of the largest plain
    one), against the plain versions; the large level is cut into bands
    in the backward."""
    monkeypatch.setattr(msda_cuda, "FWD_SLOTS", FORCE[path])
    value, loc, aw, levels = _card_case(cuda, shape, seed=11)
    b, lq, d = value.shape[0], loc.shape[1], value.shape[-1]
    cot = torch.randn(b, lq, 8 * d, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(2))
    got = msda_cuda.ms_deform_attn_cuda(value, levels, loc, aw)
    got_d = msda_cuda.ms_deform_attn_bwd_cuda(value, levels, loc, aw, cot)
    assert msda_cuda.fwd_slots(d) == (1 if path == "one_slot" else 128 // d)
    rows = msda_cuda.plan(levels, b, lq, 8, 4, d,
                          msda_cuda.sm_count(cuda))["band_rows"]
    assert (shape == "large-level-D16") == (_bands(levels, rows) > len(levels))
    want = msda.ms_deform_attn_plain(value, levels, loc, aw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    want_d = msda.ms_deform_attn_bwd_plain(value, levels, loc, aw, cot)
    errs = _bwd_errors(got_d, want_d)
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["ragged-D4", "encoder"])
def test_backward_bands_of_one_row_on_card(cuda, monkeypatch, shape):
    """Bands of a single row (BAND_BYTES cut to one row of the widest level
    beside its chunks of samples): the samples that straddle two bands add
    to both, their owner (the band of the top row) writes d_aw and d_loc,
    and the gradients still match the plain version."""
    value, loc, aw, levels = _card_case(cuda, shape, seed=12, spread=0.2)
    b, lq, d = value.shape[0], loc.shape[1], value.shape[-1]
    monkeypatch.setattr(msda_cuda, "BAND_BYTES", msda_cuda.bwd_block_bytes(
        max(w for _, w in levels), lq, 4, d))
    rows = msda_cuda.plan(levels, b, lq, 8, 4, d,
                          msda_cuda.sm_count(cuda))["band_rows"]
    assert rows[0] == 1, rows
    cot = torch.randn(b, lq, 8 * d, device=cuda)
    got = msda_cuda.ms_deform_attn_bwd_cuda(value, levels, loc, aw, cot)
    errs = _bwd_errors(got, msda.ms_deform_attn_bwd_plain(value, levels, loc,
                                                          aw, cot))
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["decoder", "encoder"])
@pytest.mark.parametrize("path", list(FORCE))
def test_zero_weights_far_samples_and_whole_pixels_on_card(cuda, monkeypatch,
                                                           path, shape):
    """At each forced launch of the forward, and in the backward: samples with a
    zero weight add nothing and get no location gradient; samples far
    outside every level (and a NaN one) get zero gradients and no NaN;
    whole-pixel locations pick the plain version's corners (both kernels
    round ``u * W - 0.5`` as it does)."""
    monkeypatch.setattr(msda_cuda, "FWD_SLOTS", FORCE[path])
    value, loc, aw, levels = _card_case(cuda, shape, seed=13)
    b, lq, d = value.shape[0], loc.shape[1], value.shape[-1]
    gen = torch.Generator(cuda).manual_seed(3)
    third = lq // 3
    for lvl, (h, w) in enumerate(levels):
        for axis, n in ((0, w), (1, h)):
            pix = torch.randint(0, n, loc[:, third:, :, lvl, :, axis].shape,
                                generator=gen, device=cuda)
            loc[:, third:, :, lvl, :, axis] = (pix + 0.5) / n
    aw[:, :10] = 0.0
    loc[:, 10:20] = 40.0
    loc[:, 20, 0, 0, 0, 0] = float("nan")
    cot = torch.randn(b, lq, 8 * d, device=cuda, generator=gen)
    got = msda_cuda.ms_deform_attn_cuda(value, levels, loc, aw)
    d_value, d_loc, d_aw = msda_cuda.ms_deform_attn_bwd_cuda(
        value, levels, loc, aw, cot)
    for g in (got, d_value, d_loc, d_aw):
        assert torch.isfinite(g).all()
    assert not d_loc[:, :10].any()
    assert not d_loc[:, 10:20].any() and not d_aw[:, 10:20].any()
    assert not d_loc[:, 20, 0, 0, 0].any() and d_aw[:, 20, 0, 0, 0].eq(0).all()
    plain_loc = loc.clone()
    plain_loc[:, 20, 0, 0, 0, 0] = 40.0   # the kernels' NaN: no corner
    want = msda.ms_deform_attn_plain(value, levels, plain_loc, aw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    errs = _bwd_errors((d_value, d_loc, d_aw), msda.ms_deform_attn_bwd_plain(
        value, levels, plain_loc, aw, cot))
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["decoder", "encoder"])
def test_backward_needs_no_zero_fill_on_card(cuda, shape):
    """The backward writes every element of its outputs, which the wrapper
    allocates with ``torch.empty``: memory left full of NaN by a freed
    tensor of the same size does not show through."""
    value, loc, aw, levels = _card_case(cuda, shape, seed=14)
    cot = torch.randn(value.shape[0], loc.shape[1], 8 * value.shape[-1],
                      device=cuda)
    poison = [torch.full_like(t, float("nan")) for t in (value, loc, aw)]
    del poison
    got = msda_cuda.ms_deform_attn_bwd_cuda(value, levels, loc, aw, cot)
    for g in got:
        assert torch.isfinite(g).all()
    errs = _bwd_errors(got, msda.ms_deform_attn_bwd_plain(value, levels, loc,
                                                          aw, cot))
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["decoder", "encoder", "large-level-D16"])
def test_location_and_weight_gradients_are_bit_reproducible(cuda, shape):
    """d_loc and d_aw are written once by their owner block, with no
    atomics: three runs give the same bits. (d_value's shares are summed in
    an order that shared-memory atomics set.)"""
    value, loc, aw, levels = _card_case(cuda, shape, seed=15)
    cot = torch.randn(value.shape[0], loc.shape[1], 8 * value.shape[-1],
                      device=cuda)
    first = msda_cuda.ms_deform_attn_bwd_cuda(value, levels, loc, aw, cot)
    for _ in range(2):
        again = msda_cuda.ms_deform_attn_bwd_cuda(value, levels, loc, aw, cot)
        assert torch.equal(first[1], again[1])
        assert torch.equal(first[2], again[2])


@pytest.mark.cuda
def test_forward_takes_a_level_too_wide_for_the_backward(cuda):
    """The backward's one-row band must fit shared memory, the forward has
    no such limit: a level 4000 pixels wide at D=16 runs forward within
    1e-4 of the plain version, and the backward refuses it."""
    levels = [(2, 4000), (1, 1000)]
    assert msda_cuda.bwd_block_bytes(4000, 100, 4, 16) > msda_cuda.SMEM_BYTES
    value, loc, aw = (_t(a).to(cuda) for a in _inputs(
        16, levels, b=1, m=8, lq=100, p=4, seed=16, spread=0.1))
    got = msda_cuda.ms_deform_attn_cuda(value, levels, loc, aw)
    want = msda.ms_deform_attn_plain(value, levels, loc, aw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="pixels wide"):
        msda_cuda.ms_deform_attn_bwd_cuda(value, levels, loc, aw,
                                          torch.randn_like(got))
