"""The port's multi-scale deformable attention against the JAX package.

The same seeded numpy inputs go through ``raft_tpu_torch.ops.msda`` and
``raft_tpu.ops.msda`` on the CPU: the jnp core (bar 1e-5: both sum a few
dozen float32 products of values of order 1 in other orders) and the TPU
kernel ``msda_pallas._fwd_kernel`` through the Pallas interpreter, as
``tests/test_msda_pallas.py`` runs it (bar 1e-4: its hat-weight matmuls sum
every column of a level, zeros included). Locations span [-0.2, 1.2], so
zero padding is exercised; Lq = 37 is off a multiple of 128. The module
``MSDeformAttn`` is held against flax's with the same weights, in both
reference-point forms. The CUDA kernel is held against the plain version
in the ``cuda`` tests, which skip without a card.
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
    want = jax_msda(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                    jnp.asarray(aw), backend="jnp")
    assert got.shape == (B, LQ, M * value.shape[-1])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_plain_matches_pallas_interpret(case):
    value, loc, aw, got = case
    want = ms_deform_attn_pallas(jnp.asarray(value), SHAPES,
                                 jnp.asarray(loc), jnp.asarray(aw),
                                 interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_function_forward_is_its_callable_and_backward_raises():
    """``MSDeformAttnFn`` with the plain forward in the kernel's place:
    the same numbers, and a backward that raises instead of giving the
    value, locations and weights no gradient."""
    value, loc, aw = (_t(a).requires_grad_(True) for a in _inputs(8))
    out = msda_cuda.MSDeformAttnFn.apply(msda.ms_deform_attn_plain, value,
                                         SHAPES, loc, aw)
    with torch.no_grad():
        plain = msda.ms_deform_attn_plain(value, SHAPES, loc, aw)
    assert torch.equal(out, plain)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


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
