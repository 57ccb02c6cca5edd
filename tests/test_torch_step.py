"""The port's refine iteration against the JAX package, and the step
kernel's weight layout.

One flax ``BasicUpdateBlock``'s variables are filled from a seed
(``sparse_fixture.filled_init``) and carried into the port by
``state_dict_from_flax``; the same seeded numpy inputs go
through ``step_pallas.fused_step`` (the TPU kernel run by the Pallas
interpreter) at both depths, the flax block with ``RAFT_STEP_PALLAS=1``,
``gru_pallas.sepconv_gru`` with x as parts, and the port. Hidden states and
flow deltas are of order 1; float32 convolutions summed in different orders
agree to about 1e-6, so the bar is 1e-5.
"""

import numpy as np
import pytest
import torch

import sparse_fixture as fixture
import torch_conv_replay as replay
from raft_tpu_torch.models.update import BasicUpdateBlock
from raft_tpu_torch.ops import gru_cuda, motion_cuda, step_cuda
from raft_tpu_torch.weights import state_dict_from_flax

try:
    import jax
    import jax.numpy as jnp

    from raft_tpu.models.update import BasicUpdateBlock as JaxUpdateBlock
    from raft_tpu.ops import gru_pallas, motion_pallas, step_pallas
except ModuleNotFoundError:
    # The card's machine has no JAX; only the ``cuda`` tests run there:
    #   python -m pytest --noconftest tests/test_torch_step.py -m cuda
    jax = None

TOL = 1e-5
B, H, W, CC, C = 2, 9, 7, 12, 128


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads per xdist worker (see tests/test_torch_gru.py),
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


def _pairs(params, *names):
    return tuple((params[n]["kernel"], params[n]["bias"]) for n in names)


@pytest.fixture(scope="module")
def step_setup():
    """The flax block, its variables, the JAX packings, the port's block
    and the inputs (odd W, H not a multiple of any row tile)."""
    rng = np.random.default_rng(1)
    net = np.tanh(rng.standard_normal((B, H, W, C))).astype(np.float32)
    inp = rng.standard_normal((B, H, W, C)).astype(np.float32)
    corr = rng.standard_normal((B, H, W, CC)).astype(np.float32)
    flow = (3.0 * rng.standard_normal((B, H, W, 2))).astype(np.float32)
    arrays = (net, inp, corr, flow)
    jblock = JaxUpdateBlock()
    variables = fixture.filled_init(jblock, *(jnp.asarray(a)
                                              for a in arrays), seed=1)
    p = variables["params"]
    mmats = motion_pallas.pack_weights(*_pairs(
        p["encoder"], "convc1", "convc2", "convf1", "convf2", "conv"))
    gmats = gru_pallas.pack_weights(
        _pairs(p["gru"], "convz1", "convr1", "convq1"),
        _pairs(p["gru"], "convz2", "convr2", "convq2"), C)
    fmats = step_pallas.pack_flow_head(*_pairs(p["flow_head"], "conv1",
                                               "conv2"))
    block = BasicUpdateBlock(C, C, CC)
    block.load_state_dict(state_dict_from_flax(variables))
    return jblock, variables, (mmats, gmats, fmats), block.eval(), arrays


def _compiled(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at a low XLA optimisation level:
    less time than the default compile or than running the Pallas
    interpreter op by op, for the same float32 arithmetic up to a few
    ulp."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=fixture.FAST_COMPILE)(*args)


def _convs(block, depth):
    head = block.flow_head.convs() if depth == "mgf" else None
    return (block.encoder.convs(), block.gru.convs(), head)


def test_plan_fusion_has_a_depth_for_every_iteration():
    assert step_cuda.plan_fusion(True) == "mgf"
    assert step_cuda.plan_fusion(False) == "mg"


@pytest.mark.parametrize("depth", ["mg", "mgf"])
def test_plain_matches_pallas_fused_step(step_setup, depth):
    """Against the TPU step kernel, run by the Pallas interpreter."""
    _, _, (mmats, gmats, fmats), block, arrays = step_setup
    want = _compiled(lambda *a: step_pallas.fused_step(
        *a, mmats, gmats, fmats if depth == "mgf" else None,
        interpret=True), *arrays)
    got = step_cuda.fused_step_plain(*(_t(a) for a in arrays),
                                     _convs(block, depth))
    if depth == "mg":
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("compute_mask", [None, True])
def test_update_block_matches_flax_step_kernel(step_setup, monkeypatch,
                                               compute_mask):
    """The flax block with the step kernel forced (Pallas interpreter):
    'mgf' when the mask head is skipped, 'mg' and the heads otherwise.
    The port's block agrees through both update paths."""
    jblock, variables, _, block, arrays = step_setup
    monkeypatch.setenv("RAFT_STEP_PALLAS", "1")
    want = _compiled(lambda v, *a: jblock.apply(
        v, *a, compute_mask=compute_mask), variables, *arrays)
    for impl in ("step", "chain"):
        with torch.inference_mode():
            got = block(*(_t(a) for a in arrays), compute_mask=compute_mask,
                        update_impl=impl)
        for a, b in zip(got, want):
            if a is None or b is None:
                assert a is None and b is None
                continue
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                       rtol=0, err_msg=impl)


def test_gru_parts_match_pallas(step_setup):
    """The GRU's parts form: x = (inp, [motion | flow]) against the TPU
    GRU kernel given the same parts (Pallas interpreter)."""
    _, _, (mmats, gmats, _), block, (net, inp, corr, flow) = step_setup
    mot = motion_cuda.motion_encoder_plain(_t(flow), _t(corr),
                                           block.encoder.convs()).detach()
    want = gru_pallas.sepconv_gru(
        jnp.asarray(net), (jnp.asarray(inp), jnp.asarray(mot.numpy())),
        gmats, interpret=True)
    got = gru_cuda.sepconv_gru_plain(_t(net), (_t(inp), mot),
                                     block.gru.convs())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("depth", ["mg", "mgf"])
def test_packed_weights_reproduce_the_step(step_setup, depth):
    """The packed layouts csrc/update_step.cu reads, replayed in its phase
    order (motion; GRU over the parts [h | inp | motion]; flow head), give
    the plain step."""
    _, _, _, block, arrays = step_setup
    net, inp, corr, flow = (_t(a) for a in arrays)
    head = block.flow_head.packed_weights()
    assert [tuple(t.shape) for t in head] == [
        (2, 256, 9 * C), (256,), (9 * 256, 2), (2,)]
    mot = replay.motion(flow, corr, block.encoder.packed_weights())
    h2 = replay.gru(net, (inp, mot), block.gru.packed_weights())
    got = (h2,) if depth == "mg" else (h2, replay.flow_head(h2, head))
    want = step_cuda.fused_step_plain(net, inp, corr, flow,
                                      _convs(block, depth))
    want = (want,) if depth == "mg" else want
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=TOL, rtol=0)


def test_cuda_wrapper_refuses_cpu_tensors(step_setup):
    _, _, _, block, arrays = step_setup
    packed = (block.encoder.packed_weights(), block.gru.packed_weights(),
              None)
    with pytest.raises(ValueError, match="CUDA"):
        step_cuda.fused_step_cuda(*(_t(a) for a in arrays), packed)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", ["mg", "mgf"])
@pytest.mark.parametrize("hw", [(24, 32), (55, 128)])
def test_kernel_matches_plain_on_card(cuda, hw, depth, monkeypatch):
    """The step kernel against its plain version on the card at
    RAFT-large's widths and the golden and Sintel feature shapes, TF32 off
    for the plain convolutions. Bar 1e-4 (summation order)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(6)
    h, w = hw
    block = BasicUpdateBlock().to(cuda).eval()
    net = _t(np.tanh(rng.standard_normal((1, h, w, 128)))).to(cuda)
    inp = _t(np.maximum(rng.standard_normal((1, h, w, 128)), 0)).to(cuda)
    corr = _t(rng.standard_normal((1, h, w, 324))).to(cuda)
    flow = _t(rng.uniform(-20, 20, (1, h, w, 2))).to(cuda)
    before = step_cuda.launches
    with torch.inference_mode():
        got = block(net, inp, corr, flow,
                    compute_mask=None if depth == "mgf" else True)
        want = step_cuda.fused_step_plain(net, inp, corr, flow,
                                          _convs(block, depth))
    assert step_cuda.launches == before + 1
    want_h2 = want[0] if depth == "mgf" else want
    torch.testing.assert_close(got[0], want_h2, atol=1e-4, rtol=0)
    if depth == "mgf":
        torch.testing.assert_close(got[2], want[1], atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bhw,depth", [((1, 13, 17), "mg"),
                                       ((1, 13, 17), "mgf"),
                                       ((8, 46, 62), "mg")])
def test_kernel_matches_plain_at_ragged_shapes(cuda, bhw, depth,
                                               monkeypatch):
    """The tile's edges at the corr width Cc = 324 (not a multiple of the
    32-deep pipeline stage: convc1's last stage is half padding): M = 221
    is not a multiple of the tile's 64 rows, and a batch at the chairs
    feature shape (B=8, 46x62, the train step's 'mg') must not bleed
    across images. Against the plain version, bar 1e-4."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(8)
    b, h, w = bhw
    block = BasicUpdateBlock().to(cuda).eval()
    net = _t(np.tanh(rng.standard_normal((b, h, w, 128)))).to(cuda)
    inp = _t(np.maximum(rng.standard_normal((b, h, w, 128)), 0)).to(cuda)
    corr = _t(rng.standard_normal((b, h, w, 324))).to(cuda)
    flow = _t(rng.uniform(-20, 20, (b, h, w, 2))).to(cuda)
    head = block.flow_head.packed_weights() if depth == "mgf" else None
    packed = (block.encoder.packed_weights(), block.gru.packed_weights(),
              head)
    with torch.inference_mode():
        got = step_cuda.fused_step_cuda(net, inp, corr, flow, packed)
        want = step_cuda.fused_step_plain(net, inp, corr, flow,
                                          _convs(block, depth))
    if depth == "mg":
        got, want = (got,), (want,)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, atol=1e-4, rtol=0)
