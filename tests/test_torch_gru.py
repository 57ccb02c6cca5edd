"""The port's SepConvGRU cell against the JAX package, and the CUDA
kernel's weight layout.

The same seeded numpy inputs and seeded weights of the flax module's shapes
(``sparse_fixture.filled_init``, carried into the port by
``state_dict_from_flax``) go through the flax ``SepConvGRU`` (conv
path), the TPU kernel run by the Pallas interpreter, and the port. Hidden
states are of order 1; float32 convolutions summed in different orders
agree to about 1e-6, so the bar is 1e-5 (relative to that unit scale).
"""

import numpy as np
import pytest
import torch

import sparse_fixture as fixture
from raft_tpu_torch.models.update import SepConvGRU
from raft_tpu_torch.ops import gru_cuda
from raft_tpu_torch.weights import state_dict_from_flax

try:
    import jax
    import jax.numpy as jnp

    from raft_tpu.models.update import SepConvGRU as JaxSepConvGRU
    from raft_tpu.ops import gru_pallas
except ModuleNotFoundError:
    # The card's machine has no JAX; only the ``cuda`` tests run there:
    #   python -m pytest --noconftest tests/test_torch_gru.py -m cuda
    jax = None

TOL = 1e-5
B, H, W, C, CX = 2, 6, 7, 16, 24


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
def gru_setup():
    rng = np.random.default_rng(0)
    h = np.tanh(rng.standard_normal((B, H, W, C))).astype(np.float32)
    x = rng.standard_normal((B, H, W, CX)).astype(np.float32)
    jmodel = JaxSepConvGRU(hidden_dim=C)
    variables = fixture.filled_init(jmodel, jnp.asarray(h), jnp.asarray(x),
                                    seed=0)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(h), jnp.asarray(x)))
    module = SepConvGRU(C, CX)
    module.load_state_dict(state_dict_from_flax(variables))
    return variables, module, h, x, want


def test_plain_matches_flax(gru_setup):
    _, module, h, x, want = gru_setup
    got = gru_cuda.sepconv_gru_plain(_t(h), _t(x), module.convs())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=0)


def test_module_on_cpu_runs_the_plain_version(gru_setup):
    _, module, h, x, want = gru_setup
    with torch.inference_mode():
        got = module(_t(h), _t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_plain_matches_pallas_interpret(gru_setup):
    """Against the TPU kernel itself, run by the Pallas interpreter."""
    variables, module, h, x, _ = gru_setup
    p = variables["params"]

    def pair(name):
        return (p[name]["kernel"], p[name]["bias"])

    mats = gru_pallas.pack_weights(
        (pair("convz1"), pair("convr1"), pair("convq1")),
        (pair("convz2"), pair("convr2"), pair("convq2")), C)
    want = gru_pallas.sepconv_gru(jnp.asarray(h), jnp.asarray(x), mats,
                                  interpret=True)
    got = gru_cuda.sepconv_gru_plain(_t(h), _t(x), module.convs())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)


def _kernel_math(h, x, packed):
    """The arithmetic of csrc/sepconv_gru.cu written with torch ops: each
    half is an implicit GEMM over (tap, [h | x] channel) rows of the packed
    weights, reading the tap-shifted pixel or zero outside the image."""
    w_zr1, b_zr1, w_q1, b_q1, w_zr2, b_zr2, w_q2, b_q2 = (
        (t[0] + t[1]).t() if t.dim() == 3 else t for t in packed)  # hi + lo
    c = h.shape[-1]

    def shifted(t, d, vertical):
        out = torch.zeros_like(t)
        axis = 1 if vertical else 2
        n = t.shape[axis]
        src = slice(max(d, 0), n + min(d, 0))
        dst = slice(max(-d, 0), n - max(d, 0))
        if vertical:
            out[:, dst] = t[:, src]
        else:
            out[:, :, dst] = t[:, :, src]
        return out

    def conv(a, w, b, vertical):
        cols = torch.cat([shifted(a, t - 2, vertical) for t in range(5)], -1)
        return cols @ w + b

    for w_zr, b_zr, w_q, b_q, vertical in (
            (w_zr1, b_zr1, w_q1, b_q1, False), (w_zr2, b_zr2, w_q2, b_q2, True)):
        zr = torch.sigmoid(conv(torch.cat([h, x], -1), w_zr, b_zr, vertical))
        z, r = zr[..., :c], zr[..., c:]
        q = torch.tanh(conv(torch.cat([r * h, x], -1), w_q, b_q, vertical))
        h = (1 - z) * h + z * q
    return h


def test_packed_weights_reproduce_the_cell(gru_setup):
    """The packed layout the CUDA kernel reads (tap-major rows, [h | x]
    input channels, z‖r merged on the output axis, each matrix transposed
    as TF32 hi and lo) computes the same cell as the module's own
    convolutions."""
    _, module, h, x, want = gru_setup
    packed = gru_cuda.pack_weights(module.convs())
    k = 5 * (C + CX)
    assert [tuple(t.shape) for t in packed] == [
        (2, 2 * C, k), (2 * C,), (2, C, k), (C,)] * 2
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in packed)
    got = _kernel_math(_t(h), _t(x), packed)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_packed_weights_are_cached_until_the_weights_change(gru_setup):
    _, module, _, _, _ = gru_setup
    first = module.packed_weights()
    assert module.packed_weights() is first
    fresh = SepConvGRU(C, CX)
    fresh.load_state_dict(module.state_dict())
    before = fresh.packed_weights()
    old_bias = fresh.convq2.bias.detach().clone()
    with torch.no_grad():
        fresh.convq2.bias.add_(1.0)
    after = fresh.packed_weights()
    assert after is not before
    assert torch.equal(after[7], old_bias + 1.0)


def test_cuda_wrapper_refuses_cpu_tensors(gru_setup):
    _, module, h, x, _ = gru_setup
    with pytest.raises(ValueError, match="CUDA"):
        gru_cuda.sepconv_gru_cuda(_t(h), _t(x),
                                  gru_cuda.pack_weights(module.convs()))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(24, 32), (55, 128)])
def test_kernel_matches_plain_on_card(cuda, hw, monkeypatch):
    """The kernel against its plain version on the card at RAFT-large's
    widths (C=128, Cx=256) and the golden and Sintel feature shapes, TF32
    off for the plain convolutions. Bar 1e-4 (summation order)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(3)
    h, w = hw
    module = SepConvGRU(128, 256).to(cuda)
    hid = _t(np.tanh(rng.standard_normal((1, h, w, 128)))).to(cuda)
    x = _t(rng.standard_normal((1, h, w, 256))).to(cuda)
    before = gru_cuda.launches
    with torch.inference_mode():
        got = module(hid, x)
        want = gru_cuda.sepconv_gru_plain(hid, x, module.convs())
    assert gru_cuda.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(24, 32), (55, 128)])
def test_parts_kernel_matches_plain_on_card(cuda, hw, monkeypatch):
    """The kernel's parts form, x = (inp, [motion | flow]) read where the
    parts lie, against the plain version (which concatenates). Bar 1e-4."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(4)
    h, w = hw
    module = SepConvGRU(128, 256).to(cuda)
    hid = _t(np.tanh(rng.standard_normal((1, h, w, 128)))).to(cuda)
    inp = _t(np.maximum(rng.standard_normal((1, h, w, 128)), 0)).to(cuda)
    mot = _t(rng.standard_normal((1, h, w, 128))).to(cuda)
    before = gru_cuda.launches
    with torch.inference_mode():
        got = module(hid, (inp, mot))
        want = gru_cuda.sepconv_gru_plain(hid, (inp, mot), module.convs())
    assert gru_cuda.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bhw", [(1, 13, 17), (8, 46, 62)])
def test_kernel_matches_plain_at_ragged_m_and_batch(cuda, bhw, monkeypatch):
    """The tile's edges: M = B*H*W = 221 is not a multiple of the tile's
    64 rows, and at the chairs feature shape (B=8, 46x62) the 5x1 half's
    taps must not read rows of the neighbouring image. x as parts, against
    the plain version. Bar 1e-4."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(7)
    b, h, w = bhw
    module = SepConvGRU(128, 256).to(cuda)
    hid = _t(np.tanh(rng.standard_normal((b, h, w, 128)))).to(cuda)
    inp = _t(np.maximum(rng.standard_normal((b, h, w, 128)), 0)).to(cuda)
    mot = _t(rng.standard_normal((b, h, w, 128))).to(cuda)
    with torch.inference_mode():
        got = gru_cuda.sepconv_gru_cuda(hid, (inp, mot),
                                        module.packed_weights())
        want = gru_cuda.sepconv_gru_plain(hid, (inp, mot), module.convs())
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
