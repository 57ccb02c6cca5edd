"""The port's motion encoder against the JAX package, the CUDA kernel's
weight layout, and the kernel build's cache key.

The same seeded numpy inputs and seeded weights of the flax module's shapes
(``sparse_fixture.filled_init``, carried into the port by
``state_dict_from_flax``) go through ``motion_pallas``'s plain jnp
twin and its TPU kernel run by the Pallas interpreter, and through the
port. Features are of order 1; float32 convolutions summed in different
orders agree to about 1e-6, so the bar is 1e-5. The flow passthrough is a
copy and must agree exactly.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import sparse_fixture as fixture
import torch_conv_replay as replay
from raft_tpu_torch.models.update import BasicMotionEncoder
from raft_tpu_torch.ops import build, motion_cuda
from raft_tpu_torch.weights import state_dict_from_flax

try:
    import jax
    import jax.numpy as jnp

    from raft_tpu.models.update import BasicMotionEncoder as JaxMotionEncoder
    from raft_tpu.ops import motion_pallas
except ModuleNotFoundError:
    # The card's machine has no JAX; only the ``cuda`` tests run there:
    #   python -m pytest --noconftest tests/test_torch_motion.py -m cuda
    jax = None

TOL = 1e-5
B, H, W, CC = 2, 9, 7, 12


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


@pytest.fixture(scope="module")
def motion_setup():
    """Flax weights, the port's module, the JAX packing, and the jnp twin's
    output, at an odd width and height so every border tap is live."""
    rng = np.random.default_rng(0)
    flow = (3.0 * rng.standard_normal((B, H, W, 2))).astype(np.float32)
    corr = rng.standard_normal((B, H, W, CC)).astype(np.float32)
    variables = fixture.filled_init(JaxMotionEncoder(), jnp.asarray(flow),
                                    jnp.asarray(corr), seed=0)
    # jitted: eager, the twin's ~70 tap matmuls dispatch op by op and take
    # several times longer on the CPU
    p = variables["params"]
    mats = motion_pallas.pack_weights(*(
        (p[n]["kernel"], p[n]["bias"])
        for n in ("convc1", "convc2", "convf1", "convf2", "conv")))
    want = jax.jit(motion_pallas.reference_motion, static_argnums=0)(
        (W, H), jnp.asarray(flow).reshape(B, H * W, 2),
        jnp.asarray(corr).reshape(B, H * W, CC), mats)
    module = BasicMotionEncoder(CC)
    module.load_state_dict(state_dict_from_flax(variables))
    return module, mats, flow, corr, np.asarray(want).reshape(B, H, W, 128)


def test_plain_matches_reference_motion(motion_setup):
    module, _, flow, corr, want = motion_setup
    got = motion_cuda.motion_encoder_plain(_t(flow), _t(corr),
                                           module.convs()).detach().numpy()
    assert got.shape == (B, H, W, motion_cuda.OUT_CHANNELS)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[..., 126:], flow)


def test_plain_matches_pallas_interpret(motion_setup):
    """Against the TPU kernel itself, run by the Pallas interpreter."""
    module, mats, flow, corr, _ = motion_setup
    # compiled at a low XLA optimisation level: less time than running the
    # interpreter op by op, the same float32 arithmetic up to a few ulp
    fn = jax.jit(lambda f, c: motion_pallas.motion_encoder(
        f, c, mats, interpret=True))
    want = fn.lower(flow, corr).compile(
        compiler_options=fixture.FAST_COMPILE)(flow, corr)
    with torch.inference_mode():
        got = module(_t(flow), _t(corr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_packed_weights_reproduce_the_encoder(motion_setup):
    """The packed layout csrc/motion_fwd.cu reads (tap-major rows, Cc
    padded to 16 with zero rows, the flow's 49 taps x 2 channels then zero
    rows, 126 columns padded to 128, each matrix transposed as TF32 hi and
    lo) computes the same encoder."""
    module, _, flow, corr, want = motion_setup
    packed = module.packed_weights()
    assert [tuple(t.shape) for t in packed] == [
        tuple(s) for s in motion_cuda.packed_shapes(CC)]
    assert [tuple(t.shape) for t in packed[:6]] == [
        (2, 256, 16), (256,), (2, 192, 9 * 256), (192,), (2, 128, 112),
        (128,)]
    assert all(t.is_contiguous() and t.dtype == torch.float32
               for t in packed)
    got = replay.motion(_t(flow), _t(corr), packed)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=0)


def test_cuda_wrapper_refuses_cpu_tensors(motion_setup):
    module, _, flow, corr, _ = motion_setup
    with pytest.raises(ValueError, match="CUDA"):
        motion_cuda.motion_encoder_cuda(_t(flow), _t(corr),
                                        module.packed_weights())


def test_lib_path_follows_the_headers(tmp_path, monkeypatch):
    """A library is named by its source, every csrc header and the flags:
    an edited header gives every kernel a new library (no stale build), an
    edited source only its own. Needs no nvcc."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    before = {n: build.lib_path(n) for n in build.KERNELS}
    assert os.path.dirname(before["motion_fwd"]) == build.BUILD_DIR
    header = csrc / "conv_phase.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    edited = {n: build.lib_path(n) for n in build.KERNELS}
    assert all(edited[n] != before[n] for n in build.KERNELS)
    source = csrc / "motion_fwd.cu"
    source.write_bytes(source.read_bytes() + b"\n")
    again = {n: build.lib_path(n) for n in build.KERNELS}
    assert [n for n in build.KERNELS if again[n] != edited[n]] == [
        "motion_fwd"]


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(24, 32), (55, 128)])
def test_kernel_matches_plain_on_card(cuda, hw, monkeypatch):
    """The kernel against its plain version on the card at RAFT-large's
    widths (Cc=324) and the golden and Sintel feature shapes, TF32 off for
    the plain convolutions. Bar 1e-4 (summation order); the flow channels
    exactly."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(5)
    h, w = hw
    module = BasicMotionEncoder().to(cuda)
    flow = _t(rng.uniform(-20, 20, (1, h, w, 2))).to(cuda)
    corr = _t(rng.standard_normal((1, h, w, 324))).to(cuda)
    before = motion_cuda.launches
    with torch.inference_mode():
        got = module(flow, corr)
        want = motion_cuda.motion_encoder_plain(flow, corr, module.convs())
    assert motion_cuda.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert torch.equal(got[..., 126:], flow)
