"""Gradients of the port's update-block kernels, and of RAFT's training
forward through every kernel, against the JAX package on the CPU.

Every kernel of ``raft_tpu_torch`` is differentiable on the card through a
``torch.autograd.Function``: the correlation lookup through
``WindowedCorrelationFn`` (backward kernel ``csrc/corr_bwd.cu``; its tests
are in ``tests/test_torch_corr.py``), the update-block kernels through
``RecomputeFn`` (backward = the plain version recomputed, as the JAX custom
VJPs do). The CUDA kernels cannot run here, so these tests run each
Function with the plain version injected in the kernel's place and check
its wiring against plain autograd, and check the gradients against
``jax.grad`` through the JAX custom VJPs, the Pallas kernels run by the
interpreter. Tolerances are stated per test; the card's own check is the
``cuda``-marked test at the end.
"""

import os
import re

import numpy as np
import pytest
import torch

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.models.update import BasicUpdateBlock
from raft_tpu_torch.ops import corr_cuda, gru_cuda, motion_cuda, step_cuda
from raft_tpu_torch.weights import load_npz, state_dict_from_flax

try:
    import jax
    import jax.numpy as jnp

    from raft_tpu.models.update import BasicUpdateBlock as JaxUpdateBlock
    from raft_tpu.utils.torch_convert import convert_state_dict
except ModuleNotFoundError:
    # The card's machine has no JAX; only the ``cuda`` tests run there:
    #   python -m pytest --noconftest tests/test_torch_grad.py -m cuda
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "assets", "golden", "weights.npz")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads per xdist worker (see tests/test_torch_raft.py),
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


# -- the update-block kernels -------------------------------------------------

def _inject_plain(monkeypatch):
    """Route the port's kernels through their Functions with the plain
    version as the forward callable, as they run on the card: the corr
    Function with both kernels replaced by plain code, the update-block
    Functions with ``run`` = the plain version."""
    monkeypatch.setattr(corr_cuda, "windowed_correlation_cuda",
                        corr_cuda.windowed_correlation_fused_plain)
    monkeypatch.setattr(corr_cuda, "windowed_correlation_bwd_cuda",
                        corr_cuda.windowed_correlation_bwd_plain)
    monkeypatch.setattr(
        corr_cuda, "windowed_correlation_fused",
        lambda f1, pyr, c, r, scale=True, rescale=True: corr_cuda
        .WindowedCorrelationFn.apply(f1, c, r, scale, rescale, *pyr))
    monkeypatch.setattr(
        step_cuda, "fused_step",
        lambda net, inp, cor, flo, convs, packed: step_cuda
        .fused_step_autograd(net, inp, cor, flo, convs,
                             lambda *a: step_cuda.fused_step_plain(*a,
                                                                   convs)))
    monkeypatch.setattr(
        motion_cuda, "motion_encoder",
        lambda flo, cor, convs, packed: motion_cuda.motion_encoder_autograd(
            flo, cor, convs,
            lambda f, c: motion_cuda.motion_encoder_plain(f, c, convs)))
    monkeypatch.setattr(
        gru_cuda, "sepconv_gru",
        lambda h, x, convs, packed: gru_cuda.sepconv_gru_autograd(
            h, x, convs, lambda h, x: gru_cuda.sepconv_gru_plain(h, x,
                                                                 convs)))


@pytest.fixture(scope="module")
def block_case():
    """RAFT-large's update block with the fixture weights, inputs on a
    5x6 map and cotangents for (net, mask, delta): numpy arrays."""
    rng = np.random.default_rng(5)
    shape = (1, 5, 6)
    arrays = (np.tanh(rng.standard_normal((*shape, 128))),
              np.maximum(rng.standard_normal((*shape, 128)), 0),
              rng.standard_normal((*shape, 324)),
              3.0 * rng.standard_normal((*shape, 2)))
    cots = (rng.standard_normal((*shape, 128)),
            rng.standard_normal((*shape, 576)),
            rng.standard_normal((*shape, 2)))
    with np.load(WEIGHTS) as z:
        state = {k[len("update_block."):]: np.asarray(z[k], np.float32)
                 for k in z.files if k.startswith("update_block.")}
    return ([a.astype(np.float32) for a in arrays],
            [c.astype(np.float32) for c in cots], state)


def _block_grads(block_case, update_impl, compute_mask):
    """Gradients of sum(out * cot) for the inputs and every parameter of
    the port's block: (inputs, {name: grad})."""
    arrays, cots, state = block_case
    block = BasicUpdateBlock()
    block.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    leaves = _leaves(*arrays)
    out = block(*leaves, compute_mask=compute_mask, update_impl=update_impl)
    loss = sum((o * _t(c)).sum() for o, c in zip(out, cots) if o is not None)
    names, params = zip(*block.named_parameters())
    grads = _grads(loss, [*leaves, *params])
    return grads[:4], dict(zip(names, grads[4:]))


@pytest.mark.parametrize("update_impl,compute_mask", [
    ("step", True), ("step", None), ("chain", True)])
def test_functions_with_plain_forward_match_plain_autograd(
        block_case, monkeypatch, update_impl, compute_mask):
    """The step ('mg' and 'mgf'), motion and GRU Functions (x as parts)
    with the plain forward injected give the gradients of plain autograd
    for the four inputs and every parameter of the block: the same
    arithmetic, recomputed, so equal to 1e-6 (the Function's backward
    re-runs the convolutions, which may pick another algorithm)."""
    want_in, want = _block_grads(block_case, update_impl, compute_mask)
    _inject_plain(monkeypatch)
    got_in, got = _block_grads(block_case, update_impl, compute_mask)
    for a, b in zip(got_in, want_in):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert set(got) == set(want)
    for name, g in want.items():
        if g is None:        # the mask head, skipped at 'mgf'
            assert got[name] is None, name
            continue
        torch.testing.assert_close(got[name], g, rtol=0, atol=1e-6,
                                   msg=name)


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("update_impl", ["step", "chain"])
def test_block_gradients_match_jax_custom_vjps(block_case, monkeypatch,
                                               update_impl):
    """The training iteration of the update block ('mg' step kernel, or
    the motion kernel then the GRU kernel with x as parts, then the heads)
    through the port's Functions against ``jax.grad`` of the flax block
    with the same Pallas kernels forced (``RAFT_*_PALLAS=1``, run by the
    interpreter, their custom VJPs recomputing through the jnp twins):
    gradients of the inputs and of every parameter, the JAX ones carried
    into torch layout by ``state_dict_from_flax``. Bar 2e-5 of each
    gradient's largest entry: float32, other summation orders through six
    to nine convolutions."""
    arrays, cots, state = block_case
    step = update_impl == "step"
    monkeypatch.setenv("RAFT_STEP_PALLAS", "1" if step else "0")
    monkeypatch.setenv("RAFT_MOTION_PALLAS", "0" if step else "1")
    monkeypatch.setenv("RAFT_GRU_PALLAS", "0" if step else "1")
    npz = {f"update_block.{k}": v for k, v in state.items()}
    params = convert_state_dict(npz)["params"]["update"]["update_block"]
    jblock = JaxUpdateBlock()

    def loss(p, *xs):
        out = jblock.apply({"params": p}, *xs, compute_mask=True)
        return sum(jnp.sum(o * c) for o, c in zip(out, cots))

    jgrads = _compiled(jax.grad(loss, argnums=(0, 1, 2, 3, 4)), params,
                       *(jnp.asarray(a) for a in arrays))
    want = state_dict_from_flax({"params": jgrads[0]})

    _inject_plain(monkeypatch)
    got_in, got = _block_grads(block_case, update_impl, True)
    for a, b in zip(got_in, jgrads[1:]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-5 * np.abs(b).max())
    assert set(got) == set(want)
    for name, g in got.items():
        b = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), b, rtol=0,
                                   atol=2e-5 * np.abs(b).max(), err_msg=name)


def _cancelled_by_norm(name: str) -> bool:
    """The encoders' conv biases but the final projection's feed a norm
    (fnet's instance norms, cnet's batch norms on batch statistics), which
    subtracts them again: their gradient is 0 up to rounding."""
    return re.fullmatch(r"[fc]net\.(conv1|layer\d\.\d\.(conv\d|downsample"
                        r"\.0))\.bias", name) is not None


def test_raft_gradients_reach_every_parameter_on_the_function_route(
        monkeypatch):
    """The training forward of RAFT-large (on-demand correlation, 64x64,
    iters=2) through every Function with the plain forward injected, as
    it runs on the card: every parameter of ``update_block``, ``fnet`` and
    ``cnet`` gets a gradient, equal to plain autograd's to 1e-5 of its
    largest entry (fnet's through the correlation's backward). It is
    non-zero, except for the conv biases in front of the encoders' norms,
    which the norm cancels: theirs is rounding noise below 1e-7."""
    rng = np.random.default_rng(7)
    img1 = rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    img2 = np.roll(img1, (2, -3), axis=(1, 2))
    weights = load_npz(WEIGHTS)

    def grads(impl):
        model = RAFT(RAFTConfig(alternate_corr=True))
        model.load_state_dict(weights)
        preds = model(_t(img1), _t(img2), iters=2, train=True,
                      update_impl=impl)
        assert preds.shape == (2, 1, 64, 64, 2)
        preds.square().mean().backward()
        return {n: p.grad for n, p in model.named_parameters()}

    want = {impl: grads(impl) for impl in ("step", "chain")}
    _inject_plain(monkeypatch)
    for impl in ("step", "chain"):
        got = grads(impl)
        for name, g in got.items():
            assert g is not None, (impl, name)
            if _cancelled_by_norm(name):
                assert float(g.abs().max()) < 1e-7, (impl, name)
                continue
            assert torch.count_nonzero(g) > 0, (impl, name)
            b = want[impl][name]
            torch.testing.assert_close(g, b, rtol=0,
                                       atol=1e-5 * float(b.abs().max()),
                                       msg=f"{impl} {name}")


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("update_impl", ["step", "chain"])
def test_raft_gradients_on_card_match_plain(cuda, monkeypatch, update_impl):
    """One training forward and backward of RAFT-large on the card
    through the kernels (corr_fwd, corr_bwd and the update-block kernels)
    against the same twice with the plain versions (TF32 off): every
    parameter of ``update_block``, ``fnet`` and ``cnet`` gets a gradient,
    equal to the plain one to 1e-4 of its largest entry, or to 4 times the
    plain route's own spread between its two runs where that is larger
    (both routes sum the lookup's gradient with float atomics in no fixed
    order). The conv biases a norm cancels are noise, left out."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(9)
    img1 = _t(rng.uniform(0, 255, (2, 128, 160, 3))).to(cuda)
    img2 = torch.roll(img1, (2, -3), dims=(1, 2))
    weights = load_npz(WEIGHTS)

    def grads():
        model = RAFT(RAFTConfig(alternate_corr=True))
        model.load_state_dict(weights)
        model.to(cuda)
        preds = model(img1, img2, iters=3, train=True,
                      update_impl=update_impl)
        preds.square().mean().backward()
        return {n: p.grad for n, p in model.named_parameters()}

    before = corr_cuda.bwd_launches
    got = grads()
    assert corr_cuda.bwd_launches == before + 3
    monkeypatch.setattr(corr_cuda, "windowed_correlation_fused",
                        corr_cuda.windowed_correlation_fused_plain)
    monkeypatch.setattr(
        step_cuda, "fused_step",
        lambda net, inp, cor, flo, convs, packed:
        step_cuda.fused_step_plain(net, inp, cor, flo, convs))
    monkeypatch.setattr(
        motion_cuda, "motion_encoder",
        lambda flo, cor, convs, packed:
        motion_cuda.motion_encoder_plain(flo, cor, convs))
    monkeypatch.setattr(
        gru_cuda, "sepconv_gru",
        lambda h, x, convs, packed: gru_cuda.sepconv_gru_plain(h, x, convs))
    want, again = grads(), grads()
    for name, g in got.items():
        assert g is not None, name
        if _cancelled_by_norm(name):
            continue
        scale = float(want[name].abs().max())
        spread = float((again[name] - want[name]).abs().max()) / scale
        rel = float((g - want[name]).abs().max()) / scale
        assert rel <= max(1e-4, 4 * spread), (name, rel, spread)
