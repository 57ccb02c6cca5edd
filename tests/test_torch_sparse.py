"""The sparse family (``SparseRAFT``) in the port against the JAX package on
the CPU, and the pieces the port added for it.

Both packages get the same weights (flax variables filled from a numpy
seed, carried into the port by ``sparse_state_dict_from_flax``) and the
same seeded frames, at the tiny configuration (``tests/sparse_fixture.py``,
64x96, B=2). JAX runs each configuration once, compiled; its correlation is
the jnp lookup (the Pallas kernel is TPU-only). Bars, each stated where it
is used: whole-model outputs to 1e-4 * max(1, max|JAX|) (float32 through
two encoders, a transformer and sigmoid/logit chains; the flows are the
normalised key flows times the image size); the resize to 1e-6 of the
largest magnitude; the fork lookup to 1e-5.
"""

import numpy as np
import pytest
import torch

import sparse_fixture as fixture
from raft_tpu_torch import evaluate
from raft_tpu_torch.config import OursConfig
from raft_tpu_torch.models import corr
from raft_tpu_torch.models.ours import SparseRAFT
from raft_tpu_torch.ops import corr_cuda, sampling
from raft_tpu_torch.weights import (sparse_state_dict_from_flax,
                                    state_dict_to_npz)

try:
    import jax
    import jax.numpy as jnp

    from raft_tpu.models import corr as jcorr
except ModuleNotFoundError:
    # The card's machine has no JAX; only the ``cuda`` tests run there:
    #   python -m pytest --noconftest tests/test_torch_sparse.py -m cuda
    jnp = None

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


@pytest.fixture(scope="module")
def jax_runs():
    """{encoder_iterations: (variables, JAX outputs)} for 0 and 1, and the
    frames (``sparse_fixture.tiny_variables``, ``jax_forward``)."""
    img1, img2 = fixture.frames(2)
    runs = {n: (variables, fixture.jax_forward(fixture.jax_model(n),
                                               variables, img1, img2))
            for n, variables in fixture.tiny_variables().items()}
    return runs, (img1, img2)


def _port(variables, **cfg):
    model = SparseRAFT(OursConfig(**fixture.TINY, **cfg))
    model.load_state_dict(sparse_state_dict_from_flax(variables))
    return model.eval()


def _close(got, want):
    want = np.asarray(want)
    bar = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=bar, rtol=0)


@pytest.mark.parametrize("encoder_iterations", [0, 1])
@pytest.mark.parametrize("alternate_corr", [True, False])
def test_slice_matches_jax(jax_runs, encoder_iterations, alternate_corr):
    """test_mode's (flow_low, flow_up) and every entry of
    (flow_predictions, sparse_predictions), through both correlation
    engines, against JAX's on-demand engine."""
    runs, (img1, img2) = jax_runs
    variables, (low, up, flows, sparse) = runs[encoder_iterations]
    model = _port(variables, encoder_iterations=encoder_iterations,
                  alternate_corr=alternate_corr)
    with torch.no_grad():
        got_low, got_up = model(_t(img1), _t(img2), test_mode=True)
        got_flows, got_sparse = model(_t(img1), _t(img2))
    _close(got_low, low)
    _close(got_up, up)
    assert len(got_flows) == len(flows) == fixture.TINY["outer_iterations"]
    for g, w in zip(got_flows, flows):
        _close(g, w)
    for g, w in zip(got_sparse, sparse):
        for a, b in zip(g, w):      # src_points, key_flow, masks, scores
            _close(a, b)


def test_converter_consumes_every_leaf(jax_runs):
    """Every leaf of both trees fills a key of the port's state dict and
    every key is filled (``strict=True``); a leaf without a rule raises."""
    runs, _ = jax_runs
    for n, (variables, _) in runs.items():
        state = sparse_state_dict_from_flax(variables)
        model = SparseRAFT(OursConfig(**fixture.TINY, encoder_iterations=n))
        model.load_state_dict(state, strict=True)
        leaves = len(jax.tree_util.tree_leaves(variables))
        # + num_batches_tracked per batch norm, + the norm3 aliases
        extra = sum(k.endswith(("num_batches_tracked", ))
                    or ".downsample.1." in k for k in state)
        assert len(state) == leaves + extra
    odd = {"params": {"decoder_0": {"ffn": {"linear1": {"gain": np.ones(3)}}}}}
    with pytest.raises(ValueError, match="unhandled flax leaf"):
        sparse_state_dict_from_flax(odd)
    with pytest.raises(ValueError, match="unhandled batch statistic"):
        sparse_state_dict_from_flax({"batch_stats": {"x": {"n": {
            "mean2": np.ones(2)}}}})


def test_fixture_is_current(jax_runs):
    """The committed ``assets/golden/sparse_tiny.npz`` is what
    ``tests/sparse_fixture.py`` makes today: the same weights bit for bit,
    the same pair, and JAX's flow_up for it (at B=1 there, B=2 here) within
    the slice's bar: JAX's own flow for one pair moves by 2e-5 of its
    largest value between the two batch sizes (XLA fuses and sums in
    another order)."""
    runs, (img1, img2) = jax_runs
    variables, (_, up, _, _) = runs[0]
    cfg, state, f1, f2, flow_up = fixture.load_fixture()
    assert cfg == fixture.TINY
    want = sparse_state_dict_from_flax(variables)
    assert set(state) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(state[k], v.numpy().astype(np.float32),
                                      err_msg=k)
    np.testing.assert_array_equal(f1, img1[0])
    np.testing.assert_array_equal(f2, img2[0])
    _close(torch.from_numpy(flow_up), up[0])


def test_predictor_entry_points(jax_runs, tmp_path, capsys):
    """``load_predictor(model_family="sparse")``: from "random" at the full
    OursConfig (finite flows of the image's shape), from a state-dict
    archive and from the fixture (the model's own numbers); the CLI's
    sparse golden; the RAFT-only levers refused."""
    runs, (img1, img2) = jax_runs
    full = evaluate.load_predictor("random", model_family="sparse",
                                   device="cpu")
    assert full.model.config == OursConfig()
    low, up = full(img1[0], img2[0])
    assert low.shape == (8, 12, 2) and up.shape == (64, 96, 2)
    assert np.isfinite(up).all()

    variables, _ = runs[0]
    model = _port(variables)
    path = str(tmp_path / "sparse.npz")
    state_dict_to_npz(model.state_dict(), path)
    pred = evaluate.load_predictor(path, model_family="sparse",
                                   config=OursConfig(**fixture.TINY),
                                   device="cpu")
    with torch.no_grad():
        _, want = model(_t(img1[:1]), _t(img2[:1]), test_mode=True)
    np.testing.assert_array_equal(pred(img1[0], img2[0])[1], want[0].numpy())

    res = evaluate.main(["--model_family", "sparse", "--model",
                         evaluate.SPARSE_GOLDEN, "--dataset", "golden",
                         "--device", "cpu"])
    assert res["sparse_parity_epe"] < 1e-3
    assert "Validation Golden[sparse]" in capsys.readouterr().out

    for kwargs in ({"alternate_corr": True}, {"update_impl": "chain"},
                   {"corr_impl": "auto"}):
        with pytest.raises(ValueError, match="canonical RAFT"):
            evaluate.load_predictor("random", model_family="sparse",
                                    config=OursConfig(**fixture.TINY),
                                    device="cpu", **kwargs)
    with pytest.raises(ValueError, match="model_family"):
        evaluate.load_predictor("random", model_family="dual_query",
                                device="cpu")


def test_refusals():
    model = SparseRAFT(OursConfig(**fixture.TINY))
    img = torch.zeros(1, 64, 96, 3)
    with pytest.raises(ValueError, match="flow_init"):
        model(img, img, flow_init=torch.zeros(1, 8, 12, 2))
    with pytest.raises(NotImplementedError, match="training slice"):
        model(img, img, train=True)
    with pytest.raises(NotImplementedError):
        SparseRAFT(OursConfig(mixed_precision=True))
    with pytest.raises(ValueError, match="perfect square"):
        SparseRAFT(OursConfig(**{**fixture.TINY, "num_keypoints": 5}))


# -- the pieces -----------------------------------------------------------------

@pytest.mark.parametrize("shape_in,shape_out", [
    ((1000, 16), (11, 16)), ((1000, 16), (46, 16)), ((1000, 16), (60, 16)),
    ((2, 64, 96, 2), (2, 8, 12, 2)),         # test_mode's flow_low
    ((2, 16, 24, 2), (2, 64, 96, 2))])       # the x4 flow to the image
def test_resize_linear_matches_jax(shape_in, shape_out):
    """``resize_linear`` against ``jax.image.resize(..., "linear")``, which
    antialiases when it shrinks. Bar 1e-6 of the largest magnitude: float32
    sums of a few dozen terms (for the position tables, 1000 -> 11 sums 91
    taps a row)."""
    x = np.random.default_rng(1).standard_normal(shape_in).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape_out, "linear"))
    got = sampling.resize_linear(_t(x), shape_out).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def fork_case():
    """The fork's lookup: C=192 (the middle level of OursConfig), 2 levels,
    radius 4, at the half-pixel centres of a 6x7 map."""
    rng = np.random.default_rng(2)
    f1 = rng.standard_normal((2, 6, 7, 192)).astype(np.float32)
    f2 = rng.standard_normal((2, 6, 7, 192)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(7) + 0.5, np.arange(6) + 0.5), -1)
    centers = np.ascontiguousarray(
        np.broadcast_to(grid[None], (2, 6, 7, 2)), np.float32)
    return f1, f2, centers


def test_fork_lookup_matches_jax(fork_case):
    """Both engines with ``rescale=False`` against JAX's
    ``alternate_lookup(backend="jnp")`` and ``pyramid_lookup``, bar 1e-5."""
    f1, f2, centers = fork_case

    def both(a, b, c):
        return (jcorr.alternate_lookup(a, jcorr.build_feature_pyramid(b, 2),
                                       c, 4, backend="jnp", rescale=False),
                jcorr.pyramid_lookup(jcorr.build_corr_pyramid(a, b, 2), c, 4,
                                     rescale=False))

    want_alt, want_mat = jax.jit(both)(f1, f2, centers)
    got_alt = corr.AlternateCorrBlock(_t(f1), _t(f2), 2, 4,
                                      rescale=False)(_t(centers))
    got_plain = corr_cuda.windowed_correlation_fused_plain(
        _t(f1), corr.build_feature_pyramid(_t(f2), 2), _t(centers), 4,
        rescale=False)
    got_mat = corr.CorrBlock(_t(f1), _t(f2), 2, 4, rescale=False)(
        _t(centers))
    for got, want in ((got_alt, want_alt), (got_plain, want_alt),
                      (got_mat, want_mat)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def test_rescale_default_is_the_canonical_lookup(fork_case):
    """``rescale=True`` stays the default and samples level l at
    ``coords / 2**l`` bit for bit as before; ``rescale=False`` differs."""
    f1, f2, centers = fork_case
    pyr = corr.build_feature_pyramid(_t(f2), 2)
    coords = _t(centers) * 1.7
    canonical = torch.cat([corr_cuda.windowed_correlation(
        _t(f1), f2l, coords / (2 ** lvl), 4) for lvl, f2l in enumerate(pyr)],
        dim=-1)
    assert torch.equal(corr.alternate_lookup(_t(f1), pyr, coords, 4),
                       canonical)
    assert not torch.equal(
        corr.alternate_lookup(_t(f1), pyr, coords, 4, rescale=False),
        canonical)


def test_corr_backward_refuses_the_fork_lookup(fork_case):
    """The corr backward kernel has no rescale=False form yet: the wrapper
    raises rather than give wrong gradients."""
    f1, f2, centers = fork_case
    with pytest.raises(NotImplementedError, match="training slice"):
        corr_cuda.windowed_correlation_bwd_cuda(
            _t(f1), corr.build_feature_pyramid(_t(f2), 2), _t(centers),
            torch.zeros(2, 6, 7, 162), 4, rescale=False)


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("channels", [128, 192, 256])
def test_fork_lookup_kernel_matches_plain_on_card(channels):
    """``csrc/corr_fwd.cu`` with ``rescale=False`` at OursConfig's level
    widths (the 352x480 stride-8 map, 2 levels, r=4, half-pixel centres)
    against its plain version. Bar 1e-4: sums in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    h, w = 44, 60
    f1 = _t(rng.standard_normal((2, h, w, channels))).to(dev)
    pyr = corr.build_feature_pyramid(
        _t(rng.standard_normal((2, h, w, channels))).to(dev), 2)
    grid = np.stack(np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5), -1)
    centers = _t(np.ascontiguousarray(
        np.broadcast_to(grid[None], (2, h, w, 2)))).to(dev)
    before = corr_cuda.launches
    got = corr.alternate_lookup(f1, pyr, centers, 4, rescale=False)
    assert corr_cuda.launches == before + 1
    want = corr_cuda.windowed_correlation_fused_plain(f1, pyr, centers, 4,
                                                      rescale=False)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
