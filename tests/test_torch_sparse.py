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

Training (the sparse family's train step, its loss, dropout, ``train()``):
one tiny train step (dropout 0, ``sparse_lambda=0.1``, B=2 at 64x96)
against ``raft_tpu.parallel.make_train_step`` from the same variables,
compiled once for this file at a low XLA optimisation level (float rounding
aside, the same arithmetic).
"""

import numpy as np
import pytest
import torch

import sparse_fixture as fixture
from raft_tpu_torch import evaluate
from raft_tpu_torch import train as train_mod
from raft_tpu_torch.config import OursConfig, RAFTConfig, TrainConfig
from raft_tpu_torch.losses import sparse_keypoint_loss
from raft_tpu_torch.models import corr
from raft_tpu_torch.models.deformable import SelfAttention, dropout
from raft_tpu_torch.models.ours import SparseRAFT
from raft_tpu_torch.ops import corr_cuda, sampling
from raft_tpu_torch.parallel.train_step import (create_train_state,
                                                make_train_step)
from raft_tpu_torch.weights import (load_npz, sparse_state_dict_from_flax,
                                    state_dict_to_npz)

try:
    import jax
    import jax.numpy as jnp

    from raft_tpu.config import TrainConfig as JaxTrainConfig
    from raft_tpu.losses import sparse_keypoint_loss as jax_sparse_loss
    from raft_tpu.models import corr as jcorr
    from raft_tpu.optim import fetch_optimizer as jax_fetch_optimizer
    from raft_tpu.parallel.train_step import make_train_step as jax_step
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
    """``flow_init``, mixed precision and a non-square keypoint count are
    refused; ``train=True`` runs: the two prediction lists, the flows and
    key flows with a ``grad_fn``."""
    model = SparseRAFT(OursConfig(**fixture.TINY))
    img = torch.zeros(1, 64, 96, 3)
    with pytest.raises(ValueError, match="flow_init"):
        model(img, img, flow_init=torch.zeros(1, 8, 12, 2))
    flows, sparse = model(img, img, train=True)
    assert len(flows) == len(sparse) == fixture.TINY["outer_iterations"]
    assert all(f.shape == (1, 64, 96, 2) and f.grad_fn is not None
               for f in flows)
    assert all(key_flow.grad_fn is not None for _, key_flow, _, _ in sparse)
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
    """The corr backward kernel takes the fork lookup now: its wrapper
    refuses CPU tensors (it launches or raises, with no CPU fallback), and
    the lookup on the CPU has gradients for fmap1 and every level."""
    f1, f2, centers = fork_case
    pyr = corr.build_feature_pyramid(_t(f2), 2)
    with pytest.raises(ValueError, match="CUDA"):
        corr_cuda.windowed_correlation_bwd_cuda(
            _t(f1), pyr, _t(centers), torch.zeros(2, 6, 7, 162), 4,
            rescale=False)
    df1, df2s = corr_cuda.windowed_correlation_bwd_plain(
        _t(f1), pyr, _t(centers), torch.ones(2, 6, 7, 162), 4, rescale=False)
    assert df1.shape == f1.shape and df1.abs().max() > 0
    assert [d.shape for d in df2s] == [p.shape for p in pyr]
    assert all(d.abs().max() > 0 for d in df2s)


@pytest.mark.parametrize("channels", [48, 192])
def test_fork_lookup_gradients_match_jax(channels, monkeypatch):
    """The fork lookup's gradients to fmap1 and fmap2 (through the pooled
    pyramid) against JAX's VJP of ``alternate_lookup(backend="jnp",
    rescale=False)``, on the CPU's plain lookup and on
    ``WindowedCorrelationFn`` with the plain versions in the kernels'
    places (the card's autograd wiring, no coordinate gradient). C=48 is
    the tiny configuration's masked-lane width, 192 OursConfig's middle
    level. Bar 1e-5 of each gradient's largest entry."""
    rng = np.random.default_rng(channels)
    f1 = rng.standard_normal((2, 6, 7, channels)).astype(np.float32)
    f2 = rng.standard_normal((2, 6, 7, channels)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(7) + 0.5, np.arange(6) + 0.5), -1)
    centers = np.ascontiguousarray(
        np.broadcast_to(grid[None], (2, 6, 7, 2)), np.float32)
    cot = rng.standard_normal((2, 6, 7, 162)).astype(np.float32)

    def lookup(a, b):
        return jcorr.alternate_lookup(a, jcorr.build_feature_pyramid(b, 2),
                                      centers, 4, backend="jnp",
                                      rescale=False)

    want = [np.asarray(g) for g in jax.jit(
        lambda a, b, c: jax.vjp(lookup, a, b)[1](c))(f1, f2, cot)]

    def function_route(a, pyr, c, r, rescale):
        return corr_cuda.WindowedCorrelationFn.apply(a, c, r, True, rescale,
                                                     "float32", *pyr)

    for route in (corr_cuda.windowed_correlation_fused, function_route):
        if route is function_route:
            monkeypatch.setattr(corr_cuda, "windowed_correlation_cuda",
                                corr_cuda.windowed_correlation_fused_plain)
            monkeypatch.setattr(corr_cuda, "windowed_correlation_bwd_cuda",
                                corr_cuda.windowed_correlation_bwd_plain)
        a, b = (_t(x).requires_grad_(True) for x in (f1, f2))
        out = route(a, corr.build_feature_pyramid(b, 2), _t(centers), 4,
                    rescale=False)
        got = torch.autograd.grad(out, (a, b), _t(cot))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


# -- training ----------------------------------------------------------------

ADAM_EXACT = 1e-7       # 10 x Adam's eps


def _train_batch():
    """A seeded B=2 64x96 batch (numpy): the fixture's two pairs, a random
    flow with a few entries above MAX_FLOW, and a validity mask."""
    rng = np.random.default_rng(21)
    img1, img2 = fixture.frames(2)
    flow = (3.0 * rng.standard_normal((2, *fixture.HW, 2))).astype(
        np.float32)
    flow[0, :2, :3] = 500.0
    valid = (rng.uniform(size=(2, *fixture.HW)) > 0.2).astype(np.float32)
    return {"image1": img1, "image2": img2, "flow": flow, "valid": valid}


def _train_cfg(**kw):
    return {**dict(model_family="sparse", batch_size=2,
                   image_size=fixture.HW, num_steps=100, sparse_lambda=0.1),
            **kw}


def _jax_sparse_step(variables, batch):
    """One step of ``raft_tpu.parallel.make_train_step`` for the sparse
    family from ``variables``, on a state with flat parameter and
    statistics vectors (``sparse_fixture.flat_train_state``: the same
    arithmetic; XLA compiles the optimizer over the 311 leaves in two
    minutes otherwise): (metrics, updated variables), numpy."""
    state, unflatten = fixture.flat_train_state(
        fixture.jax_model(0), variables,
        jax_fetch_optimizer(JaxTrainConfig(**_train_cfg())))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    step = jax_step(JaxTrainConfig(**_train_cfg()), donate=False).lower(
        state, jbatch, key).compile(compiler_options=fixture.FAST_COMPILE)
    state, metrics = step(state, jbatch, key)
    return {k: float(v) for k, v in metrics.items()}, unflatten(state)


@pytest.fixture(scope="module")
def both_sparse_steps(jax_runs):
    """JAX's and the port's sparse train step from the tiny variables
    (dropout 0, ``sparse_lambda=0.1``) on one B=2 64x96 batch: (JAX
    metrics, JAX's updated variables as the port's state dict, the port's
    metrics, its state, its clipped gradients). At 32x48 the stride-32
    token level is 1x2: its one-channel group norms over two tokens make
    the gradient ill-conditioned, and float32 rounding alone moves it by up
    to a fifth between the packages."""
    runs, _ = jax_runs
    variables = runs[0][0]
    batch = _train_batch()
    jmetrics, jvariables = _jax_sparse_step(variables, batch)
    want = sparse_state_dict_from_flax(jvariables)

    model = _port(variables).train()
    tcfg = TrainConfig(**_train_cfg())
    state = create_train_state(model, tcfg)
    metrics = make_train_step(tcfg)(state, {k: _t(v)
                                            for k, v in batch.items()})
    grads = {n: p.grad for n, p in model.named_parameters()}
    return jmetrics, want, metrics, state, grads


def test_sparse_train_step_metrics_match_jax(both_sparse_steps):
    """Loss, ``sparse_loss`` and the EPE metrics to 1e-4 relative, the
    pre-clip gradient norm to 1e-4 relative (float32 through two trunks,
    a transformer and the backward, summed in other orders); neither step
    skipped, and the auxiliary loss active (step 0 < sparse_lambda_steps:
    the loss is the sequence loss plus 0.1 of it)."""
    jmetrics, _, metrics, state, _ = both_sparse_steps
    assert state.step == 1 and metrics["skipped_steps"] == 0.0
    assert jmetrics["skipped_steps"] == 0.0
    assert metrics["sparse_loss"] > 0
    for k in ("loss", "sparse_loss", "epe", "1px", "3px", "5px",
              "grad_norm"):
        assert metrics[k] == pytest.approx(jmetrics[k], rel=1e-4,
                                           abs=1e-6), k


def test_sparse_train_step_updates_match_jax(both_sparse_steps):
    """Every parameter after one clipped AdamW update at the one-cycle
    start rate (lr = 4e-4 / 25) to lr / 8 where the port's gradient entry
    is at least ADAM_EXACT, the bar of ``tests/test_torch_train_step.py``;
    Adam's first update is lr * g / (|g| + 1e-8), so entries whose gradient
    is rounding noise (the biases a following batch, instance or
    one-channel group norm subtracts again) move by up to lr either way on
    each side, and are held to 2 lr. ``CNNDecoder``'s batch-norm running
    statistics (trained on both images' batch) to 1e-5, and the converter
    and the npz archive carry the trained state, statistics included."""
    _, want, _, state, grads = both_sparse_steps
    got = state.model.state_dict()
    lr = 4e-4 / 25
    assert set(got) == set(want)
    for name, b in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        diff = (got[name] - b).abs()
        if "running" in name:
            assert float(diff.max()) <= 1e-5, name
            continue
        g = grads.get(name)
        if g is None:                   # downsample.1, an alias of norm3
            continue
        exact = g.abs() >= ADAM_EXACT
        if bool(exact.any()):
            assert float(diff[exact].max()) <= lr / 8, name
        assert float(diff.max()) <= 2 * lr, name
    assert int(got["cnn_decoder.trunk.norm1.num_batches_tracked"]) == 1


def test_trained_state_round_trips(jax_runs, both_sparse_steps, tmp_path):
    """A trained ``SparseRAFT`` through ``state_dict_to_npz`` and
    ``load_npz`` into a fresh model: every entry back bit for bit, running
    statistics and counters included; the statistics moved in training."""
    runs, _ = jax_runs
    start = sparse_state_dict_from_flax(runs[0][0])
    trained = both_sparse_steps[3].model.state_dict()
    path = str(tmp_path / "sparse_trained.npz")
    state_dict_to_npz(trained, path)
    again = SparseRAFT(OursConfig(**fixture.TINY))
    again.load_state_dict(load_npz(path))
    for k, v in again.state_dict().items():
        assert torch.equal(v, trained[k]), k
    stats = [k for k in trained if k.startswith("cnn_decoder")
             and "running" in k]
    assert stats and all(not torch.equal(trained[k], start[k])
                         for k in stats)


def test_sparse_keypoint_loss_matches_jax():
    """``sparse_keypoint_loss`` against JAX's on seeded keypoints (over
    [-0.05, 1.05], so some read the ground truth outside the image), flows
    with entries above MAX_FLOW and a partial validity mask, three
    iterations. Bar 1e-5 relative: float32 sums of a few hundred terms."""
    rng = np.random.default_rng(5)
    flow = (4.0 * rng.standard_normal((2, 20, 30, 2))).astype(np.float32)
    flow[1, 3:6, 4:9] = 600.0
    valid = (rng.uniform(size=(2, 20, 30)) > 0.3).astype(np.float32)
    preds = [(rng.uniform(-0.05, 1.05, (2, 9, 2)).astype(np.float32),
              (5.0 * rng.standard_normal((2, 9, 2))).astype(np.float32))
             for _ in range(3)]
    want = float(jax.jit(jax_sparse_loss)(preds, flow, valid))
    got = float(sparse_keypoint_loss([tuple(map(_t, p)) for p in preds],
                                     _t(flow), _t(valid)))
    assert got == pytest.approx(want, rel=1e-5)


def test_dropout_follows_flax():
    """``deformable.dropout`` is flax's ``nn.Dropout``: the identity when
    deterministic (no generator) or at rate 0; else each entry kept with
    probability 1 - rate (measured over 120,000 draws: within 0.01) and
    scaled by 1 / (1 - rate), the rest zeroed; one mask over the axes of
    ``mask_shape`` shared along its size-1 axes (flax's
    ``broadcast_dropout`` of the attention weights: batch and heads share
    the (queries, keys) mask); the same seed gives the same masks."""
    x = torch.ones(4, 3, 100, 100)
    assert dropout(x, 0.25, None) is x
    assert dropout(x, 0.0, torch.Generator().manual_seed(0)) is x
    y = dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(y, dropout(x, 0.25, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, dropout(x, 0.25,
                                      torch.Generator().manual_seed(1)))
    shared = dropout(x, 0.25, torch.Generator().manual_seed(0),
                     (1, 1, 100, 100))
    assert torch.equal(shared, shared[:1, :1].expand_as(shared))

    attn = SelfAttention(16, 4, dropout=0.5)
    q = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        still = attn(q, q, q)
        assert torch.equal(attn(q, q, q, None), still)
        dropped = attn(q, q, q, torch.Generator().manual_seed(3))
        again = attn(q, q, q, torch.Generator().manual_seed(3))
    assert torch.equal(dropped, again) and not torch.equal(dropped, still)


def test_training_forward_dropout_and_norms():
    """``SparseRAFT.forward(train=True)`` at dropout 0.1: the generator's
    seed fixes the dropout (the same seed, the same flows; another seed,
    other flows), training without a generator is refused, and
    ``train=False`` ignores a generator (no dropout, running statistics).
    ``CNNDecoder``'s batch norms move their running statistics only when
    training without ``freeze_bn``."""
    torch.manual_seed(0)
    model = SparseRAFT(OursConfig(**{**fixture.TINY, "dropout": 0.1}))
    img1, img2 = (_t(a) for a in fixture.frames(1))
    stats = model.cnn_decoder.trunk.norm1.running_mean

    def run(seed, **kw):
        before = stats.clone()
        with torch.no_grad():
            flows, _ = model(img1, img2, generator=torch.Generator()
                             .manual_seed(seed), **kw)
        return flows[-1], not torch.equal(stats, before)

    a, moved_a = run(0, train=True, freeze_bn=True)
    b, _ = run(0, train=True, freeze_bn=True)
    c, _ = run(1, train=True, freeze_bn=True)
    d, moved_d = run(0, train=False)
    with torch.no_grad():
        want, _ = model(img1, img2)
    _, moved_e = run(0, train=True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(d, want[-1])
    assert not (moved_a or moved_d) and moved_e
    with pytest.raises(ValueError, match="generator"):
        model(img1, img2, train=True)


def test_train_runs_the_sparse_family_on_the_cpu(tmp_path):
    """``train(TrainConfig(model_family="sparse", sparse_lambda=0.1),
    OursConfig(...), device="cpu")`` on a 1-batch loader for 2 steps at
    the tiny configuration with dropout 0.1: finite metrics with
    ``sparse_loss``, the batch norms' counters at 2, every parameter
    moved; resumes from a ``state_dict_to_npz`` archive; a RAFTConfig or
    RAFT's levers for this family are refused."""
    batch = _train_batch()
    cfg = OursConfig(**{**fixture.TINY, "dropout": 0.1})
    tcfg = TrainConfig(**_train_cfg(num_steps=2))
    pushed = []

    class Logger:
        def push(self, metrics, lr):
            pushed.append(metrics)

    state = train_mod.train(tcfg, cfg, dataloader=[batch], device="cpu",
                            logger=Logger())
    assert state.step == 2 and len(pushed) == 2
    for m in pushed:
        assert m["skipped_steps"] == 0.0 and m["sparse_loss"] > 0
        assert np.isfinite(m["loss"]) and m["grad_norm"] > 0
    trained = state.model.state_dict()
    assert int(trained["cnn_decoder.trunk.norm1.num_batches_tracked"]) == 2
    start = SparseRAFT(cfg).init_weights(
        torch.Generator().manual_seed(tcfg.seed)).state_dict()
    assert all(not torch.equal(p.detach(), start[n])
               for n, p in state.model.named_parameters())

    path = str(tmp_path / "sparse.npz")
    state_dict_to_npz(trained, path)
    again = train_mod.train(TrainConfig(**_train_cfg(num_steps=1)), cfg,
                            dataloader=[batch], device="cpu",
                            restore_ckpt=path)
    assert int(again.model.state_dict()[
        "cnn_decoder.trunk.norm1.num_batches_tracked"]) == 3
    with pytest.raises(TypeError, match="OursConfig"):
        train_mod.train(tcfg, RAFTConfig(), dataloader=[batch],
                        device="cpu")
    for kw in ({"corr_impl": "fixed"}, {"update_impl": "chain"}):
        with pytest.raises(ValueError, match="canonical RAFT"):
            train_mod.train(tcfg, cfg, dataloader=[batch], device="cpu",
                            **kw)


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


@pytest.mark.cuda
@pytest.mark.parametrize("channels,h,w", [
    (128, 44, 60), (192, 22, 30), (256, 11, 15),   # OursConfig at 352x480
    (48, 8, 12), (64, 4, 6)])                      # the tiny configuration
def test_fork_lookup_backward_kernel_matches_plain_on_card(channels, h, w):
    """``csrc/corr_bwd.cu`` with ``rescale=False`` through
    ``WindowedCorrelationFn`` against autograd through the plain lookup at
    every width the sparse family's levels take (float4, float2 and masked
    float lanes): df1 and both df2 levels within 1e-4 of the largest plain
    gradient (other summation orders, df2 by atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(channels)
    f1 = _t(rng.standard_normal((2, h, w, channels))).to(dev)
    pyr = corr.build_feature_pyramid(
        _t(rng.standard_normal((2, h, w, channels))).to(dev), 2)
    grid = np.stack(np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5), -1)
    centers = _t(np.ascontiguousarray(
        np.broadcast_to(grid[None], (2, h, w, 2)))).to(dev)
    cot = _t(rng.standard_normal((2, h, w, 162))).to(dev)
    leaves = [t.clone().requires_grad_(True) for t in (f1, *pyr)]
    before = corr_cuda.bwd_launches
    got = torch.autograd.grad(corr.alternate_lookup(
        leaves[0], leaves[1:], centers, 4, rescale=False), leaves, cot)
    assert corr_cuda.bwd_launches == before + 1
    df1, df2s = corr_cuda.windowed_correlation_bwd_plain(
        f1, pyr, centers, cot, 4, rescale=False)
    for g, want in zip(got, (df1, *df2s)):
        assert float((g - want).abs().max() / want.abs().max()) <= 1e-4
