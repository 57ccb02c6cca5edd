"""RAFT-small in the port against the JAX package, on the CPU.

Modules at tiny widths take JAX's variables (``sparse_fixture.filled_init``:
the init's shapes filled from a seed) through ``state_dict_from_flax``;
the whole model takes ``assets/golden/weights_small.npz`` through both
packages' loaders. Bars: ``tests/test_torch_raft.py``'s ``TOL`` (1e-4) for
modules and flows; the goldens to the bars of ``tests/test_golden.py``.
JAX's ``ConvGRU`` computes ``convz`` and ``convr`` as one concatenated
convolution, the port as two: the sums differ in order only.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparse_fixture as fixture

from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.models import extractor as jextractor
from raft_tpu.models import update as jupdate
from raft_tpu.models.raft import RAFT as JaxRAFT
from raft_tpu.utils.torch_convert import convert_state_dict
from raft_tpu_torch import evaluate
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.data import frame_utils
from raft_tpu_torch.models.extractor import (BottleneckBlock, SmallEncoder,
                                             make_norm)
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.models.update import (ConvGRU, SmallMotionEncoder,
                                          SmallUpdateBlock)
from raft_tpu_torch.weights import load_npz, state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "assets", "golden")
WEIGHTS = os.path.join(GOLDEN, "weights_small.npz")
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads while this file runs: the suite's xdist workers
    share one CPU (as tests/test_torch_raft.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(module, variables):
    module.load_state_dict(state_dict_from_flax(variables))
    return module.eval()


def test_norm_none_is_the_identity():
    x = np.random.default_rng(0).standard_normal((1, 3, 4, 5)).astype(
        np.float32)
    norm = make_norm("none", 5)
    assert not list(norm.parameters())
    np.testing.assert_array_equal(norm(_t(x), True).numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(jextractor.Norm("none").apply({}, x)), x)
    with pytest.raises(ValueError, match="norm_fn"):
        make_norm("layer", 5)


@pytest.mark.parametrize("stride", [1, 2])
def test_bottleneck_block_matches_jax(stride):
    """Batch norm with running statistics from the seed, so that every
    norm (and at stride 2 the shortcut's ``norm4``, entered twice) has
    parameters to carry. The identity shortcut needs as many channels in
    as out."""
    cin = 32 if stride == 1 else 16
    x = np.random.default_rng(1).uniform(-1, 1, (2, 8, 12, cin)).astype(
        np.float32)
    jblock = jextractor.BottleneckBlock(32, "batch", stride)
    variables = fixture.filled_init(jblock, jnp.asarray(x), seed=2)
    want = jax.jit(jblock.apply)(variables, x)
    block = _port(BottleneckBlock(cin, 32, "batch", stride), variables)
    with torch.inference_mode():
        got = block(_nchw(x))
    _close(_nhwc(got), want)


@pytest.mark.parametrize("norm_fn", ["instance", "none"])
def test_small_encoder_matches_jax(norm_fn):
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 48, 3)).astype(
        np.float32)
    jenc = jextractor.SmallEncoder(40, norm_fn)
    variables = fixture.filled_init(jenc, jnp.asarray(x), seed=4)
    want = jax.jit(jenc.apply)(variables, x)
    enc = _port(SmallEncoder(40, norm_fn), variables)
    with torch.inference_mode():
        got = enc(_t(x))
    assert got.shape == (2, 4, 6, 40)
    _close(got.numpy(), want)


@pytest.fixture(scope="module")
def update_inputs():
    """RAFT-small's update inputs at a 4 x 6 map: hidden 96, context 64,
    4 levels of 7 x 7 windows."""
    rng = np.random.default_rng(5)
    shape = (1, 4, 6)
    net = np.tanh(rng.standard_normal((*shape, 96))).astype(np.float32)
    inp = np.maximum(rng.standard_normal((*shape, 64)), 0).astype(np.float32)
    corr = rng.standard_normal((*shape, 196)).astype(np.float32)
    flow = rng.uniform(-3, 3, (*shape, 2)).astype(np.float32)
    return net, inp, corr, flow


def test_conv_gru_matches_jax(update_inputs):
    net, inp = update_inputs[:2]
    x = np.concatenate([inp, update_inputs[2][..., :82]], axis=-1)
    jgru = jupdate.ConvGRU(96)
    variables = fixture.filled_init(jgru, jnp.asarray(net), jnp.asarray(x),
                                    seed=6)
    want = jax.jit(jgru.apply)(variables, net, x)
    gru = _port(ConvGRU(96, 146), variables)
    with torch.inference_mode():
        got = gru(_nchw(net), _nchw(x))
    _close(_nhwc(got), want)


def test_small_motion_encoder_matches_jax(update_inputs):
    corr, flow = update_inputs[2:]
    jenc = jupdate.SmallMotionEncoder()
    variables = fixture.filled_init(jenc, jnp.asarray(flow),
                                    jnp.asarray(corr), seed=7)
    want = jax.jit(jenc.apply)(variables, flow, corr)
    enc = _port(SmallMotionEncoder(196), variables)
    with torch.inference_mode():
        got = _nhwc(enc(_nchw(flow), _nchw(corr)))
    assert got.shape[-1] == 82
    _close(got, want)
    np.testing.assert_array_equal(got[..., 80:], flow)


@pytest.mark.parametrize("update_impl", ["step", "chain"])
def test_small_update_block_matches_jax(update_inputs, update_impl):
    """No mask head: the mask is None whatever ``compute_mask`` asks;
    ``update_impl`` is taken and ignored."""
    jblock = jupdate.SmallUpdateBlock(96)
    args = tuple(jnp.asarray(a) for a in update_inputs)
    variables = fixture.filled_init(jblock, *args, seed=8)
    jnet, jmask, jdelta = jax.jit(jblock.apply)(variables, *args)
    block = _port(SmallUpdateBlock(96, 64, 196), variables)
    with torch.inference_mode():
        net, mask, delta = block(*(_t(a) for a in update_inputs),
                                 compute_mask=True, update_impl=update_impl)
    assert mask is None and jmask is None
    _close(net.numpy(), jnet)
    _close(delta.numpy(), jdelta)


@pytest.fixture(scope="module")
def npz_state():
    with np.load(WEIGHTS) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}


def test_state_dict_round_trip_small(npz_state):
    """weights_small.npz -> JAX variables -> port state dict gives back
    every key and value, and the port's RAFT-small takes it strictly: the
    small scopes (ConvGRU, BottleneckBlock, SmallMotionEncoder) carry
    across."""
    back = state_dict_from_flax(convert_state_dict(npz_state))
    assert set(back) == set(npz_state)
    for k, v in npz_state.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    model = RAFT(RAFTConfig(small=True))
    model.load_state_dict(back)
    assert sum(p.numel() for p in model.parameters()) == 990_162


@pytest.fixture(scope="module")
def frames():
    """64x96 crops of the second golden pair, float32 in [0, 255]."""
    pair = json.load(open(os.path.join(GOLDEN, "manifest.json")))["pairs"][1]
    root = os.path.join(REPO, "assets", "demo-frames")
    ims = [np.asarray(frame_utils.read_gen(os.path.join(root, pair[k])),
                      np.float32)[32:96, 64:160]
           for k in ("frame1", "frame2")]
    return ims[0][None], ims[1][None]


@pytest.fixture(scope="module")
def small_model():
    model = RAFT(RAFTConfig(small=True))
    model.load_state_dict(load_npz(WEIGHTS))
    return model.eval()


@pytest.fixture(scope="module")
def jax_small_flows(npz_state, frames):
    """JAX's RAFT(small=True) (all-pairs engine) at 64x96, iters=3, from a
    seeded non-zero flow_init: ``(init, flow_low, flow_up)``."""
    img1, img2 = frames
    init = np.random.default_rng(9).uniform(-2, 2, (1, 8, 12, 2)).astype(
        np.float32)
    jmodel = JaxRAFT(JaxRAFTConfig(small=True))

    def forward(v, a, b, flow_init):
        return jmodel.apply(v, a, b, iters=3, test_mode=True,
                            flow_init=flow_init)

    args = (convert_state_dict(npz_state), img1, img2, init)
    jlow, jup = jax.jit(forward).lower(*args).compile(
        compiler_options=fixture.FAST_COMPILE)(*args)
    return init, np.asarray(jlow), np.asarray(jup)


@pytest.mark.parametrize("alternate_corr", [False, True])
def test_raft_small_matches_jax(jax_small_flows, frames, small_model,
                                alternate_corr):
    """The whole test-mode forward against JAX's, through each of the
    port's engines at radius 3."""
    img1, img2 = frames
    init, jlow, jup = jax_small_flows
    with torch.inference_mode():
        low, up = small_model(_t(img1), _t(img2), iters=3,
                              flow_init=_t(init),
                              alternate_corr=alternate_corr)
    assert low.shape == (1, 8, 12, 2) and up.shape == (1, 64, 96, 2)
    _close(low.numpy(), jlow)
    _close(up.numpy(), jup)


def test_golden_small_on_cpu_via_cli(capsys):
    """The port's CLI meets tests/test_golden.py's RAFT-small bars."""
    results = evaluate.main(["--small", "--model", WEIGHTS, "--dataset",
                             "golden_small", "--device", "cpu"])
    assert "Validation Golden[small]: parity EPE" in capsys.readouterr().out
    assert results["golden_small_parity_epe"] < 2e-3, results
    manifest = json.load(open(os.path.join(GOLDEN, "manifest.json")))
    gt = np.mean([p["epe_vs_gt"] for p in manifest["small"]["pairs"]])
    assert abs(results["golden_small_gt_epe"] - gt) < 1e-2, results


def test_golden_variant_and_size_must_agree(small_model):
    """As in JAX: --dataset golden_small needs --small and golden refuses
    it; a small predictor refuses the large goldens."""
    for argv in (["--model", WEIGHTS, "--dataset", "golden_small"],
                 ["--small", "--model", WEIGHTS, "--dataset", "golden"]):
        with pytest.raises(SystemExit):
            evaluate.main(argv + ["--device", "cpu"])
    pred = evaluate.FlowPredictor(small_model, iters=12, device="cpu")
    with pytest.raises(ValueError, match="golden_small"):
        evaluate.validate_golden(pred)


@pytest.mark.parametrize("wrap", ["state_dict", "model_entry"])
def test_pth_checkpoint_loads_to_the_same_flow(tmp_path, frames, wrap):
    """A reference-style .pth written from weights_small.npz, its keys
    under DataParallel's ``module.`` prefix (and wrapped in a ``"model"``
    entry), gives the .npz's flow bit for bit."""
    state = {f"module.{k}": v for k, v in load_npz(WEIGHTS).items()}
    path = str(tmp_path / "raft-small.pth")
    torch.save(state if wrap == "state_dict" else {"model": state}, path)
    img1, img2 = frames
    got = evaluate.load_predictor(path, small=True, iters=2, device="cpu")(
        img1[0], img2[0])
    want = evaluate.load_predictor(WEIGHTS, small=True, iters=2,
                                   device="cpu")(img1[0], img2[0])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_unreadable_checkpoints_are_refused(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        evaluate.load_predictor(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match=".pth"):
        evaluate.load_predictor("weights.msgpack", device="cpu")
    with pytest.raises(ValueError, match="small"):
        evaluate.load_predictor("random", model_family="sparse", small=True,
                                device="cpu")


def test_small_training_and_bf16_are_refused():
    """RAFT-small trains, in float32 and under the bf16 policy (one step
    on an injected batch: finite, not skipped); what stays unported is
    still refused: encoder dropout, checkpoints, validation in the loop.
    The policy builds RAFT-small with float32 parameters and a bfloat16
    compute dtype."""
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.train import train

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (1, 32, 48, 3)).astype(np.float32)
    batch = {"image1": img, "image2": np.roll(img, (1, -2), axis=(1, 2)),
             "flow": np.zeros((1, 32, 48, 2), np.float32),
             "valid": np.ones((1, 32, 48), np.float32)}
    tcfg = TrainConfig(num_steps=1, iters=2, batch_size=1,
                       image_size=(32, 48))
    for mixed in (False, True):
        logged = []

        class Logger:
            def push(self, metrics, lr):
                logged.append(metrics)

        state = train(tcfg, RAFTConfig(small=True, mixed_precision=mixed),
                      dataloader=[batch], restore_ckpt=WEIGHTS,
                      device="cpu", logger=Logger())
        assert state.step == 1 and len(logged) == 1
        assert np.isfinite(logged[0]["loss"])
        assert logged[0]["skipped_steps"] == 0.0
    with pytest.raises(NotImplementedError, match="dropout"):
        train(tcfg, RAFTConfig(small=True, dropout=0.1), dataloader=[batch],
              device="cpu")
    for refused, match in ((dict(ckpt_dir="ckpt"), "checkpointing"),
                           (dict(validation=("chairs",)), "validation")):
        with pytest.raises(NotImplementedError, match=match):
            train(tcfg, RAFTConfig(small=True), dataloader=[batch],
                  device="cpu", **refused)
    model = RAFT(RAFTConfig(small=True, mixed_precision=True))
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
