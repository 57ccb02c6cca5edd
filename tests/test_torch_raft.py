"""RAFT-large in the port against the JAX package, end to end on the CPU.

Weights reach both packages from one source: the golden fixture archive
(torch names, loaded by the port as is and by JAX through
``convert_state_dict``), or flax initialisation carried into the port by
``state_dict_from_flax``. Inputs are seeded numpy arrays or crops of the
committed demo frames. Bars: module outputs agree to 1e-4 (float32
convolutions summed in another order, through up to 20 layers); whole-model
flows to 1e-4 px, the ROADMAP bar; the goldens to the bars of
``tests/test_golden.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparse_fixture as fixture

from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.models import extractor as jextractor
from raft_tpu.models import update as jupdate
from raft_tpu.models.normalize import normalize_image as jnormalize
from raft_tpu.models.raft import RAFT as JaxRAFT
from raft_tpu.utils.padder import InputPadder as JaxInputPadder
from raft_tpu.utils.torch_convert import convert_state_dict
from raft_tpu.data import frame_utils as jframe_utils
from raft_tpu_torch import evaluate
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.data import frame_utils
from raft_tpu_torch.models.extractor import BasicEncoder
from raft_tpu_torch.models.normalize import normalize_image
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.models.update import BasicUpdateBlock
from raft_tpu_torch.utils.padder import InputPadder
from raft_tpu_torch.weights import load_npz, state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "assets", "golden")
WEIGHTS = os.path.join(GOLDEN, "weights.npz")
TOL = 1e-4


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


@pytest.fixture(scope="module")
def npz_state():
    with np.load(WEIGHTS) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}


@pytest.fixture(scope="module")
def port_model():
    model = RAFT()
    model.load_state_dict(load_npz(WEIGHTS))
    return model.eval()


@pytest.fixture(scope="module")
def frames():
    """64x96 crops of the first golden pair, float32 in [0, 255]."""
    pair = json.load(open(os.path.join(GOLDEN, "manifest.json")))["pairs"][0]
    root = os.path.join(REPO, "assets", "demo-frames")
    ims = [np.asarray(frame_utils.read_gen(os.path.join(root, pair[k])),
                      np.float32)[64:128, 80:176]
           for k in ("frame1", "frame2")]
    return ims[0][None], ims[1][None]


def test_state_dict_round_trip(npz_state):
    """weights.npz -> JAX variables -> port state dict gives back every
    key and value (num_batches_tracked is 0 in the archive)."""
    back = state_dict_from_flax(convert_state_dict(npz_state))
    assert set(back) == set(npz_state)
    for k, v in npz_state.items():
        np.testing.assert_array_equal(back[k].numpy().astype(np.float32), v,
                                      err_msg=k)


def test_port_state_dict_is_the_reference_layout(npz_state, port_model):
    """Module attribute names follow the torch keys: the archive loads with
    no renaming, and the parameter count is RAFT-large's 5,257,536."""
    sd = port_model.state_dict()
    assert set(sd) == set(npz_state)
    for k, v in sd.items():
        assert tuple(v.shape) == npz_state[k].shape, k
    assert sum(p.numel() for p in port_model.parameters()) == 5_257_536


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_basic_encoder_matches_jax(norm_fn):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    jenc = jextractor.BasicEncoder(64, norm_fn)
    # weights and non-trivial running statistics from a seed
    variables = fixture.filled_init(jenc, jnp.asarray(x), seed=1)
    want = jax.jit(jenc.apply)(variables, x)
    enc = BasicEncoder(64, norm_fn)
    enc.load_state_dict(state_dict_from_flax(variables))
    with torch.inference_mode():
        got = enc.eval()(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.fixture(scope="module")
def update_setup():
    rng = np.random.default_rng(1)
    shape = (1, 4, 6)
    net = np.tanh(rng.standard_normal((*shape, 128))).astype(np.float32)
    inp = np.maximum(rng.standard_normal((*shape, 128)), 0).astype(np.float32)
    corr = rng.standard_normal((*shape, 324)).astype(np.float32)
    flow = rng.uniform(-3, 3, (*shape, 2)).astype(np.float32)
    args = tuple(jnp.asarray(a) for a in (net, inp, corr, flow))
    jblock = jupdate.BasicUpdateBlock(128)
    variables = fixture.filled_init(jblock, *args, seed=2)
    block = BasicUpdateBlock(128, 128, 324)
    block.load_state_dict(state_dict_from_flax(variables))
    return jblock, variables, block, args, (net, inp, corr, flow)


@pytest.mark.parametrize("compute_mask", [True, None])
def test_update_block_matches_jax(update_setup, compute_mask):
    jblock, variables, block, args, arrays = update_setup
    jnet, jmask, jdelta = jax.jit(lambda v, *a: jblock.apply(
        v, *a, compute_mask=compute_mask))(variables, *args)
    with torch.inference_mode():
        net, mask, delta = block(*(_t(a) for a in arrays),
                                 compute_mask=compute_mask)
    np.testing.assert_allclose(net.numpy(), np.asarray(jnet), atol=TOL, rtol=0)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), atol=TOL,
                               rtol=0)
    if compute_mask is None:
        assert mask is None and jmask is None
    else:
        np.testing.assert_allclose(mask.numpy(), np.asarray(jmask), atol=TOL,
                                   rtol=0)


@pytest.fixture(scope="module")
def jax_flows(npz_state, frames):
    """The JAX RAFT's test-mode flows at 64x96, iters=3, for one engine
    (the on-demand one from a non-zero flow_init): ``(init, low, up)``,
    computed once per engine for this file."""
    cache = {}

    def run(alternate_corr):
        if alternate_corr not in cache:
            img1, img2 = frames
            init = (np.random.default_rng(4).uniform(-2, 2, (1, 8, 12, 2))
                    .astype(np.float32) if alternate_corr else None)
            jmodel = JaxRAFT(JaxRAFTConfig(alternate_corr=alternate_corr))

            def forward(v, a, b, flow_init):
                return jmodel.apply(v, a, b, iters=3, test_mode=True,
                                    flow_init=flow_init)

            # compiled at a low XLA optimisation level: a quarter of the
            # time of running the model op by op, the same arithmetic up to
            # float rounding
            args = (convert_state_dict(npz_state), img1, img2, init)
            jlow, jup = jax.jit(forward).lower(*args).compile(
                compiler_options=fixture.FAST_COMPILE)(*args)
            cache[alternate_corr] = (init, np.asarray(jlow), np.asarray(jup))
        return cache[alternate_corr]
    return run


def _check_raft(port_model, frames, jax_flows, alternate_corr, update_impl):
    img1, img2 = frames
    init, jlow, jup = jax_flows(alternate_corr)
    with torch.inference_mode():
        low, up = port_model(_t(img1), _t(img2), iters=3,
                             flow_init=None if init is None else _t(init),
                             alternate_corr=alternate_corr,
                             update_impl=update_impl)
    assert low.shape == (1, 8, 12, 2) and up.shape == (1, 64, 96, 2)
    np.testing.assert_allclose(low.numpy(), jlow, atol=TOL, rtol=0)
    np.testing.assert_allclose(up.numpy(), jup, atol=TOL, rtol=0)


@pytest.mark.parametrize("alternate_corr", [False, True])
def test_raft_matches_jax(port_model, frames, jax_flows, alternate_corr):
    """The whole test-mode forward at 64x96, iters=3, through each engine
    and the default update path (one step-kernel call per iteration); the
    on-demand engine also starts from a non-zero flow_init."""
    _check_raft(port_model, frames, jax_flows, alternate_corr, "step")


@pytest.mark.parametrize("alternate_corr", [False, True])
def test_raft_chain_matches_jax(port_model, frames, jax_flows,
                                alternate_corr):
    """The same through the other update path: the motion encoder, then
    the GRU with x as parts, then the heads."""
    _check_raft(port_model, frames, jax_flows, alternate_corr, "chain")


def test_unknown_update_impl_is_refused(port_model, update_setup):
    with pytest.raises(ValueError, match="update_impl"):
        evaluate.FlowPredictor(port_model, device="cpu", update_impl="fused")
    _, _, block, _, arrays = update_setup
    with pytest.raises(ValueError, match="update_impl"):
        block(*(_t(a) for a in arrays), update_impl="conv")
    with pytest.raises(SystemExit):
        evaluate.main(["--model", WEIGHTS, "--dataset", "golden",
                       "--device", "cpu", "--update_impl", "fused"])


def test_golden_on_cpu_via_cli(capsys):
    """The port's CLI and FlowPredictor(device='cpu') meet the golden bars
    of tests/test_golden.py (all-pairs engine, the CPU's 'auto' choice)."""
    results = evaluate.main(["--model", WEIGHTS, "--dataset", "golden",
                             "--device", "cpu"])
    assert "Validation Golden[large]: parity EPE" in capsys.readouterr().out
    assert results["golden_parity_epe"] < 2e-3, results
    manifest = json.load(open(os.path.join(GOLDEN, "manifest.json")))
    gt = np.mean([p["epe_vs_gt"] for p in manifest["pairs"]])
    assert abs(results["golden_gt_epe"] - gt) < 1e-2, results


def test_predictor_pair_call_matches_batch(port_model, frames):
    pred = evaluate.FlowPredictor(port_model, iters=2, device="cpu")
    assert not pred.alternate_corr          # auto: all-pairs on the CPU
    low, up = pred(frames[0][0], frames[1][0].astype(np.uint8))
    blow, bup = pred.predict_batch(np.concatenate([frames[0]] * 2),
                                   np.concatenate([frames[1]] * 2)
                                   .astype(np.uint8))
    assert low.shape == (8, 12, 2) and up.shape == (64, 96, 2)
    np.testing.assert_allclose(bup[1], up, atol=TOL, rtol=0)
    np.testing.assert_allclose(blow[0], low, atol=TOL, rtol=0)


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch, port_model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.FlowPredictor(port_model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.main(["--model", WEIGHTS, "--dataset", "golden"])


TRAINING_MODULES = ("raft_tpu_torch.train", "raft_tpu_torch.losses",
                    "raft_tpu_torch.optim", "raft_tpu_torch.ops.recompute",
                    "raft_tpu_torch.parallel.train_step",
                    # the sparse family's
                    "raft_tpu_torch.models.ours",
                    "raft_tpu_torch.models.sparse_extractor",
                    "raft_tpu_torch.models.deformable",
                    "raft_tpu_torch.ops.msda", "raft_tpu_torch.ops.msda_cuda",
                    # the serving surface's
                    "raft_tpu_torch.utils.warm_start",
                    "raft_tpu_torch.entry")


def test_import_pulls_in_no_jax():
    """Every module of the port, the training slice's, the sparse
    family's and the serving surface's included, imports without JAX,
    flax, optax or raft_tpu."""
    code = (
        "import importlib, pkgutil, sys, raft_tpu_torch\n"
        "for m in pkgutil.walk_packages(raft_tpu_torch.__path__, "
        "'raft_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'raft_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('raft_tpu_torch')]"
        f"), all(m in sys.modules for m in {TRAINING_MODULES!r}), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout.split(" ", 2)
    assert int(out[0]) > 15 and out[1] == "True" and out[2].strip() == "[]", \
        out


def test_iters_and_unported_configs_raise(port_model, frames):
    with pytest.raises(ValueError, match="iters"):
        port_model(_t(frames[0]), _t(frames[1]), iters=0)
    with pytest.raises(ValueError, match="iters"):
        evaluate.FlowPredictor(port_model, iters=0, device="cpu")
    small = RAFT(RAFTConfig(small=True))
    assert small.update_block.encoder.convc1.in_channels == 4 * 7 * 7
    # the bf16 policy builds and returns float32 flows on both update_impls
    # (on the CPU both are the same plain versions), RAFT-small under it
    # too; training RAFT-small under it refuses
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.train import train

    mixed = RAFT(RAFTConfig(mixed_precision=True))
    mixed.load_state_dict(port_model.state_dict())
    small_mixed = RAFT(RAFTConfig(small=True, mixed_precision=True))
    with torch.inference_mode():
        low, up = mixed.eval()(_t(frames[0]), _t(frames[1]), iters=1)
        assert low.dtype == up.dtype == torch.float32
        assert bool(torch.isfinite(up).all())
        chain = mixed(_t(frames[0]), _t(frames[1]), iters=1,
                      update_impl="chain")
        assert all(torch.equal(a, b) for a, b in zip(chain, (low, up)))
        assert small_mixed.compute_dtype == torch.bfloat16
        flows = small_mixed.eval()(_t(frames[0]), _t(frames[1]), iters=1)
        assert all(f.dtype == torch.float32 and bool(torch.isfinite(f).all())
                   for f in flows)
    with pytest.raises(NotImplementedError, match="RAFT-small"):
        train(TrainConfig(num_steps=1),
              RAFTConfig(small=True, mixed_precision=True), dataloader=[],
              device="cpu", update_impl="chain")
    with pytest.raises(ValueError):
        RAFT(RAFTConfig(normalized_coords=True))


@pytest.mark.parametrize("kwargs", [
    {"corr_dtype": "half"}, {"corr_mxu_dtype": "fp8"},
    {"alternate_corr": True, "corr_dtype": "bfloat16"},
    {"corr_mxu_dtype": "bfloat16"}])
def test_config_validation_matches_jax(kwargs):
    with pytest.raises(ValueError):
        JaxRAFTConfig(**kwargs)
    with pytest.raises(ValueError):
        RAFTConfig(**kwargs)


def test_config_matches_jax():
    for kw in ({}, {"small": True}, {"corr_radius": 3, "feature_dim": 128}):
        a, b = RAFTConfig(**kw), JaxRAFTConfig(**kw)
        assert (a.fnet_dim, a.hdim, a.cdim, a.radius) == (
            b.fnet_dim, b.hdim, b.cdim, b.radius)
    ours = {f.name: f.default for f in RAFTConfig.__dataclass_fields__
            .values()}
    theirs = {f.name: f.default for f in JaxRAFTConfig.__dataclass_fields__
              .values()}
    assert ours == theirs


def test_normalize_matches_jax_exactly():
    img = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1)
    want = np.asarray(jnormalize(jnp.asarray(img), jnp.float32))
    np.testing.assert_array_equal(normalize_image(torch.from_numpy(img))
                                  .numpy(), want)
    np.testing.assert_array_equal(
        normalize_image(torch.from_numpy(img.astype(np.float32))).numpy(),
        want)


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
def test_padder_matches_jax(mode):
    x = np.random.default_rng(5).uniform(0, 255, (1, 436, 1021, 3))
    ours, theirs = InputPadder(x.shape, mode), JaxInputPadder(x.shape, mode)
    assert ours.padded_shape == theirs.padded_shape == (440, 1024)
    np.testing.assert_array_equal(ours.pad(x), theirs.pad(x))
    np.testing.assert_array_equal(ours.unpad(ours.pad(x)), x)


def test_read_flo_matches_jax():
    path = os.path.join(GOLDEN, "flow_gt_00.flo")
    np.testing.assert_array_equal(frame_utils.read_flo(path),
                                  jframe_utils.read_flo(path))
