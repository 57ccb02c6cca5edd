"""RAFT-small under the bf16 mixed-precision policy in the port against the
JAX package on the CPU, and on the card.

Modules at RAFT-small's widths take JAX's variables
(``sparse_fixture.filled_init``: the init's shapes filled from a seed)
through ``state_dict_from_flax``; the whole model takes
``assets/golden/weights_small.npz`` through both packages' loaders. The same
seeded numpy inputs go through both. Bars, with ``EPS`` the bfloat16
epsilon (2^-7): every bfloat16 output and the float32 flows within 8
``EPS`` of max(1, max|JAX|), the JAX package's own bar for its bf16 paths
(``tests/test_step_pallas.py``); the flow update ``delta`` within 8
``EPS`` of its own largest value, with no floor. JAX is compiled to round
at every bfloat16 operation (XLA on the CPU keeps bfloat16 intermediates
in float32 by default), as the policy does on a TPU. The goldens through
the port's CLI: the GT EPE within ``MIXED_BAND`` of the JAX package's own
RAFT-small aggregate under the policy on the CPU
(``scripts/golden_small_mixed_reference.py``), the parity EPE at most its
own plus ``MIXED_BAND``.

The ``cuda`` test runs RAFT-small under the policy on the card through the
bf16 corr form at r=3; it skips here. On the card (which has no JAX):

    python -m pytest --noconftest tests/test_torch_mixed_small.py -m cuda
"""

import os

import numpy as np
import pytest
import torch

from raft_tpu_torch import evaluate
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.extractor import SmallEncoder
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.models.update import SmallUpdateBlock
from raft_tpu_torch.ops import corr_cuda
from raft_tpu_torch.weights import load_npz, state_dict_from_flax

try:
    import jax
    import jax.numpy as jnp

    import sparse_fixture as fixture
    from raft_tpu.config import RAFTConfig as JaxRAFTConfig
    from raft_tpu.models import extractor as jextractor
    from raft_tpu.models import update as jupdate
    from raft_tpu.models.raft import RAFT as JaxRAFT
    from raft_tpu.utils.torch_convert import convert_state_dict
except ModuleNotFoundError:
    # the card's machine has no JAX: only the ``cuda`` test runs there
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "assets", "golden", "weights_small.npz")
EPS = 2.0 ** -7                  # bfloat16 epsilon (jnp.finfo(bfloat16).eps)
BF16 = torch.bfloat16
# JAX_PLATFORMS=cpu python scripts/golden_small_mixed_reference.py
SMALL_MIXED_GT_CPU = 9.206369558970133
SMALL_MIXED_PARITY_CPU = 0.11138821144898732
MIXED_BAND = 0.02                # chip_smoke.py's band for the mixed goldens


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2).to(BF16)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _assert_near(got, want, bar):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    diff = float(np.abs(got - want).max())
    assert diff <= bar, f"max|port - JAX| = {diff:.3e} > {bar:.3e}"


def _bar(want):
    return 8 * EPS * max(1.0, float(np.abs(_np(want)).max()))


def _own_bar(want):
    return 8 * EPS * float(np.abs(_np(want)).max())


def _compiled(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at a low XLA optimisation level,
    rounding at every bfloat16 operation."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        **fixture.FAST_COMPILE, "xla_allow_excess_precision": False})(*args)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads per xdist worker, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


# -- the modules --------------------------------------------------------------

@pytest.mark.parametrize("norm_fn", ["instance", "none"])
def test_bf16_small_encoder_matches_jax(norm_fn):
    """``SmallEncoder`` on a bfloat16 input (bfloat16 convolutions over
    float32 parameters; instance norm's statistics in float32, or no norm,
    cnet's) against flax's at ``dtype=bfloat16``."""
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 48, 3)).astype(
        np.float32)
    variables = fixture.filled_init(jextractor.SmallEncoder(40, norm_fn),
                                    jnp.asarray(x), seed=4)
    want = _compiled(jextractor.SmallEncoder(40, norm_fn,
                                             dtype=jnp.bfloat16).apply,
                     variables, jnp.asarray(x, jnp.bfloat16))
    enc = SmallEncoder(40, norm_fn)
    enc.load_state_dict(state_dict_from_flax(variables))
    with torch.inference_mode():
        got = enc.eval()(_t(x).to(BF16))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in enc.parameters())
    _assert_near(got, want, _bar(want))


@pytest.fixture(scope="module")
def small_block():
    """RAFT-small's update block filled from a seed in both packages, and
    bfloat16 inputs at a 5 x 7 map (hidden 96, context 64, 4 levels of 7 x
    7 windows), as numpy float32 holding bfloat16 values."""
    rng = np.random.default_rng(5)
    shape = (2, 5, 7)
    acts = [np.tanh(rng.standard_normal((*shape, 96))),
            np.maximum(rng.standard_normal((*shape, 64)), 0),
            rng.standard_normal((*shape, 196)),
            rng.uniform(-3, 3, (*shape, 2))]
    acts = [_np(jnp.asarray(a, jnp.bfloat16)) for a in acts]
    variables = fixture.filled_init(jupdate.SmallUpdateBlock(96),
                                    *(jnp.asarray(a) for a in acts), seed=8)
    block = SmallUpdateBlock(96, 64, 196)
    block.load_state_dict(state_dict_from_flax(variables))
    return variables, block.eval(), acts


def test_bf16_small_update_modules_match_jax(small_block):
    """``SmallMotionEncoder``, ``ConvGRU`` (on the encoder's JAX output,
    so that each module sees the same input) and the whole
    ``SmallUpdateBlock`` in bfloat16 against flax's at ``dtype=bfloat16``,
    module by module: every output bfloat16, the motion features' flow
    channels the given flow bit for bit, the block's mask None."""
    variables, block, acts = small_block
    net, inp, cor, flow = (jnp.asarray(a, jnp.bfloat16) for a in acts)
    jblock = jupdate.SmallUpdateBlock(96, jnp.bfloat16)

    def run(v, net, inp, cor, flow):
        motion = jblock.apply(v, flow, cor,
                              method=lambda m, f, c: m.encoder(f, c))
        x = jnp.concatenate([inp, motion], axis=-1)
        gru = jblock.apply(v, net, x, method=lambda m, h, x: m.gru(h, x))
        return motion, gru, jblock.apply(v, net, inp, cor, flow)

    jmotion, jgru, (jnet, jmask, jdelta) = _compiled(run, variables, net,
                                                     inp, cor, flow)
    with torch.inference_mode():
        motion = _nhwc(block.encoder(_nchw(acts[3]), _nchw(acts[2])))
        gru = _nhwc(block.gru(_nchw(acts[0]), torch.cat(
            [_nchw(acts[1]), _nchw(_np(jmotion))], dim=1)))
        got = block(*(_t(a).to(BF16) for a in acts), compute_mask=True)
    assert got[1] is None and jmask is None
    for a, b in ((motion, jmotion), (gru, jgru), (got[0], jnet),
                 (got[2], jdelta)):
        assert a.dtype == BF16 and b.dtype == jnp.bfloat16
    assert torch.equal(motion[..., 80:], _t(acts[3]).to(BF16))
    _assert_near(motion, jmotion, _bar(jmotion))
    _assert_near(gru, jgru, _bar(jgru))
    _assert_near(got[0], jnet, _bar(jnet))
    _assert_near(got[2], jdelta, _own_bar(jdelta))


# -- the whole model ----------------------------------------------------------

@pytest.fixture(scope="module")
def frames():
    """64x96 crops of the first golden pair, float32 in [0, 255]."""
    import json

    from raft_tpu_torch.data import frame_utils

    golden = os.path.join(REPO, "assets", "golden")
    pair = json.load(open(os.path.join(golden, "manifest.json")))["pairs"][0]
    root = os.path.join(REPO, "assets", "demo-frames")
    ims = [np.asarray(frame_utils.read_gen(os.path.join(root, pair[k])),
                      np.float32)[64:128, 80:176]
           for k in ("frame1", "frame2")]
    return ims[0][None], ims[1][None]


@pytest.mark.parametrize("alternate_corr", [False, True],
                         ids=["allpairs", "alternate"])
def test_mixed_raft_small_matches_jax(frames, alternate_corr):
    """RAFT-small with ``mixed_precision=True`` at 64x96, iters=3, against
    JAX's on the same weights, through each engine: the all-pairs pyramid
    stored in bfloat16, or the on-demand lookup (r=3, C=128) on bfloat16
    maps with bfloat16 products; ``upflow8`` on float32 flow, the flows
    float32."""
    img1, img2 = frames
    cfg = dict(small=True, mixed_precision=True, alternate_corr=alternate_corr)
    with np.load(WEIGHTS) as z:
        npz = {k: np.asarray(z[k], np.float32) for k in z.files}
    jmodel = JaxRAFT(JaxRAFTConfig(**cfg))
    jlow, jup = _compiled(
        lambda v, a, b: jmodel.apply(v, a, b, iters=3, test_mode=True),
        convert_state_dict(npz), img1, img2)
    model = RAFT(RAFTConfig(**cfg))
    model.load_state_dict(load_npz(WEIGHTS))
    assert model.config.corr_storage(True) == "bfloat16"
    assert model.config.corr_mxu(True) == "bfloat16"
    with torch.inference_mode():
        low, up = model.eval()(_t(img1), _t(img2), iters=3)
    assert low.dtype == up.dtype == torch.float32
    assert low.shape == (1, 8, 12, 2) and up.shape == (1, 64, 96, 2)
    _assert_near(low, jlow, _bar(jlow))
    _assert_near(up, jup, _bar(jup))


def test_mixed_small_goldens_through_the_cli():
    """``python -m raft_tpu_torch.evaluate --small --mixed_precision``
    (``load_predictor(small=True, mixed_precision=True)``) on the small
    goldens: the GT EPE within ``MIXED_BAND`` of JAX's own aggregate under
    the policy, the parity EPE at most JAX's plus ``MIXED_BAND``."""
    res = evaluate.main(["--small", "--mixed_precision", "--model", WEIGHTS,
                         "--dataset", "golden_small", "--device", "cpu"])
    assert abs(res["golden_small_gt_epe"] - SMALL_MIXED_GT_CPU) < MIXED_BAND
    assert res["golden_small_parity_epe"] <= (SMALL_MIXED_PARITY_CPU
                                              + MIXED_BAND)
    pred = evaluate.load_predictor(WEIGHTS, small=True, mixed_precision=True,
                                   device="cpu")
    assert pred.model.config.small and pred.model.config.mixed_precision
    assert pred.model.compute_dtype == BF16


# -- the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_mixed_raft_small_runs_the_bf16_lookup_on_card(cuda):
    """RAFT-small under the policy on the card (the on-demand engine,
    ``corr_impl`` auto): the bf16 corr form at r=3, C=128 once an
    iteration and no float32 lookup; float32 flows within 8 ``EPS`` of
    max(1, max|flow|) of the same model's plain route on the CPU."""
    rng = np.random.default_rng(9)
    img1 = rng.uniform(0, 255, (64, 96, 3)).astype(np.float32)
    img2 = np.roll(img1, (2, -3), axis=(0, 1))
    pred = evaluate.load_predictor(WEIGHTS, small=True, mixed_precision=True,
                                   iters=4)
    assert pred.alternate_corr
    before = corr_cuda.bf16_launches, corr_cuda.launches
    low, up = pred(img1, img2)
    torch.cuda.synchronize()
    assert (corr_cuda.bf16_launches - before[0],
            corr_cuda.launches - before[1]) == (4, 0)
    cpu = evaluate.load_predictor(WEIGHTS, small=True, mixed_precision=True,
                                  iters=4, device="cpu", alternate_corr=True)
    want = cpu(img1, img2)
    for a, b in zip((low, up), want):
        assert a.dtype == np.float32 and np.isfinite(a).all()
        assert float(np.abs(a - b).max()) <= 8 * EPS * max(
            1.0, float(np.abs(b).max()))
