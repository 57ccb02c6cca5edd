"""The bf16 forms of the chain kernels (``motion_fwd`` and ``sepconv_gru``
in bfloat16) and RAFT-large on ``update_impl="chain"`` under the bf16
mixed-precision policy, in the port against the JAX package on the CPU,
and the two bf16 forms against their plain versions on the card.

The same seeded numpy inputs, and flax variables filled from a seed
(``sparse_fixture.filled_init``) or the golden fixture's weights (torch
names, ``convert_state_dict`` for JAX) carried into the port, go through
both packages. JAX runs its chain (``RAFT_STEP_PALLAS=0``, set by
monkeypatch): for the kernels and the update block with
``RAFT_MOTION_PALLAS=1`` and ``RAFT_GRU_PALLAS=1`` (the two TPU kernels in
the Pallas interpreter); for the whole model and the train step with both
at ``auto``, the chain as JAX runs it off a TPU (the flax convolutions,
whose rounding points the kernels share), which compiles in a few seconds
where the interpreted kernels take half a minute in a train step.
Tolerances, with ``EPS`` the bfloat16 epsilon (2^-7):

* every bfloat16 output within 8 ``EPS`` of max(1, max|JAX|), the JAX
  package's own bar for its bf16 paths (``tests/test_step_pallas.py``);
  the flow update ``delta`` within 8 ``EPS`` of its own largest value,
  with no floor. The motion encoder's flow channels are the given
  bfloat16 flow, bit for bit.
* The two kernels' plain versions against the TPU kernels also within
  ``NORM_REL`` on the 2-norm, ||port - JAX|| / ||JAX||: the plain version
  at float32 on the same values (the control) must lie above it. The
  largest difference cannot tell the two apart (a float32 encoder reads
  about one ``EPS`` of max(1, max|JAX|) from a bfloat16 one: a flipped
  rounding is as large), the 2-norm can: bfloat16 and float32 differ at
  every output, two summation orders at a few. JAX is compiled to round
  at every bfloat16 operation, as the policy does on a TPU (XLA on the
  CPU keeps bfloat16 intermediates in float32 by default). XLA's CPU
  sigmoid of a bfloat16 value rounds at each of its operations, 1 / (1 +
  exp(-x)), where the port's plain version and the CUDA kernel (and
  ``torch.sigmoid`` on either device) compute it in float32 and round
  once: that alone moves the GRU's 2-norm as far as the control. The GRU
  is held to the 2-norm bar with XLA's sigmoid put in the plain version's
  place (``_xla_sigmoid``), where it reproduces the Pallas kernel bit for
  bit, and to the largest-difference bar as it is.
* The mixed chain train step: its loss, EPE, gradient norm and every
  parameter's gradient within twice the distance between JAX's mixed
  chain step and the float32 step, the scalars' distance the larger of
  JAX's two compiles' (with and without XLA's excess precision), as
  ``tests/test_torch_mixed_train.py`` holds the step route's. The port's
  chain runs through the kernels' autograd Functions (the recompute
  backward the card runs) with the plain versions in the kernels' place.

The ``cuda`` tests hold the two bf16 forms against their plain versions on
the card (the same bars, the control the float32 kernel), and the mixed
chain block's launches; they skip here. On the card (which has no JAX):

    python -m pytest --noconftest tests/test_torch_mixed_chain.py -m cuda
"""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.models.update import BasicUpdateBlock
from raft_tpu_torch.ops import gru_cuda, motion_cuda
from raft_tpu_torch.parallel.train_step import (create_train_state,
                                                make_train_step)
from raft_tpu_torch.weights import load_npz, state_dict_from_flax

try:
    import jax
    import jax.numpy as jnp

    import sparse_fixture as fixture
    from raft_tpu.config import RAFTConfig as JaxRAFTConfig
    from raft_tpu.config import TrainConfig as JaxTrainConfig
    from raft_tpu.models.raft import RAFT as JaxRAFT
    from raft_tpu.models.update import BasicUpdateBlock as JaxUpdateBlock
    from raft_tpu.ops import gru_pallas, motion_pallas
    from raft_tpu.optim import fetch_optimizer as jax_fetch_optimizer
    from raft_tpu.parallel.train_step import make_train_step as jax_train_step
    from raft_tpu.utils.torch_convert import convert_state_dict
except ModuleNotFoundError:
    # the card's machine has no JAX: only the ``cuda`` tests run there
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "assets", "golden", "weights.npz")
EPS = 2.0 ** -7                  # bfloat16 epsilon (jnp.finfo(bfloat16).eps)
BF16 = torch.bfloat16
# 2-norm bar of the kernels against their references; read on the CPU at
# the Sintel shape (golden weights): another summation order (float64
# sums, the same rounding points) 1.8e-4 (motion) and 5.8e-5 (GRU), the
# float32 control 4.8e-3 and 4.7e-3
NORM_REL = 1e-3
CHAIN_FLAGS = {"RAFT_STEP_PALLAS": "0", "RAFT_MOTION_PALLAS": "1",
               "RAFT_GRU_PALLAS": "1"}
CHAIN_CONV_FLAGS = dict(CHAIN_FLAGS, RAFT_MOTION_PALLAS="auto",
                        RAFT_GRU_PALLAS="auto")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _dist(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _rel2(a, b) -> float:
    return float(np.linalg.norm(_np(a) - _np(b)) / np.linalg.norm(_np(b)))


def _bar(want, rel):
    return rel * max(1.0, float(np.abs(_np(want)).max()))


def _own_bar(want, rel):
    """``rel`` of max|want|, for the flow update ``delta``."""
    return rel * float(np.abs(_np(want)).max())


def _compiled(fn, *args, excess=False):
    """``jax.jit(fn)(*args)`` compiled at a low XLA optimisation level,
    rounding at every bfloat16 operation unless ``excess``."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        **fixture.FAST_COMPILE, "xla_allow_excess_precision": excess})(*args)


def _xla_sigmoid(x):
    """XLA's CPU sigmoid of a bfloat16 tensor: each operation rounded."""
    return 1 / (1 + torch.exp(-x))


@pytest.fixture
def chain_flags(monkeypatch):
    """JAX's refine iteration as the chain of the two Pallas kernels."""
    for k, v in CHAIN_FLAGS.items():
        monkeypatch.setenv(k, v)


@pytest.fixture
def chain_conv_flags(monkeypatch):
    """JAX's refine iteration as its chain off a TPU (flax convolutions)."""
    for k, v in CHAIN_CONV_FLAGS.items():
        monkeypatch.setenv(k, v)


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


# -- the two kernels' plain versions against the TPU kernels ------------------

SB, SH, SW, CC = 2, 9, 7, 12


@pytest.fixture(scope="module")
def chain_setup():
    """A flax ``BasicUpdateBlock`` filled from a seed, its JAX packings,
    the port's block with the same weights, and bfloat16 inputs (as numpy
    float32 holding bfloat16 values)."""
    rng = np.random.default_rng(7)
    acts = [np.tanh(rng.standard_normal((SB, SH, SW, 128))),
            np.maximum(rng.standard_normal((SB, SH, SW, 128)), 0),
            rng.standard_normal((SB, SH, SW, CC)),
            3.0 * rng.standard_normal((SB, SH, SW, 2))]
    acts = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            for a in acts]
    variables = fixture.filled_init(
        JaxUpdateBlock(), *(jnp.asarray(a) for a in acts), seed=5)
    p = variables["params"]

    def pairs(mod, *names):
        return tuple((p[mod][n]["kernel"], p[mod][n]["bias"]) for n in names)

    mats = (motion_pallas.pack_weights(*pairs(
                "encoder", "convc1", "convc2", "convf1", "convf2", "conv")),
            gru_pallas.pack_weights(
                pairs("gru", "convz1", "convr1", "convq1"),
                pairs("gru", "convz2", "convr2", "convq2"), 128))
    block = BasicUpdateBlock(128, 128, CC)
    block.load_state_dict(state_dict_from_flax(variables))
    return variables, mats, block.eval(), acts


def _held(got, want, control, what):
    """``got`` (bfloat16) within 8 EPS of max(1, max|want|) and NORM_REL
    on the 2-norm, the float32 ``control`` above NORM_REL."""
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16, what
    assert _dist(got, want) <= _bar(want, 8 * EPS), (what, _dist(got, want))
    assert _rel2(got, want) <= NORM_REL, (what, _rel2(got, want))
    assert _rel2(control, want) > NORM_REL, (what, _rel2(control, want))


def test_bf16_motion_plain_matches_pallas_interpret(chain_setup):
    """``motion_encoder_plain`` on bfloat16 flow and corr against the TPU
    motion kernel at ``dtype=bfloat16`` in the interpreter: bfloat16 out
    (JAX's ``promote(compute dtype, flow.dtype)``), the flow channels the
    given flow bit for bit."""
    _, (mmats, _), block, acts = chain_setup
    flow, cor = acts[3], acts[2]
    want = _compiled(lambda f, c: motion_pallas.motion_encoder(
        f, c, mmats, dtype=jnp.bfloat16, interpret=True),
        jnp.asarray(flow, jnp.bfloat16), jnp.asarray(cor, jnp.bfloat16))
    convs = block.encoder.convs()
    with torch.inference_mode():
        got = motion_cuda.motion_encoder_plain(_t(flow).to(BF16),
                                               _t(cor).to(BF16), convs)
        control = motion_cuda.motion_encoder_plain(_t(flow), _t(cor), convs)
    assert got.shape == (SB, SH, SW, motion_cuda.OUT_CHANNELS)
    _held(got[..., :126], want[..., :126], control[..., :126], "motion")
    assert torch.equal(got[..., 126:], _t(flow).to(BF16))
    np.testing.assert_array_equal(_np(want[..., 126:]), flow)


@pytest.mark.parametrize("parts", [1, 2], ids=["x-whole", "x-parts"])
def test_bf16_gru_plain_matches_pallas_interpret(chain_setup, parts,
                                                 monkeypatch):
    """``sepconv_gru_plain`` on a bfloat16 h and x (whole, or the parts
    (inp, [motion | flow]) the chain hands it) against the TPU GRU kernel
    at ``dtype=bfloat16`` in the interpreter: h' in h's dtype, within 8
    ``EPS``; with XLA's CPU sigmoid in the plain version, within
    ``NORM_REL`` on the 2-norm too, the float32 control above it."""
    _, (_, gmats), block, acts = chain_setup
    net, inp = acts[0], acts[1]
    with torch.inference_mode():
        mot = motion_cuda.motion_encoder_plain(
            _t(acts[3]).to(BF16), _t(acts[2]).to(BF16), block.encoder.convs())
    xs = (inp, _np(mot))
    jx = tuple(jnp.asarray(x, jnp.bfloat16) for x in xs)
    if parts == 1:
        jx = jnp.concatenate(jx, axis=-1)
    want = _compiled(lambda h, x: gru_pallas.sepconv_gru(
        h, x, gmats, dtype=jnp.bfloat16, interpret=True),
        jnp.asarray(net, jnp.bfloat16), jx)
    tx = tuple(_t(x).to(BF16) for x in xs)
    if parts == 1:
        tx = torch.cat(tx, dim=-1)
    convs = block.gru.convs()
    with torch.inference_mode():
        got = gru_cuda.sepconv_gru_plain(_t(net).to(BF16), tx, convs)
        control = gru_cuda.sepconv_gru_plain(
            _t(net), tuple(_t(x) for x in xs), convs)
        monkeypatch.setattr(torch, "sigmoid", _xla_sigmoid)
        as_xla = gru_cuda.sepconv_gru_plain(_t(net).to(BF16), tx, convs)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert _dist(got, want) <= _bar(want, 8 * EPS), _dist(got, want)
    _held(as_xla, want, control, "gru, XLA's sigmoid")


def test_bf16_chain_block_matches_jax(chain_setup, chain_flags):
    """``BasicUpdateBlock(update_impl="chain")`` in bfloat16 against the
    flax block at ``dtype=bfloat16`` on its chain (the two Pallas kernels
    in the interpreter, then the bfloat16 heads), with the mask head and
    without it (the non-final iterations)."""
    variables, _, block, acts = chain_setup
    arrays = [jnp.asarray(a, jnp.bfloat16) for a in acts]
    jblock = JaxUpdateBlock(dtype=jnp.bfloat16)
    want = _compiled(lambda v, *a: (
        jblock.apply(v, *a, compute_mask=True),
        jblock.apply(v, *a, compute_mask=None)), variables, *arrays)
    ports = [_t(a).to(BF16) for a in acts]
    with torch.inference_mode():
        got = (block(*ports, compute_mask=True, update_impl="chain"),
               block(*ports, compute_mask=None, update_impl="chain"))
    assert got[1][1] is None and want[1][1] is None
    for outs, wants in zip(got, want):
        for a, b, bar in zip(outs, wants, (_bar, _bar, _own_bar)):
            if b is None:
                continue
            assert a.dtype == BF16 and b.dtype == jnp.bfloat16
            assert _dist(a, b) <= bar(b, 8 * EPS), _dist(a, b)


def test_bf16_chain_wrappers_refuse_mixed_dtypes():
    """The bf16 forms take every operand in bfloat16 and the float32 forms
    every operand in float32: a mix (a float32 flow beside bfloat16 corr,
    JAX's promoted case; a float32 x part beside a bfloat16 h) is refused
    before the wrapper looks at the device."""
    flow, corr = torch.zeros(1, 2, 2, 2), torch.zeros(1, 2, 2, 324, dtype=BF16)
    with pytest.raises(ValueError, match="one dtype"):
        motion_cuda.motion_encoder_cuda(flow, corr, ())
    h = torch.zeros(1, 2, 2, 128, dtype=BF16)
    with pytest.raises(ValueError, match="one dtype"):
        gru_cuda.sepconv_gru_cuda(h, (h, torch.zeros(1, 2, 2, 128)), ())


# -- whole RAFT-large on the chain under the policy ---------------------------

@pytest.fixture(scope="module")
def npz_state():
    with np.load(WEIGHTS) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}


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
def test_mixed_chain_raft_matches_jax(npz_state, frames, chain_conv_flags,
                                      alternate_corr):
    """RAFT-large with ``mixed_precision=True`` on ``update_impl="chain"``
    at 64x96, iters=3, against JAX's mixed model on its chain, through
    each engine; the flows come back float32."""
    img1, img2 = frames
    jmodel = JaxRAFT(JaxRAFTConfig(alternate_corr=alternate_corr,
                                   mixed_precision=True))
    jlow, jup = _compiled(
        lambda v, a, b: jmodel.apply(v, a, b, iters=3, test_mode=True),
        convert_state_dict(npz_state), img1, img2)
    model = RAFT(RAFTConfig(mixed_precision=True,
                            alternate_corr=alternate_corr))
    model.load_state_dict(load_npz(WEIGHTS))
    with torch.inference_mode():
        low, up = model.eval()(_t(img1), _t(img2), iters=3,
                               update_impl="chain")
    assert low.dtype == up.dtype == torch.float32
    assert _dist(low, jlow) <= _bar(jlow, 8 * EPS), _dist(low, jlow)
    assert _dist(up, jup) <= _bar(jup, 8 * EPS), _dist(up, jup)


# -- one mixed chain train step -----------------------------------------------

KW = dict(batch_size=1, image_size=(64, 64), num_steps=100, iters=2)


def _batch():
    rng = np.random.default_rng(11)
    img1 = rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    return {"image1": img1,
            "image2": np.roll(img1, (1, -2), axis=(1, 2)),
            "flow": (2.0 * rng.standard_normal((1, 64, 64, 2))).astype(
                np.float32),
            "valid": (rng.uniform(size=(1, 64, 64)) > 0.2).astype(
                np.float32)}


def _through_autograd(monkeypatch, record=None):
    """Route the motion and GRU modules' CUDA dispatch through the kernels'
    autograd Functions with the plain versions in the kernels' place (what
    the card runs, with its forward computed by the plain version), on any
    device. ``record``: a dict of lists, which receives the packed weights
    each call is handed, after checking them against a fresh pack of the
    parameters as they are at that call."""
    def stand_in(name, plain, pack, autograd):
        def dispatch(a, b, convs, packed):
            if record is not None:
                fresh = pack(convs)
                assert all(torch.equal(x, y) for x, y in zip(packed, fresh))
                record[name].append(packed)
            return autograd(a, b, convs, lambda a, b: plain(a, b, convs))
        return dispatch

    monkeypatch.setattr(motion_cuda, "motion_encoder", stand_in(
        "motion", motion_cuda.motion_encoder_plain,
        motion_cuda.pack_weights_bf16, motion_cuda.motion_encoder_autograd))
    monkeypatch.setattr(gru_cuda, "sepconv_gru", stand_in(
        "gru", gru_cuda.sepconv_gru_plain, gru_cuda.pack_weights_bf16,
        gru_cuda.sepconv_gru_autograd))


@pytest.fixture(scope="module")
def chain_steps(npz_state):
    """JAX's mixed train step on its chain, compiled rounding at every
    bfloat16 operation and as XLA compiles it by default, and the port's
    mixed and float32 steps on ``update_impl="chain"`` through the
    kernels' autograd Functions, from the fixture weights on one batch:
    ((JAX's metrics, clipped gradients), the default compile's metrics),
    (the port's mixed metrics and state), (the float32 metrics and
    gradients). AdamW's first moment after one step is (1 - b1) times the
    clipped gradient."""
    batch = _batch()
    mp = pytest.MonkeyPatch()
    for k, v in CHAIN_CONV_FLAGS.items():
        mp.setenv(k, v)
    _through_autograd(mp)
    try:
        jax_runs = []
        for excess in (False, True):
            state, unflatten = fixture.flat_train_state(
                JaxRAFT(JaxRAFTConfig(iters=KW["iters"],
                                      mixed_precision=True)),
                convert_state_dict(npz_state),
                jax_fetch_optimizer(JaxTrainConfig(**KW)))
            jax_runs.append(_compiled(
                jax_train_step(JaxTrainConfig(**KW), donate=False), state,
                {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.PRNGKey(0), excess=excess))
        runs = []
        for policy in (True, False):
            model = RAFT(RAFTConfig(mixed_precision=policy))
            model.load_state_dict(load_npz(WEIGHTS))
            tcfg = TrainConfig(**KW)
            st = create_train_state(model, tcfg)
            metrics = make_train_step(tcfg, update_impl="chain")(
                st, {k: torch.from_numpy(v) for k, v in batch.items()})
            runs.append((metrics, st))
    finally:
        mp.undo()
    (state, jm), (_, jd) = jax_runs
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu"))
    jgrads = state_dict_from_flax(unflatten(SimpleNamespace(
        params={"flat": adam.mu["flat"] / 0.1},
        batch_stats=state.batch_stats)))
    (metrics, st), (fm, fst) = runs
    fgrads = {n: p.grad for n, p in fst.model.named_parameters()}
    return (({k: float(v) for k, v in jm.items()}, jgrads),
            {k: float(v) for k, v in jd.items()}), (metrics, st), (fm, fgrads)


def test_mixed_chain_train_step_matches_jax(chain_steps):
    """The port's mixed chain step against JAX's: loss, EPE and pre-clip
    gradient norm within twice the larger distance of JAX's two compiles
    from the float32 step, and every parameter's clipped gradient within
    twice the distance between JAX's mixed chain step and the float32 step
    (the conv biases in front of the encoders' norms, whose gradient is
    rounding noise on both sides, within twice the larger of their two
    gradients); neither step skipped, the clip active."""
    ((jm, jgrads), jd), (metrics, st), (fm, fgrads) = chain_steps
    assert st.step == 1 and metrics["skipped_steps"] == 0.0
    assert jm["skipped_steps"] == 0.0 and metrics["grad_norm"] > 1.0
    for k in ("loss", "epe", "grad_norm"):
        bar = 2 * max(abs(jm[k] - fm[k]), abs(jd[k] - fm[k]))
        assert 0 < bar and abs(metrics[k] - jm[k]) <= bar, (k, metrics[k],
                                                            jm[k], bar)
    for name, prm in st.model.named_parameters():
        got, want, f32 = prm.grad, jgrads[name], fgrads[name]
        if re.fullmatch(r"[fc]net\.(conv1|layer\d\.\d\.(conv\d|downsample"
                        r"\.0))\.bias", name):
            bar = 2 * max(float(np.abs(_np(want)).max()),
                          float(np.abs(_np(f32)).max()))
        else:
            bar = 2 * _dist(want, f32)
        assert _dist(got, want) <= bar, (name, _dist(got, want), bar)


def test_chain_train_steps_launch_with_fresh_bf16_packs(monkeypatch):
    """Two mixed chain train steps of two iterations each, with a stand-in
    for the motion and GRU kernels (``_through_autograd``) that records
    the packed weights each launch is handed: every launch gets the
    bfloat16 packs of the parameters as they are at that launch (a pack
    made before the optimizer wrote them differs: the last assert shows
    the packs of the two steps apart), both iterations of a step share one
    pack, each step packs anew, and the float32 packs are never made."""
    seen = {"motion": [], "gru": []}
    _through_autograd(monkeypatch, seen)
    model = RAFT(RAFTConfig(mixed_precision=True))
    model.load_state_dict(load_npz(WEIGHTS))
    tcfg = TrainConfig(**dict(KW, image_size=(32, 48)))
    state = create_train_state(model, tcfg)
    step = make_train_step(tcfg, update_impl="chain")
    batch = {k: torch.from_numpy(v[:, :32, :48]) for k, v in _batch().items()}
    for _ in range(2):
        assert step(state, batch)["skipped_steps"] == 0.0
    for name, packs in seen.items():
        assert len(packs) == 4, name
        assert packs[0] is packs[1] and packs[2] is packs[3], name
        assert all(t.dtype == BF16 for t in packs[0][0::2]), name
        assert not all(torch.equal(a, b) for a, b in zip(packs[0], packs[2]))
    block = model.update_block
    assert not hasattr(block.encoder, "_packed")
    assert not hasattr(block.gru, "_packed")


# -- the bf16 forms on the card -----------------------------------------------

def _card_inputs(device, h, w, seed):
    """net, inp, corr (Cc 324) and flow of the Sintel distribution, in
    bfloat16 on ``device``."""
    rng = np.random.default_rng(seed)
    acts = (np.tanh(rng.standard_normal((1, h, w, 128))),
            np.maximum(rng.standard_normal((1, h, w, 128)), 0),
            rng.standard_normal((1, h, w, 324)),
            rng.uniform(-20, 20, (1, h, w, 2)))
    return [_t(a).to(device=device, dtype=BF16) for a in acts]


def _card_held(got, want, control):
    top = float(want.float().abs().max())
    d = float((got.float() - want.float()).abs().max())
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    ctrl = float((control.float() - want.float()).norm()
                 / want.float().norm())
    assert got.dtype == BF16
    assert d <= 8 * EPS * max(1.0, top), d
    assert rel <= NORM_REL < ctrl, (rel, ctrl)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(24, 32), (55, 128)])
def test_bf16_motion_kernel_matches_plain_on_card(cuda, hw):
    """``motion_fwd``'s bf16 form against its plain version at the golden
    and Sintel feature shapes: the features within 8 EPS of max(1,
    max|plain|) and NORM_REL on the 2-norm, the float32 kernel on the same
    values above NORM_REL; the flow channels bit for bit."""
    model = RAFT(RAFTConfig())
    model.load_state_dict(load_npz(WEIGHTS))
    enc = model.update_block.encoder.to(cuda)
    _, _, cor, flow = _card_inputs(cuda, *hw, seed=1)
    with torch.inference_mode():
        before = motion_cuda.bf16_launches
        got = motion_cuda.motion_encoder_cuda(flow, cor,
                                              enc.packed_weights_bf16())
        assert motion_cuda.bf16_launches == before + 1
        want = motion_cuda.motion_encoder_plain(flow, cor, enc.convs())
        control = motion_cuda.motion_encoder_cuda(
            flow.float(), cor.float(), enc.packed_weights())
    torch.cuda.synchronize()
    _card_held(got[..., :126], want[..., :126], control[..., :126])
    assert torch.equal(got[..., 126:], flow)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(24, 32), (55, 128)])
@pytest.mark.parametrize("parts", [1, 2], ids=["x-whole", "x-parts"])
def test_bf16_gru_kernel_matches_plain_on_card(cuda, hw, parts):
    """``sepconv_gru``'s bf16 form against its plain version, x whole and
    as the chain's parts, with the bars of the motion test."""
    model = RAFT(RAFTConfig())
    model.load_state_dict(load_npz(WEIGHTS))
    block = model.update_block.to(cuda)
    net, inp, cor, flow = _card_inputs(cuda, *hw, seed=2)
    with torch.inference_mode():
        mot = motion_cuda.motion_encoder_plain(flow, cor,
                                               block.encoder.convs())
        x = (inp, mot) if parts == 2 else torch.cat([inp, mot], dim=-1)
        got = gru_cuda.sepconv_gru_cuda(net, x,
                                        block.gru.packed_weights_bf16())
        want = gru_cuda.sepconv_gru_plain(net, x, block.gru.convs())
        xf = (tuple(t.float() for t in x) if parts == 2 else x.float())
        control = gru_cuda.sepconv_gru_cuda(net.float(), xf,
                                            block.gru.packed_weights())
    torch.cuda.synchronize()
    _card_held(got, want, control)


@pytest.mark.cuda
def test_mixed_chain_block_launches_the_bf16_forms_on_card(cuda):
    """The mixed block on ``update_impl="chain"`` launches each bf16 chain
    form once an iteration and no float32 form, and its outputs lie within
    8 EPS of the plain block's (max(1, max|plain|); delta of its own
    largest value)."""
    model = RAFT(RAFTConfig())
    model.load_state_dict(load_npz(WEIGHTS))
    block = model.update_block.to(cuda).eval()
    acts = _card_inputs(cuda, 55, 128, seed=3)
    def counts():
        return (motion_cuda.bf16_launches, gru_cuda.bf16_launches,
                motion_cuda.launches, gru_cuda.launches)

    before = counts()
    with torch.inference_mode():
        got = block(*acts, compute_mask=True, update_impl="chain")
        after = counts()
        mot = motion_cuda.motion_encoder_plain(acts[3], acts[2],
                                               block.encoder.convs())
        net = gru_cuda.sepconv_gru_plain(acts[0], (acts[1], mot),
                                         block.gru.convs())
        want = (net, None, block.flow_head(net))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0, 0]
    for a, b, own in zip(got[::2], want[::2], (False, True)):
        top = float(b.float().abs().max())
        bar = 8 * EPS * (top if own else max(1.0, top))
        assert a.dtype == BF16
        assert float((a.float() - b.float()).abs().max()) <= bar
