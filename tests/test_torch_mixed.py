"""The bf16 mixed-precision policy of RAFT-large in the port against the JAX
package on the CPU, and the two bf16 kernel forms against their plain
versions on the card.

The same seeded numpy inputs, and the golden fixture's weights (torch names,
``convert_state_dict`` for JAX) or flax variables filled from a seed
(``sparse_fixture.filled_init``) carried into the port, go through both
packages. Tolerances, with ``EPS`` the bfloat16 epsilon (2^-7):

* the dtype levers resolve exactly as JAX's ``RAFTConfig`` does;
* the lookup's bf16 plain version against the TPU kernel in the Pallas
  interpreter: 1e-4 of max(1, max|JAX|) for float32 windows (the products
  of bfloat16 operands are exact; only the float32 summation order
  differs), ``EPS`` of it for bfloat16 windows (one rounding of values that
  agree to float32 noise);
* the bf16 pyramid: ``EPS`` of each level's largest value (the float32
  volume rounds to bfloat16, and a float32 matmul summed in another order
  may flip one rounding);
* the update step, the encoders and the whole model: 8 ``EPS`` of
  max(1, max|JAX|), the JAX package's own bar for its bf16 paths
  (``tests/test_step_pallas.py``): bfloat16 roundings in chains of up to
  20 convolutions, where one flipped rounding moves later ones. The flow
  update ``delta`` is held to 8 ``EPS`` of its own largest value, with no
  floor of 1: its values lie far below 1 px, so the floor would let a flow
  head off by tens of percent pass.

The ``cuda`` tests hold the bf16 forms of ``corr_fwd`` and ``update_step``
against their plain versions on the card; they skip here. On the card
(which has no JAX):

    python -m pytest --noconftest tests/test_torch_mixed.py -m cuda
"""

import itertools
import json
import os

import numpy as np
import pytest
import torch

from raft_tpu_torch import evaluate
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.models import corr
from raft_tpu_torch.models.extractor import BasicEncoder
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.models.update import BasicUpdateBlock
from raft_tpu_torch.ops import corr_cuda, sampling, step_cuda
from raft_tpu_torch.train import train
from raft_tpu_torch.weights import load_npz, state_dict_from_flax

try:
    import jax
    import jax.numpy as jnp

    import sparse_fixture as fixture
    from raft_tpu.config import RAFTConfig as JaxRAFTConfig
    from raft_tpu.models import corr as jcorr
    from raft_tpu.models import extractor as jextractor
    from raft_tpu.models import raft as jraft
    from raft_tpu.models.raft import RAFT as JaxRAFT
    from raft_tpu.models.update import BasicUpdateBlock as JaxUpdateBlock
    from raft_tpu.ops import gru_pallas, motion_pallas, step_pallas
    from raft_tpu.ops.corr_pallas import windowed_correlation_pallas_fused
    from raft_tpu.utils.torch_convert import convert_state_dict
except ModuleNotFoundError:
    # the card's machine has no JAX: only the ``cuda`` tests run there
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "assets", "golden")
WEIGHTS = os.path.join(GOLDEN, "weights.npz")
EPS = 2.0 ** -7                  # bfloat16 epsilon (jnp.finfo(bfloat16).eps)
BF16 = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    return np.asarray(t.detach().float().numpy() if torch.is_tensor(t)
                      else np.asarray(t.astype(jnp.float32)))


def _assert_near(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    diff = float(np.abs(got - want).max())
    assert diff <= tol, f"max|port - JAX| = {diff:.3e} > {tol:.3e}"


def _bar(want, rel):
    return rel * max(1.0, float(np.abs(_np(want)).max()))


def _own_bar(want, rel):
    """``rel`` of max|want|, for the flow update ``delta``."""
    return rel * float(np.abs(_np(want)).max())


def _compiled(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at a low XLA optimisation level."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=fixture.FAST_COMPILE)(*args)


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


# -- the dtype levers -------------------------------------------------------

LEVERS = list(itertools.product(
    [False, True], [False, True], ["auto", "float32", "bfloat16"],
    ["auto", "float32", "bfloat16"]))


@pytest.mark.parametrize("mixed,alternate,corr_dtype,mxu", LEVERS)
def test_dtype_levers_resolve_as_in_jax(mixed, alternate, corr_dtype, mxu):
    """``corr_storage``/``corr_mxu`` in inference and training, and the
    combinations both configs refuse, against JAX's ``RAFTConfig``."""
    kw = dict(mixed_precision=mixed, alternate_corr=alternate,
              corr_dtype=corr_dtype, corr_mxu_dtype=mxu)
    try:
        theirs = JaxRAFTConfig(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            RAFTConfig(**kw)
        return
    ours = RAFTConfig(**kw)
    assert ours.compute_dtype == ("bfloat16" if mixed else "float32")
    for inference in (False, True):
        assert ours.corr_storage(inference) == jnp.dtype(
            theirs.corr_storage(inference)).name
        assert ours.corr_mxu(inference) == theirs.corr_mxu(inference)


# -- the lookup, the pyramid ------------------------------------------------

B, H, W, C, R = 2, 6, 7, 16, 3


@pytest.fixture(scope="module")
def lookup_inputs():
    return lookup_arrays()


def lookup_arrays():
    """fmap1 and fmap2 (B, 6, 7, 16) and coords with flows up to 6 px."""
    rng = np.random.default_rng(11)
    f1 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)
    coords = (grid[None] + rng.uniform(-6, 6, (B, H, W, 2))).astype(np.float32)
    return f1, f2, coords


def jax_lookup(maps, out):
    """The TPU kernel with ``mxu_dtype="bfloat16"`` in the interpreter on
    ``lookup_arrays()``, the maps in ``maps``, the windows in ``out``."""
    f1, f2, coords = lookup_arrays()
    jdt = jnp.dtype(maps)
    return _compiled(lambda a, b, c: windowed_correlation_pallas_fused(
        a, jcorr.build_feature_pyramid(b, 2), c, R, interpret=True,
        mxu_dtype="bfloat16", out_dtype=jnp.dtype(out)),
        jnp.asarray(f1, jdt), jnp.asarray(f2, jdt), coords)


@pytest.mark.parametrize("maps,out", [("bfloat16", "bfloat16"),
                                      ("float32", "float32")])
def test_bf16_lookup_matches_pallas_interpret(lookup_inputs, maps, out):
    """The bf16 form's plain version (``mxu_dtype="bfloat16"``) against
    the TPU kernel with ``mxu_dtype="bfloat16"`` in the interpreter
    (``jax_lookup``, committed by ``tests/mixed_goldens.py``), on bfloat16
    maps with bfloat16 windows (the mixed model's lookup) and on float32
    maps with float32 windows (``corr_mxu_dtype="bfloat16"`` alone); the
    float32 maps' products differ from float32 ones by far more than the
    bar."""
    import mixed_goldens

    f1, f2, coords = lookup_inputs
    tdt = getattr(torch, maps)
    want = mixed_goldens.array(f"lookup.{maps}", out)
    pyr = corr.build_feature_pyramid(_t(f2).to(tdt), 2)
    got = corr.alternate_lookup(_t(f1).to(tdt), pyr, _t(coords), R,
                                mxu_dtype="bfloat16",
                                out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    bar = _bar(want, EPS if out == "bfloat16" else 1e-4)
    _assert_near(got, want, bar)
    if maps == "float32":
        f32 = corr.alternate_lookup(_t(f1), pyr, _t(coords), R)
        assert float((f32 - got).abs().max()) > 10 * bar


def test_bf16_form_refuses_what_it_was_not_built_for(lookup_inputs):
    """The bf16 form emits its windows in the maps' dtype and takes C 128
    or 256 (RAFT-small's and RAFT-large's widths): the wrapper refuses
    another window dtype or width before it looks at the device."""
    f1, f2, coords = lookup_inputs
    wide = _t(np.tile(f1, (1, 1, 1, 8)))
    pyr = corr.build_feature_pyramid(wide, 2)
    with pytest.raises(ValueError, match="maps' dtype"):
        corr_cuda.windowed_correlation_bf16_cuda(wide, pyr, _t(coords), R,
                                                 out_dtype=BF16)
    with pytest.raises(ValueError, match="C in"):
        corr_cuda.windowed_correlation_bf16_cuda(
            _t(f1), corr.build_feature_pyramid(_t(f2), 2), _t(coords), R)


def test_bf16_pyramid_matches_jax(lookup_inputs):
    """``build_corr_pyramid(storage="bfloat16")`` against JAX's
    ``storage_dtype=bfloat16``, level by level, and the lookup over it."""
    f1, f2, coords = lookup_inputs
    a, b = jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16)
    want = jax.jit(lambda a, b, c: (
        lambda p: (p, jcorr.pyramid_lookup(p, c, R)))(
            jcorr.build_corr_pyramid(a, b, 3, True, jnp.bfloat16)))(
        a, b, coords)
    ta, tb = _t(f1).to(BF16), _t(f2).to(BF16)
    pyr = corr.build_corr_pyramid(ta, tb, 3, True, "bfloat16")
    f32 = corr.build_corr_pyramid(ta, tb, 3, True)
    for got, jl, lv in zip(pyr, want[0], f32):
        assert got.dtype == BF16
        _assert_near(got, jl, EPS * float(np.abs(_np(jl)).max()))
        assert not torch.equal(got.float(), lv)
    windows = corr.pyramid_lookup(pyr, _t(coords), R)
    _assert_near(windows, want[1], _bar(want[1], EPS))


# -- the update step --------------------------------------------------------

SB, SH, SW, CC = 2, 9, 7, 12


@pytest.fixture(scope="module")
def step_setup():
    return step_arrays()


def step_arrays():
    """A flax ``BasicUpdateBlock`` filled from a seed, its JAX packings,
    the port's block with the same weights and bfloat16 inputs."""
    rng = np.random.default_rng(3)
    net = np.tanh(rng.standard_normal((SB, SH, SW, 128)))
    inp = np.maximum(rng.standard_normal((SB, SH, SW, 128)), 0)
    cor = rng.standard_normal((SB, SH, SW, CC))
    flow = 3.0 * rng.standard_normal((SB, SH, SW, 2))
    arrays = tuple(jnp.asarray(a, jnp.bfloat16)
                   for a in (net, inp, cor, flow))
    variables = fixture.filled_init(
        JaxUpdateBlock(), *(a.astype(jnp.float32) for a in arrays), seed=4)
    p = variables["params"]

    def pairs(mod, *names):
        return tuple((p[mod][n]["kernel"], p[mod][n]["bias"]) for n in names)

    mats = (motion_pallas.pack_weights(*pairs(
                "encoder", "convc1", "convc2", "convf1", "convf2", "conv")),
            gru_pallas.pack_weights(
                pairs("gru", "convz1", "convr1", "convq1"),
                pairs("gru", "convz2", "convr2", "convq2"), 128),
            step_pallas.pack_flow_head(*pairs("flow_head", "conv1",
                                              "conv2")))
    block = BasicUpdateBlock(128, 128, CC)
    block.load_state_dict(state_dict_from_flax(variables))
    ports = tuple(_t(np.asarray(a.astype(jnp.float32))).to(BF16)
                  for a in arrays)
    return variables, mats, block.eval(), arrays, ports


def jax_step(depth):
    """The TPU step kernel at ``dtype=bfloat16`` in the interpreter on
    ``step_arrays()``: (h2,) at depth 'mg', (h2, delta) at 'mgf'."""
    _, (mmats, gmats, fmats), _, arrays, _ = step_arrays()
    out = _compiled(lambda *a: step_pallas.fused_step(
        *a, mmats, gmats, fmats if depth == "mgf" else None,
        dtype=jnp.bfloat16, interpret=True), *arrays)
    return (out,) if depth == "mg" else out


@pytest.mark.parametrize("depth", ["mg", "mgf"])
def test_bf16_step_matches_pallas_fused_step(step_setup, depth):
    """The bf16 form's plain version against the TPU step kernel at
    ``dtype=bfloat16`` in the interpreter (``jax_step``, committed by
    ``tests/mixed_goldens.py``), at both depths."""
    import mixed_goldens

    _, _, block, _, ports = step_setup
    want = [mixed_goldens.array(f"step.{depth}.{name}", "bfloat16")
            for name in ("h2", "delta")[:1 if depth == "mg" else 2]]
    head = block.flow_head.convs() if depth == "mgf" else None
    got = step_cuda.fused_step_plain(
        *ports, (block.encoder.convs(), block.gru.convs(), head))
    if depth == "mg":
        got = (got,)
    for a, b, bar in zip(got, want, (_bar, _own_bar)):
        assert a.dtype == BF16
        _assert_near(a, b, bar(b, 8 * EPS))


def test_bf16_update_block_matches_jax(step_setup):
    """``BasicUpdateBlock`` in bfloat16 (the step plus the bfloat16 flow
    and mask heads) against the flax block at ``dtype=bfloat16`` on its
    conv path, the final iteration's outputs; ``chain`` runs bf16 too (the
    motion and GRU kernels' bf16 forms on the card, their plain versions
    here) and lies within the same bars."""
    variables, _, block, arrays, ports = step_setup
    jblock = JaxUpdateBlock(dtype=jnp.bfloat16)
    want = _compiled(lambda v, *a: jblock.apply(v, *a, compute_mask=True),
                     variables, *arrays)
    with torch.inference_mode():
        got = block(*ports, compute_mask=True)
        chain = block(*ports, update_impl="chain")
    for outs in (got, chain):
        for a, b, bar in zip(outs, want, (_bar, _bar, _own_bar)):
            assert a.dtype == BF16
            _assert_near(a, b, bar(b, 8 * EPS))


# -- the encoder ------------------------------------------------------------

def test_bf16_conv_rounds_as_flax():
    """One convolution at ``dtype=bfloat16``: flax rounds its float32 sum to
    bfloat16 and then adds the bfloat16 bias in bfloat16. The port's
    ``extractor.conv`` (a bias-free bfloat16 convolution, then the bias)
    and the kernels' plain ``conv_pack.conv2d`` agree with it but for a
    few flips of summation order (at most 0.1% of the outputs, one ulp);
    a convolution with the bias fused into its float32 sum, rounded once,
    moves many more (over 5%): the rounding point the port keeps."""
    import flax.linen as fnn

    from raft_tpu_torch.models.extractor import conv
    from raft_tpu_torch.ops.conv_pack import conv2d

    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (2, 16, 24, 64)).astype(np.float32)
    k = (0.05 * rng.standard_normal((3, 3, 64, 96))).astype(np.float32)
    b = (0.1 * rng.standard_normal(96)).astype(np.float32)
    want = _np(fnn.Conv(96, (3, 3), padding=1, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": k, "bias": b}}, jnp.asarray(x, jnp.bfloat16)))
    layer = torch.nn.Conv2d(64, 96, 3, padding=1)
    with torch.no_grad():
        layer.weight.copy_(_t(k).permute(3, 2, 0, 1))
        layer.bias.copy_(_t(b))
        xt = _t(x).permute(0, 3, 1, 2).to(BF16)
        fused = torch.nn.functional.conv2d(
            xt.float(), layer.weight.to(BF16).float(),
            layer.bias.to(BF16).float(), padding=1).to(BF16)
        outs = [conv(layer, xt), conv2d(xt, layer.weight, layer.bias, 1),
                fused]
    assert all(t.dtype == BF16 for t in outs)
    outs = [_np(t.permute(0, 2, 3, 1)) for t in outs]
    for got in outs[:2]:
        assert np.mean(got != want) <= 1e-3
        _assert_near(got, want, _bar(want, EPS))
    assert np.mean(outs[2] != want) > 0.05

@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_bf16_basic_encoder_matches_jax(norm_fn):
    """``BasicEncoder`` on a bfloat16 input (bfloat16 convolutions over
    float32 parameters, float32 norm statistics) against flax's at
    ``dtype=bfloat16``."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    variables = fixture.filled_init(jextractor.BasicEncoder(64, norm_fn),
                                    jnp.asarray(x), seed=1)
    want = _compiled(jextractor.BasicEncoder(64, norm_fn,
                                             dtype=jnp.bfloat16).apply,
                     variables, jnp.asarray(x, jnp.bfloat16))
    enc = BasicEncoder(64, norm_fn)
    enc.load_state_dict(state_dict_from_flax(variables))
    with torch.inference_mode():
        got = enc.eval()(_t(x).to(BF16))
    assert got.dtype == BF16 and all(
        p.dtype == torch.float32 for p in enc.parameters())
    _assert_near(got, want, _bar(want, 8 * EPS))


# -- the whole model --------------------------------------------------------

@pytest.fixture(scope="module")
def npz_state():
    with np.load(WEIGHTS) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}


@pytest.fixture(scope="module")
def frames():
    """64x96 crops of the first golden pair, float32 in [0, 255]."""
    from raft_tpu_torch.data import frame_utils

    pair = json.load(open(os.path.join(GOLDEN, "manifest.json")))["pairs"][0]
    root = os.path.join(REPO, "assets", "demo-frames")
    ims = [np.asarray(frame_utils.read_gen(os.path.join(root, pair[k])),
                      np.float32)[64:128, 80:176]
           for k in ("frame1", "frame2")]
    return ims[0][None], ims[1][None]


@pytest.fixture(scope="module")
def mixed_model():
    model = RAFT(RAFTConfig(mixed_precision=True))
    model.load_state_dict(load_npz(WEIGHTS))
    return model.eval()


@pytest.mark.parametrize("alternate_corr", [False, True])
def test_mixed_raft_matches_jax(mixed_model, npz_state, frames,
                                alternate_corr):
    """RAFT-large with ``mixed_precision=True`` at 64x96, iters=3, against
    JAX's mixed model on the same converted weights, through each engine:
    the all-pairs pyramid stored in bfloat16, or the on-demand lookup on
    bfloat16 maps emitting bfloat16 windows. The flows come back float32."""
    img1, img2 = frames
    jmodel = JaxRAFT(JaxRAFTConfig(alternate_corr=alternate_corr,
                                   mixed_precision=True))
    jlow, jup = _compiled(
        lambda v, a, b: jmodel.apply(v, a, b, iters=3, test_mode=True),
        convert_state_dict(npz_state), img1, img2)
    with torch.inference_mode():
        low, up = mixed_model(_t(img1), _t(img2), iters=3,
                              alternate_corr=alternate_corr)
    assert low.dtype == up.dtype == torch.float32
    assert low.shape == (1, 8, 12, 2) and up.shape == (1, 64, 96, 2)
    _assert_near(low, jlow, _bar(jlow, 8 * EPS))
    _assert_near(up, jup, _bar(jup, 8 * EPS))


# -- the serving entry points under the policy --------------------------------

EE = (1e3, 2)    # every update lies below tol: each slot exits after 2 iterations


@pytest.fixture(scope="module")
def batch2(frames):
    """The pair and the reversed pair: (2, 64, 96, 3) first and second
    images."""
    img1, img2 = frames
    return np.concatenate([img1, img2]), np.concatenate([img2, img1])


@pytest.mark.parametrize("alternate_corr", [False, True],
                         ids=["allpairs", "alternate"])
def test_mixed_serving_entry_points_reproduce_the_forward(
        mixed_model, batch2, alternate_corr):
    """Under the bf16 policy, on each engine, through ``FlowPredictor``:
    the step-granular refine (``step_carry_dispatch``, ``step_dispatch`` in
    two chunks, ``step_finalize_dispatch``) gives ``dispatch_batch(iters=4)``
    bit for bit, without early exit and with it (``iters_used`` equal too),
    and its carry holds ``net``, ``inp`` and the engine's payload in
    bfloat16 and the coordinates in float32. A warm refine from encoded
    maps (``encode_dispatch``, ``refine_dispatch``) is the pair call with
    the same ``flow_init`` within 8 ``EPS`` of max(1, max|flow|): the
    encoder sees one image where the pair call's sees two, and a flipped
    bfloat16 rounding moves what follows."""
    model = mixed_model
    if alternate_corr:
        model = RAFT(RAFTConfig(mixed_precision=True, alternate_corr=True))
        model.load_state_dict(mixed_model.state_dict())
        model.eval()
    img1, img2 = batch2
    for ee in (None, EE):
        pred = evaluate.FlowPredictor(model, iters=4, device="cpu",
                                      corr_impl="fixed", early_exit=ee)
        assert pred.alternate_corr == alternate_corr
        want = pred.dispatch_batch(img1, img2, iters=4)
        carry = pred.step_carry_dispatch(img1, img2)
        payload = carry["corr"]
        if alternate_corr:
            payload = (payload[0], *payload[1])
        assert all(t.dtype == BF16 for t in (carry["net"], carry["inp"],
                                             *payload))
        assert carry["coords0"].dtype == carry["coords1"].dtype == (
            torch.float32)
        carry, rem = pred.step_dispatch(carry, [3, 3], 2)
        carry, rem = pred.step_dispatch(carry, rem, 1)
        got = pred.step_finalize_dispatch(carry)
        assert all(torch.equal(a, b) for a, b in zip(got, want[:2]))
        assert got[0].dtype == got[1].dtype == torch.float32
        if ee is not None:
            assert want[2].tolist() == [3, 3]
            assert torch.equal(carry["used"] + 1, want[2])
    fm1, fm2 = (pred.encode_dispatch(im[:1]) for im in (img1, img2))
    assert fm1.dtype == BF16
    init = want[0][:1].numpy()
    warm = pred.refine_dispatch(img1[:1], fm1, fm2, flow_init=init,
                                warm=True, iters=4)
    pair = pred(img1[0], img2[0], flow_init=init[0])
    for a, b in zip(warm, pair):
        _assert_near(a[0], b, _bar(b, 8 * EPS))


def test_mixed_refine_matches_jax(mixed_model, npz_state, batch2):
    """The step-granular refine under the bf16 policy on the on-demand
    engine (the card's serving route) against JAX's mixed ``refine_init``,
    ``refine_chunk`` (3 iterations, early exit ``EE``) and
    ``refine_finalize``, each package on its own carry: the flows within 8
    ``EPS`` of max(1, max|JAX|), ``used`` and the budgets left equal."""
    img1, img2 = batch2
    cfg = JaxRAFTConfig(alternate_corr=True, mixed_precision=True)
    jmodel = JaxRAFT(cfg)

    def program(v, a, b):
        carry = jmodel.apply(v, a, b, method=JaxRAFT.refine_init)
        carry, rem = jraft.refine_chunk(cfg, v, carry,
                                        jnp.asarray([3, 3], jnp.int32), 3, EE)
        return jraft.refine_finalize(cfg, v, carry), carry["used"], rem

    (jlow, jup), jused, jrem = _compiled(
        program, convert_state_dict(npz_state), img1, img2)
    with torch.inference_mode():
        carry = mixed_model.refine_init(_t(img1), _t(img2),
                                        alternate_corr=True)
        carry, rem = mixed_model.refine_chunk(
            carry, torch.tensor([3, 3], dtype=torch.int32), 3, EE)
        low, up = mixed_model.refine_finalize(carry)
    assert carry["used"].tolist() == np.asarray(jused).tolist() == [2, 2]
    assert rem.tolist() == np.asarray(jrem).tolist()
    _assert_near(low, jlow, _bar(jlow, 8 * EPS))
    _assert_near(up, jup, _bar(jup, 8 * EPS))


def test_mixed_golden_on_cpu_via_cli(capsys):
    """The port's mixed policy through the CLI on the CPU (the all-pairs
    engine, its pyramid stored in bfloat16) holds the JAX package's CPU
    golden band (``assets/golden/cpu_reference.json``, made with
    ``corr_impl="fixed"``): GT EPE within 0.02 of it, parity EPE at most
    its own plus 0.02."""
    with open(os.path.join(GOLDEN, "cpu_reference.json")) as f:
        ref = json.load(f)
    results = evaluate.main(["--model", WEIGHTS, "--dataset", "golden",
                             "--device", "cpu", "--mixed_precision",
                             "--corr_impl", "fixed"])
    assert "Validation Golden[large]" in capsys.readouterr().out
    assert abs(results["golden_gt_epe"]
               - ref["policy_mixed_gt_epe_cpu"]) < 0.02, results
    assert results["golden_parity_epe"] <= (
        ref["policy_mixed_parity_epe_cpu"] + 0.02), results


def test_bf16_storage_trains_through_the_pyramid(frames):
    """An explicit ``corr_dtype="bfloat16"`` is honoured in training, as in
    JAX: the pyramid is stored in bfloat16 (the flows differ from the
    float32 storage's), the gradients reach ``fnet`` through it, and
    ``resolve_train_corr_engine`` pins the all-pairs engine even on the
    card."""
    from raft_tpu_torch.train import resolve_train_corr_engine

    cfg = RAFTConfig(corr_dtype="bfloat16")
    assert not resolve_train_corr_engine(torch.device("cuda"), "auto", cfg)
    flows, grads = [], []
    for config in (cfg, RAFTConfig()):
        model = RAFT(config)
        model.load_state_dict(load_npz(WEIGHTS))
        out = model(_t(frames[0]), _t(frames[1]), iters=1, train=True)
        out.abs().mean().backward()
        flows.append(out.detach())
        grads.append(model.fnet.conv2.weight.grad)
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
               for g in grads)
    assert flows[0].dtype == torch.float32 and bool(
        torch.isfinite(flows[0]).all())
    assert not torch.equal(flows[0], flows[1])


def test_mixed_predictor_and_refusals(frames):
    """``load_predictor(mixed_precision=)`` builds the policy's model with
    the float32 weights (``corr_dtype`` pins the fixed engine, as in JAX),
    whose training forward returns float32 predictions, on
    ``update_impl="chain"`` too (``train`` takes a step there, also with an
    explicit ``corr_mxu_dtype="bfloat16"``); RAFT-small under the policy
    builds with float32 parameters and returns float32 flows; what stays
    unported refuses: the sparse family's bf16."""
    pred = evaluate.load_predictor(WEIGHTS, iters=2, device="cpu",
                                   mixed_precision=True)
    cfg = pred.model.config
    assert cfg.mixed_precision and not pred.alternate_corr
    assert all(p.dtype == torch.float32 for p in pred.model.parameters())
    low, up = pred(frames[0][0], frames[1][0])
    assert low.dtype == up.dtype == np.float32 and np.isfinite(up).all()
    pinned = evaluate.load_predictor(WEIGHTS, device="cpu",
                                     corr_dtype="bfloat16", corr_impl=None)
    assert pinned.model.config.corr_storage(True) == "bfloat16"
    preds = pred.model(_t(frames[0]), _t(frames[1]), iters=1, train=True)
    assert preds.dtype == torch.float32 and preds.shape == (1, 1, 64, 96, 2)
    batch = {"image1": frames[0][:, :32, :48],
             "image2": frames[1][:, :32, :48],
             "flow": np.zeros((1, 32, 48, 2), np.float32),
             "valid": np.ones((1, 32, 48), np.float32)}
    for cfg in (RAFTConfig(mixed_precision=True),
                RAFTConfig(mixed_precision=True, alternate_corr=True,
                           corr_mxu_dtype="bfloat16")):
        state = train(TrainConfig(num_steps=1, iters=1, batch_size=1,
                                  image_size=(32, 48)), cfg,
                      dataloader=[batch], restore_ckpt=WEIGHTS, device="cpu",
                      update_impl="chain")
        assert state.step == 1
    chain = pred.model(_t(frames[0]), _t(frames[1]), iters=1, train=True,
                       update_impl="chain")
    assert chain.dtype == torch.float32 and bool(torch.isfinite(chain).all())
    small = RAFT(RAFTConfig(small=True, mixed_precision=True))
    small.load_state_dict(load_npz(os.path.join(GOLDEN,
                                                "weights_small.npz")))
    assert all(p.dtype == torch.float32 for p in small.parameters())
    with torch.inference_mode():
        low, up = small.eval()(_t(frames[0]), _t(frames[1]), iters=1)
    assert low.dtype == up.dtype == torch.float32
    assert bool(torch.isfinite(up).all())
    with pytest.raises(NotImplementedError, match="bf16 policy"):
        evaluate.load_predictor("random", model_family="sparse",
                                mixed_precision=True, device="cpu")


# -- the bf16 forms on the card ----------------------------------------------

def _coherent_coords(rng, b, h, w, px, device):
    flow = rng.uniform(-px, px, (b, 1, 1, 2)) + rng.uniform(-1, 1,
                                                           (b, h, w, 2))
    return (sampling.coords_grid(b, h, w, device)
            + _t(flow).to(device)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0, 10 ** 8])
@pytest.mark.parametrize("maps,out", [("bfloat16", "bfloat16"),
                                      ("float32", "float32")])
@pytest.mark.parametrize("hw", [(24, 32), (55, 128)])
def test_bf16_lookup_kernel_matches_plain_on_card(cuda, hw, maps, out,
                                                  budget, monkeypatch):
    """The bf16 form of ``corr_fwd`` against its plain version (C=256, 4
    levels, r=4) with each path forced (budget 0: the warp path; 10**8:
    the shared tile), on coherent flows, on bfloat16 maps and windows and
    on float32 ones; bars as the CPU test's."""
    monkeypatch.setattr(corr_cuda, "TILE_BUDGET", budget)
    rng = np.random.default_rng(7)
    h, w = hw
    tdt, odt = getattr(torch, maps), getattr(torch, out)
    f1 = _t(rng.standard_normal((1, h, w, 256))).to(cuda, tdt)
    pyr = corr.build_feature_pyramid(
        _t(rng.standard_normal((1, h, w, 256))).to(cuda, tdt), 4)
    coords = _coherent_coords(rng, 1, h, w, 8.0, cuda)
    before = corr_cuda.bf16_launches
    with torch.inference_mode():
        got = corr.alternate_lookup(f1, pyr, coords, 4, mxu_dtype="bfloat16",
                                    out_dtype=odt)
        want = corr_cuda.windowed_correlation_fused_plain(
            f1, pyr, coords, 4, mxu_dtype="bfloat16", out_dtype=odt)
    assert corr_cuda.bf16_launches == before + 1 and got.dtype == odt
    scale = max(1.0, float(want.float().abs().max()))
    bar = (EPS if out == "bfloat16" else 1e-4) * scale
    assert float((got.float() - want.float()).abs().max()) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("depth", ["mg", "mgf"])
@pytest.mark.parametrize("bhw", [(1, 55, 128), (2, 13, 17), (8, 46, 62)])
def test_bf16_step_kernel_matches_plain_on_card(cuda, bhw, depth,
                                                monkeypatch):
    """The bf16 form of ``update_step`` through ``BasicUpdateBlock`` on
    bfloat16 inputs against its plain version, at the Sintel feature shape,
    a ragged B=2 one (M not a multiple of 64; W = 17, one 64-pixel row
    segment of the bf16 tile with 47 pixels past W) and the chairs
    training batch (B=8, 46x62); bar 8 ``EPS`` of max(1, max|plain|) for
    h2 and of max|plain| for delta."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(9)
    b, h, w = bhw
    block = BasicUpdateBlock().to(cuda).eval()

    def bf16(a):
        return _t(a).to(cuda, BF16)

    net = bf16(np.tanh(rng.standard_normal((b, h, w, 128))))
    inp = bf16(np.maximum(rng.standard_normal((b, h, w, 128)), 0))
    cor = bf16(rng.standard_normal((b, h, w, 324)))
    flow = bf16(rng.uniform(-20, 20, (b, h, w, 2)))
    head = block.flow_head.convs() if depth == "mgf" else None
    before = step_cuda.bf16_launches
    with torch.inference_mode():
        got = block(net, inp, cor, flow,
                    compute_mask=None if depth == "mgf" else True)
        want = step_cuda.fused_step_plain(
            net, inp, cor, flow,
            (block.encoder.convs(), block.gru.convs(), head))
    assert step_cuda.bf16_launches == before + 1
    pairs = [(got[0], want[0] if depth == "mgf" else want, 1.0)]
    if depth == "mgf":
        pairs.append((got[2], want[1], 0.0))
    for a, b_, floor in pairs:
        assert a.dtype == BF16
        bar = 8 * EPS * max(floor, float(b_.float().abs().max()))
        assert float((a.float() - b_.float()).abs().max()) <= bar
