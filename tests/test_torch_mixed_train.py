"""bf16 mixed-precision training of RAFT-large in the port against the JAX
package on the CPU, and its bf16 backward kernels against their plain
versions on the card.

The same seeded numpy inputs, and the golden fixture's weights (torch names,
``convert_state_dict`` for JAX) or flax variables filled from a seed
(``sparse_fixture.filled_init``) carried into the port, go through both
packages. ``EPS`` is the bfloat16 epsilon (2^-7); one ``EPS`` of a
tensor's largest value lies between one and two bfloat16 ulps of it.

* The lookup's backward (``corr_cuda.windowed_correlation_bwd_plain``, the
  bf16 kernel's plain version) against the TPU kernel's custom VJP
  (``_windowed_bwd``, the Pallas kernel in the interpreter), for the three
  operand combinations of the policy. Both round the same operands (under
  ``mxu_dtype="bfloat16"`` the maps and each dot's cotangent) and sum in
  float32: the float32 sums (the same maps in float32 on both sides) within
  ``SUM_REL`` of max|JAX|, where the plain version at the other
  ``mxu_dtype`` (the control) lies further off; bfloat16 gradients, the sum
  rounded once to the maps' dtype, within one ``EPS`` (a flipped rounding
  is an ulp).
* The step's bfloat16 backward (``fused_step_autograd``'s recompute through
  ``fused_step_plain``) and the whole mixed train step: each quantity
  within twice JAX's own distance between its bf16 and float32 results for
  that quantity, the policy's own shift. JAX is compiled to round at every
  bfloat16 operation, as the policy does on a TPU (``_compiled``). The
  train step's float32 result is the port's float32 step, which
  ``tests/test_torch_train_step.py`` holds to JAX's. A scalar of the train
  step (loss, EPE, gradient norm) is one draw of the roundings, so JAX's
  distance for it is the larger of its two compiles' (with and without
  XLA's excess precision); the pixel shares (``1px``, ``3px``, ``5px``)
  move by whole pixels of the valid mask and are held to twice JAX's
  distance or one pixel, the larger. Gradients are compared, not
  parameters after AdamW: Adam's first step is lr * g / |g|, which turns
  rounding noise near zero into moves of up to 2 lr
  (``tests/test_torch_train_step.py``). The conv biases in front of the
  encoders' norms get a gradient that is rounding noise on both sides
  (``_cancelled_by_norm``): they are held to being that small.

The ``cuda`` tests hold the bf16 corr backward kernel and a mixed train
step through the kernels against their plain versions on the card; they
skip here. On the card (which has no JAX):

    python -m pytest --noconftest tests/test_torch_mixed_train.py -m cuda
"""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raft_tpu_torch.config import OursConfig, RAFTConfig, TrainConfig
from raft_tpu_torch.models import corr
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.models.update import BasicUpdateBlock
from raft_tpu_torch.ops import corr_cuda, step_cuda
from raft_tpu_torch.parallel.train_step import (create_train_state,
                                                make_train_step)
from raft_tpu_torch.train import train
from raft_tpu_torch.weights import load_npz, state_dict_from_flax

try:
    import jax
    import jax.numpy as jnp

    import sparse_fixture as fixture
    from raft_tpu.config import RAFTConfig as JaxRAFTConfig
    from raft_tpu.config import TrainConfig as JaxTrainConfig
    from raft_tpu.models import corr as jcorr
    from raft_tpu.models.raft import RAFT as JaxRAFT
    from raft_tpu.models.update import BasicUpdateBlock as JaxUpdateBlock
    from raft_tpu.ops import gru_pallas, motion_pallas, step_pallas
    from raft_tpu.ops.corr_pallas import windowed_correlation_pallas_fused
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


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _dist(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _compiled(fn, *args, excess=False):
    """``jax.jit(fn)(*args)`` compiled at a low XLA optimisation level,
    rounding at every bfloat16 operation unless ``excess``: XLA on the CPU
    keeps bfloat16 intermediates in float32 where it can by default (its
    excess-precision option), which the policy on a TPU does not, and which
    left JAX's bf16 gradients nearer its float32 ones than the policy's
    roundings put them (up to 2.7 times nearer for a bias summed over every
    pixel)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        **fixture.FAST_COMPILE,
        "xla_allow_excess_precision": excess})(*args)


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


# -- the bf16 corr backward ---------------------------------------------------

B, H, W = 1, 6, 7
# (maps, mxu_dtype, cotangent, C, r, rescale, levels): the policy's three
# operand combinations (bfloat16 maps with float32 products,
# mixed_precision alone; bfloat16 maps with bfloat16 products, with an
# explicit corr_mxu_dtype="bfloat16"; float32 maps with bfloat16 products,
# that lever alone), both widths, both radii, both lookups and both
# cotangent dtypes among them; df1 summed over two levels in the first
# (each case is one JAX compile of the interpreted kernels, a few seconds
# a level; the card's test takes every combination at every shape)
CORR_CASES = [
    ("bfloat16", "float32", "bfloat16", 256, 4, True, 2),
    ("bfloat16", "bfloat16", "bfloat16", 128, 3, False, 1),
    ("float32", "bfloat16", "float32", 256, 3, True, 1)]


def _corr_inputs(c, r, seed, levels, b=B, h=H, w=W, px=5.0):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    coords = (grid[None] + rng.uniform(-px, px, (b, h, w, 2))).astype(
        np.float32)
    g = rng.standard_normal((b, h, w, levels * (2 * r + 1) ** 2)).astype(
        np.float32)
    return f1, f2, coords, g


# float32 sums of the plain version against JAX's (2.5e-7 of max|JAX| at
# most on these cases; the control at the other mxu_dtype 1.8e-3 at least)
SUM_REL = 1e-5


@pytest.mark.parametrize("maps,mxu,gdt,c,r,rescale,levels", CORR_CASES)
def test_bf16_corr_backward_matches_pallas_interpret(maps, mxu, gdt, c, r,
                                                     rescale, levels):
    """``windowed_correlation_bwd_plain`` with the bf16 kernel's dtypes
    against ``jax.vjp`` of ``windowed_correlation_pallas_fused`` (its
    custom VJP runs the Pallas ``_bwd_kernel`` in the interpreter) with the
    same ``mxu_dtype``, the windows and cotangent in ``gdt``: df1 and each
    df2 in the maps' dtype within one ``EPS`` of max|JAX| (bfloat16) or
    ``SUM_REL`` (float32); on float32 copies of the maps, the float32 sums
    within ``SUM_REL``, and the plain version at the other ``mxu_dtype``
    further off than that."""
    f1, f2, coords, g = _corr_inputs(c, r, c + r, levels)
    gj, gt = jnp.dtype(gdt), _t(g).to(getattr(torch, gdt))
    tdt = getattr(torch, maps)
    t1 = _t(f1).to(tdt)
    pyr = corr.build_feature_pyramid(_t(f2).to(tdt), levels)

    def vjp(a, p, cc, gg):
        _, back = jax.vjp(lambda a, p: windowed_correlation_pallas_fused(
            a, p, cc, r, interpret=True, mxu_dtype=mxu, out_dtype=gj,
            rescale=rescale), a, p)
        return back(gg)

    def check(a, p, bar, dtype):
        want = _compiled(vjp, jnp.asarray(_np(a), dtype),
                         [jnp.asarray(_np(x), dtype) for x in p], coords,
                         jnp.asarray(g, gj))
        want = (want[0], *want[1])
        other = "float32" if mxu == "bfloat16" else "bfloat16"
        got, ctrl = (corr_cuda.windowed_correlation_bwd_plain(
            a, p, _t(coords), gt, r, rescale=rescale, mxu_dtype=m)
            for m in (mxu, other))
        assert len(got[1]) == len(want) - 1 == levels
        for x, y, z in zip((got[0], *got[1]), want, (ctrl[0], *ctrl[1])):
            assert x.dtype == a.dtype and y.dtype == dtype
            top = float(np.abs(_np(y)).max())
            assert _dist(x, y) <= bar * top, (_dist(x, y) / top, bar)
            if dtype == jnp.float32:
                assert _dist(z, y) > SUM_REL * top, _dist(z, y) / top

    if maps == "bfloat16":
        check(t1, pyr, EPS, jnp.bfloat16)
    check(t1.float(), [p.float() for p in pyr], SUM_REL, jnp.float32)


def test_bf16_corr_backward_wrapper_refuses_what_it_was_not_built_for():
    """The bf16 backward takes C 128 or 256 and leaves float32 maps with
    float32 products to the float32 kernel: its wrapper refuses those
    before it looks at the device."""
    f1, f2, coords, g = _corr_inputs(128, 4, 1, 2)
    pyr = corr.build_feature_pyramid(_t(f2), 2)
    with pytest.raises(ValueError, match="float32 products"):
        corr_cuda.windowed_correlation_bwd_bf16_cuda(
            _t(f1), pyr, _t(coords), _t(g), 4, mxu_dtype="float32")
    narrow = _t(f1[..., :64]).to(BF16)
    with pytest.raises(ValueError, match="C in"):
        corr_cuda.windowed_correlation_bwd_bf16_cuda(
            narrow, tuple(p[..., :64].to(BF16) for p in pyr), _t(coords),
            _t(g), 4)


# -- the bf16 step under autograd ---------------------------------------------

SB, SH, SW, CC = 2, 9, 7, 12


@pytest.fixture(scope="module")
def step_grads():
    """A flax ``BasicUpdateBlock`` filled from a seed and the port's block
    with its weights; ``jax.vjp`` of JAX's bf16 fused step at depth 'mg'
    (the training depth: the custom VJP recomputes through
    ``reference_step``) with the packing inside the function, so that the
    gradients reach the flax parameters; the port's gradients through
    ``fused_step_autograd`` with the plain version in the kernel's place
    (the card runs the kernel there), from the same bfloat16 inputs and
    cotangent; and the float32 gradients of the same values through the
    float32 plain step (``tests/test_torch_grad.py`` holds those to JAX's
    custom VJP). Returns ``{name: (port, JAX bf16, float32)}``."""
    rng = np.random.default_rng(3)
    acts = [np.tanh(rng.standard_normal((SB, SH, SW, 128))),
            np.maximum(rng.standard_normal((SB, SH, SW, 128)), 0),
            rng.standard_normal((SB, SH, SW, CC)),
            3.0 * rng.standard_normal((SB, SH, SW, 2))]
    acts = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            for a in acts]
    g = np.asarray(jnp.asarray(rng.standard_normal((SB, SH, SW, 128)),
                               jnp.bfloat16).astype(jnp.float32))
    variables = fixture.filled_init(
        JaxUpdateBlock(), *(jnp.asarray(a) for a in acts), seed=4)
    p = variables["params"]

    def pairs(tree, mod, *names):
        return tuple((tree[mod][n]["kernel"], tree[mod][n]["bias"])
                     for n in names)

    def vjp(tree, net, inp, cor, flow, gg):
        def step(tree, *a):
            mmats = motion_pallas.pack_weights(*pairs(
                tree, "encoder", "convc1", "convc2", "convf1", "convf2",
                "conv"))
            gmats = gru_pallas.pack_weights(
                pairs(tree, "gru", "convz1", "convr1", "convq1"),
                pairs(tree, "gru", "convz2", "convr2", "convq2"), 128)
            return step_pallas.fused_step(*a, mmats, gmats, None,
                                          dtype=jnp.bfloat16, interpret=True)

        return jax.vjp(step, tree, net, inp, cor, flow)[1](gg)

    out = _compiled(vjp, {k: p[k] for k in ("encoder", "gru")},
                    *(jnp.asarray(a, jnp.bfloat16) for a in acts),
                    jnp.asarray(g, jnp.bfloat16))
    named = state_dict_from_flax(
        {"params": {**jax.tree_util.tree_map(np.zeros_like, p), **out[0]}})
    jax_grads = dict(zip(("net", "inp", "corr", "flow"), out[1:]))
    jax_grads.update({k: v for k, v in named.items()
                      if k.split(".")[0] in ("encoder", "gru")})

    block = BasicUpdateBlock(128, 128, CC)
    block.load_state_dict(state_dict_from_flax(variables))
    convs = (block.encoder.convs(), block.gru.convs(), None)
    grads = []
    for dt in (BF16, torch.float32):
        block.zero_grad(set_to_none=True)
        leaves = [_t(a).to(dt).requires_grad_(True) for a in acts]
        h2 = step_cuda.fused_step_autograd(
            *leaves, convs, lambda *a: step_cuda.fused_step_plain(*a, convs))
        assert h2.dtype == dt
        h2.backward(_t(g).to(dt))
        got = dict(zip(("net", "inp", "corr", "flow"),
                       (t.grad for t in leaves)))
        got.update({k: prm.grad for k, prm in block.named_parameters()
                    if k.split(".")[0] in ("encoder", "gru")})
        grads.append(got)
    return {k: (grads[0][k], jax_grads[k], grads[1][k]) for k in grads[0]}


def test_bf16_step_recompute_gradients_match_jax(step_grads):
    """Every activation's and raw weight's gradient of the bf16 step
    (depth 'mg') within twice the distance between JAX's bf16 and the
    float32 gradient of it;
    the activations' gradients come back bfloat16, the weights' float32."""
    assert len(step_grads) == 4 + 2 * 11
    for name, (got, want, f32) in step_grads.items():
        assert got is not None and bool(torch.isfinite(got).all()), name
        assert got.dtype == (BF16 if "." not in name else torch.float32)
        bar = 2 * _dist(want, f32)
        assert 0 < bar and _dist(got, want) <= bar, (name, _dist(got, want),
                                                      bar)


# -- one whole mixed train step -----------------------------------------------

KW = dict(batch_size=1, image_size=(64, 64), num_steps=100, iters=2)
METRICS = ("loss", "epe", "1px", "3px", "5px")


def _batch():
    rng = np.random.default_rng(11)
    img1 = rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    return {"image1": img1,
            "image2": np.roll(img1, (1, -2), axis=(1, 2)),
            "flow": (2.0 * rng.standard_normal((1, 64, 64, 2))).astype(
                np.float32),
            "valid": (rng.uniform(size=(1, 64, 64)) > 0.2).astype(
                np.float32)}


def _jax_step(npz, batch, mixed: bool, excess: bool = False):
    """JAX's ``make_train_step`` on the fixture weights at ``KW``:
    (metrics, the clipped gradient, the batch-norm statistics after the
    step), the last two with torch names. AdamW's first moment after one
    step is (1 - b1) times the clipped gradient, so the state carries it.
    ``excess``: compiled with XLA's excess precision (``_compiled``)."""
    state, unflatten = fixture.flat_train_state(
        JaxRAFT(JaxRAFTConfig(iters=KW["iters"], mixed_precision=mixed)),
        convert_state_dict(npz), jax_fetch_optimizer(JaxTrainConfig(**KW)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    state, metrics = _compiled(jax_train_step(JaxTrainConfig(**KW),
                                              donate=False),
                               state, jbatch, key, excess=excess)
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu"))
    grads = state_dict_from_flax(unflatten(SimpleNamespace(
        params={"flat": adam.mu["flat"] / 0.1},
        batch_stats=state.batch_stats)))
    stats = state_dict_from_flax(unflatten(state))
    return ({k: float(v) for k, v in metrics.items()}, grads,
            {k: v for k, v in stats.items() if "running" in k})


def _cancelled_by_norm(name: str) -> bool:
    """The encoders' conv biases but the final projection's feed a norm
    (fnet's instance norms, cnet's batch norms on batch statistics), which
    subtracts them again: their gradient is 0 up to rounding."""
    return re.fullmatch(r"[fc]net\.(conv1|layer\d\.\d\.(conv\d|downsample"
                        r"\.0))\.bias", name) is not None


@pytest.fixture(scope="module")
def mixed_steps():
    """JAX's mixed step (rounding at every bfloat16 operation), the
    metrics of its mixed step as XLA on the CPU compiles it by default, the
    float32 step, and the port's mixed step (through ``make_train_step``),
    from the fixture weights on one batch. The float32 step is the port's:
    ``tests/test_torch_train_step.py`` holds it to JAX's (loss 1e-5,
    gradient norm 1e-4 relative, every parameter after AdamW within lr/8),
    and their per-tensor gradients agree to 1e-6 of the distances these
    bars are made of, which saves this file a third compile of JAX's
    step."""
    batch = _batch()
    with np.load(WEIGHTS) as z:
        npz = {k: np.asarray(z[k], np.float32) for k in z.files}
    mixed = _jax_step(npz, batch, True)
    default = _jax_step(npz, batch, True, excess=True)[0]
    runs = []
    for policy in (True, False):
        model = RAFT(RAFTConfig(mixed_precision=policy))
        model.load_state_dict(load_npz(WEIGHTS))
        tcfg = TrainConfig(**KW)
        state = create_train_state(model, tcfg)
        metrics = make_train_step(tcfg)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        runs.append((metrics, state))
    (metrics, state), (fm, fstate) = runs
    model = fstate.model
    f32 = (fm, {n: p.grad for n, p in model.named_parameters()},
           {n: t for n, t in model.state_dict().items() if "running" in n})
    return mixed, f32, default, metrics, state


def test_mixed_train_step_metrics_match_jax(mixed_steps):
    """The loss, EPE and pre-clip gradient norm of the port's mixed step
    moved from the float32 step by at most twice as far as JAX's mixed
    steps moved (its two compiles' losses lie 2e-5 and 2.2e-4 from the
    float32 loss), and within that of JAX's mixed step; the pixel shares,
    counted in pixels of the valid mask, within twice JAX's distance or
    one pixel; neither step skipped, the clip active."""
    (jm, _, _), (jf, _, _), jd, metrics, state = mixed_steps
    assert state.step == 1 and metrics["skipped_steps"] == 0.0
    assert jm["skipped_steps"] == 0.0 and metrics["grad_norm"] > 1.0
    for k in ("loss", "epe", "grad_norm"):
        bar = 2 * max(abs(jm[k] - jf[k]), abs(jd[k] - jf[k]))
        assert 0 < bar and abs(metrics[k] - jf[k]) <= bar, (k, metrics[k],
                                                            jf[k], bar)
        assert abs(metrics[k] - jm[k]) <= bar, (k, metrics[k], jm[k], bar)
    valid = float(_batch()["valid"].sum())
    for k in ("1px", "3px", "5px"):
        port, mixed, f32 = (round(m[k] * valid) for m in (metrics, jm, jf))
        assert abs(port - mixed) <= max(2 * abs(mixed - f32), 1), (k, port,
                                                                   mixed, f32)


def test_mixed_train_step_gradients_match_jax(mixed_steps):
    """Every parameter's clipped gradient within twice the distance
    between JAX's mixed and the float32 gradient of that tensor; the
    biases a norm cancels at most twice the larger of those two gradients
    of them. The batch-norm running statistics after the step within twice
    JAX's distance too."""
    (_, jgrads, jstats), (_, fgrads, fstats), _, _, state = mixed_steps
    for name, prm in state.model.named_parameters():
        got, want, f32 = prm.grad, jgrads[name], fgrads[name]
        if _cancelled_by_norm(name):
            bar = 2 * max(float(np.abs(_np(want)).max()),
                          float(np.abs(_np(f32)).max()))
        else:
            bar = 2 * _dist(want, f32)
        assert _dist(got, want) <= bar, (name, _dist(got, want), bar)
    for name, want in jstats.items():
        got = state.model.state_dict()[name]
        bar = 2 * _dist(want, fstats[name])
        assert _dist(got, want) <= bar, (name, _dist(got, want), bar)


@pytest.mark.parametrize("levers", [
    dict(mixed_precision=True),
    dict(mixed_precision=True, alternate_corr=True),
    dict(alternate_corr=True, corr_mxu_dtype="bfloat16"),
    dict(mixed_precision=True, alternate_corr=True,
         corr_mxu_dtype="bfloat16"),
    dict(mixed_precision=True, corr_dtype="bfloat16")],
    ids=["mixed", "mixed-alternate", "mxu-bf16", "mixed-mxu-bf16",
         "mixed-storage-bf16"])
def test_every_parameter_gets_a_finite_gradient(levers):
    """Under each lever of the policy, on each engine it takes, a training
    forward's loss gives every parameter a finite gradient, the encoders'
    too (their bfloat16 weights are cast in the autograd graph), and the
    flows come back float32."""
    batch = _batch()
    model = RAFT(RAFTConfig(**levers))
    model.load_state_dict(load_npz(WEIGHTS))
    preds = model(_t(batch["image1"][:, :32, :48]),
                  _t(batch["image2"][:, :32, :48]), iters=1, train=True)
    assert preds.dtype == torch.float32
    preds.abs().mean().backward()
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    assert not missing, missing
    assert float(model.fnet.conv1.weight.grad.abs().max()) > 0


def test_train_runs_the_policy_and_refuses_what_is_not_ported():
    """``train()`` under ``mixed_precision=True`` (on both
    ``update_impl``s) and the explicit bf16 levers takes its steps on the
    CPU (no step skipped, every parameter moved), and the bf16 weight casts
    of inference are not served to a training forward; the chain's
    training forward under the policy gives the step's predictions (both
    are the same plain versions on the CPU). What stays unported refuses
    with ``NotImplementedError``: RAFT-small training, under the policy
    too, and the sparse family's bf16."""
    batches = [{k: v[:, :32, :48] for k, v in _batch().items()}] * 2
    logged = []

    class Logger:
        def push(self, metrics, lr):
            logged.append(metrics)

    for cfg, impl in (
            (RAFTConfig(mixed_precision=True), "step"),
            (RAFTConfig(mixed_precision=True), "chain"),
            (RAFTConfig(alternate_corr=True, corr_mxu_dtype="bfloat16"),
             "step"),
            (RAFTConfig(corr_dtype="bfloat16"), "step")):
        logged.clear()
        state = train(TrainConfig(num_steps=2, iters=2, batch_size=1,
                                  image_size=(32, 48)), cfg,
                      dataloader=batches, restore_ckpt=WEIGHTS,
                      device="cpu", logger=Logger(), update_impl=impl)
        assert state.step == 2 and len(logged) == 2
        assert not any(m["skipped_steps"] for m in logged)
        assert all(np.isfinite(m["loss"]) for m in logged)
        start = load_npz(WEIGHTS)
        assert all(not torch.equal(p.detach(), start[n])
                   for n, p in state.model.named_parameters())
    for cfg in (RAFTConfig(small=True, mixed_precision=True),
                RAFTConfig(small=True)):
        with pytest.raises(NotImplementedError, match="RAFT-small"):
            train(TrainConfig(num_steps=1), cfg, dataloader=[], device="cpu")
    model = RAFT(RAFTConfig(mixed_precision=True))
    model.load_state_dict(load_npz(WEIGHTS))
    step, chain = (model(_t(batches[0]["image1"]), _t(batches[0]["image2"]),
                         iters=1, train=True, update_impl=impl)
                   for impl in ("step", "chain"))
    assert chain.dtype == torch.float32 and torch.equal(chain, step)
    with pytest.raises(NotImplementedError, match="bf16"):
        train(TrainConfig(model_family="sparse", num_steps=1),
              OursConfig(mixed_precision=True), dataloader=[], device="cpu")


# -- the card ----------------------------------------------------------------

CARD_SHAPES = [(8, 46, 62, 256, 4), (1, 55, 128, 256, 4), (1, 55, 128, 128, 3)]
CARD_COMBOS = [("bfloat16", "float32"), ("bfloat16", "bfloat16"),
               ("float32", "bfloat16")]


# the float32 sums' bars (largest difference, 2-norm, of the plain
# version's): chip_smoke.py's CORR_BWD_BF16_BARS
CARD_SUM_BARS = {("bfloat16", "float32"): (1e-4, 1e-5),
                 ("bfloat16", "bfloat16"): (4e-3, 1e-4),
                 ("float32", "bfloat16"): (4e-3, 1e-4)}


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0, 10 ** 8])
@pytest.mark.parametrize("maps,mxu", CARD_COMBOS)
@pytest.mark.parametrize("b,h,w,c,r", CARD_SHAPES)
def test_bf16_corr_bwd_kernel_matches_plain_on_card(cuda, b, h, w, c, r, maps,
                                                    mxu, budget, monkeypatch):
    """The bf16 corr backward against its plain version (4 levels) at the
    chairs and Sintel shapes and RAFT-small's r=3, C=128, each path forced
    (budget 0: the warp path; 10**8: the shared tile), with a bfloat16
    cotangent: df1 and each df2 in bfloat16 within one ``EPS`` of
    max|plain|; the float32 sums (float32 gradients, the plain version on
    float32 copies of the maps) within ``CARD_SUM_BARS`` (largest
    difference, 2-norm), and the plain version at the other ``mxu_dtype``
    further off than the 2-norm bar (chip_smoke.py's CORR_BWD_BF16_BARS,
    which says where they come from)."""
    monkeypatch.setattr(corr_cuda, "TILE_BUDGET", budget)
    rng = np.random.default_rng(c + r + b)
    tdt = getattr(torch, maps)
    f1 = _t(rng.standard_normal((b, h, w, c))).to(cuda, tdt)
    pyr = corr.build_feature_pyramid(
        _t(rng.standard_normal((b, h, w, c))).to(cuda, tdt), 4)
    flow = rng.uniform(-4, 4, (b, 1, 1, 2)) + rng.uniform(-1, 1, (b, h, w, 2))
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]
    coords = _t(grid + flow).to(cuda).contiguous()
    g = _t(rng.standard_normal((b, h, w, 4 * (2 * r + 1) ** 2))).to(cuda, BF16)
    before = corr_cuda.bwd_bf16_launches
    got = corr_cuda.windowed_correlation_bwd_bf16_cuda(f1, pyr, coords, g, r,
                                                       mxu_dtype=mxu)
    got32 = corr_cuda.windowed_correlation_bwd_bf16_cuda(
        f1, pyr, coords, g, r, mxu_dtype=mxu, out_dtype=torch.float32)
    want = corr_cuda.windowed_correlation_bwd_plain(f1, pyr, coords, g, r,
                                                    mxu_dtype=mxu)
    f1f, pyrf = f1.float(), [p.float() for p in pyr]
    want32, ctrl32 = (corr_cuda.windowed_correlation_bwd_plain(
        f1f, pyrf, coords, g, r, mxu_dtype=m)
        for m in (mxu, "float32" if mxu == "bfloat16" else "bfloat16"))
    assert corr_cuda.bwd_bf16_launches == before + 2
    largest, norm = CARD_SUM_BARS[(maps, mxu)]
    for a, b_ in zip((got[0], *got[1]), (want[0], *want[1])):
        assert a.dtype == b_.dtype == tdt
        bar = (EPS if maps == "bfloat16" else largest) * float(
            b_.float().abs().max())
        assert float((a.float() - b_.float()).abs().max()) <= bar
    for a, b_, z in zip((got32[0], *got32[1]), (want32[0], *want32[1]),
                        (ctrl32[0], *ctrl32[1])):
        assert a.dtype == torch.float32
        assert float((a - b_).abs().max() / b_.abs().max()) <= largest
        assert float((a - b_).norm() / b_.norm()) <= norm
        assert float((z - b_).norm() / b_.norm()) > norm


@pytest.mark.cuda
def test_mixed_train_step_through_the_kernels_on_card(cuda, monkeypatch):
    """One mixed train step (B=1, 128x160, iters=2, the on-demand engine)
    through the bf16 kernels (corr_fwd_bf16, corr_bwd_bf16, the bf16 step
    and its recompute) against the same step with the lookup and the step
    swapped for their plain versions: the loss within 8 ``EPS`` relative,
    every gradient finite, the kernels launched once an iteration."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(2)
    img1 = rng.uniform(0, 255, (1, 128, 160, 3)).astype(np.float32)
    batch = {"image1": _t(img1).to(cuda),
             "image2": _t(np.roll(img1, (2, -3), (1, 2))).to(cuda),
             "flow": torch.zeros(1, 128, 160, 2, device=cuda),
             "valid": torch.ones(1, 128, 160, device=cuda)}
    tcfg = TrainConfig(batch_size=1, image_size=(128, 160), iters=2,
                       num_steps=10)

    def step():
        model = RAFT(RAFTConfig(mixed_precision=True))
        model.load_state_dict(load_npz(WEIGHTS))
        state = create_train_state(model.to(cuda), tcfg)
        out = make_train_step(tcfg, alternate_corr=True)(state, batch)
        assert all(bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())
        return out

    counts = (corr_cuda.bf16_launches, corr_cuda.bwd_bf16_launches,
              step_cuda.bf16_launches, corr_cuda.bwd_launches)
    got = step()
    assert (corr_cuda.bf16_launches - counts[0],
            corr_cuda.bwd_bf16_launches - counts[1],
            step_cuda.bf16_launches - counts[2],
            corr_cuda.bwd_launches - counts[3]) == (2, 2, 2, 0)
    monkeypatch.setattr(
        corr_cuda, "windowed_correlation_bf16",
        lambda f1, pyr, c, r, scale=True, rescale=True, out_dtype=None,
        mxu_dtype="bfloat16": corr_cuda.windowed_correlation_fused_plain(
            f1, pyr, c, r, scale, rescale, mxu_dtype, out_dtype))
    monkeypatch.setattr(
        step_cuda, "fused_step",
        lambda net, inp, cr, flow, convs, packed:
        step_cuda.fused_step_plain(net, inp, cr, flow, convs))
    want = step()
    assert got["skipped_steps"] == want["skipped_steps"] == 0.0
    assert abs(got["loss"] - want["loss"]) <= 8 * EPS * abs(want["loss"])
