"""RAFT's serving forward surface in the port against the JAX package, on
the CPU: early exit, the stream's encoder and precomputed feature maps,
the step-granular refine (``refine_init``, ``scatter_carry``,
``refine_chunk``, ``refine_finalize``) on both correlation engines, warm
start's ``forward_interpolate``, ``FlowPredictor``'s serving entry points
and the port's ``entry()``.

RAFT-large with ``assets/golden/weights.npz`` on three 64x96 crops of the
golden frames. JAX runs each engine's functions in one compile at a low
XLA optimisation level (``sparse_fixture.FAST_COMPILE``), once for this
file. The refine functions of the port start from JAX's own carry, so
each is held to JAX's alone. Bar: ``TOL`` of ``tests/test_torch_raft.py``
(1e-4); the early-exit state (``consec``, ``done``, ``used``,
``iters_used``) must be equal. The early exit's ``tol`` (0.038, patience
2) lies between these crops' update norms (0.0365-0.045 px) so that the
second sample exits after 3 iterations and the others run to the end.
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
from raft_tpu.models import raft as jraft
from raft_tpu.utils import warm_start as jwarm
from raft_tpu.utils.torch_convert import convert_state_dict
from raft_tpu_torch import evaluate
from raft_tpu_torch.config import OursConfig
from raft_tpu_torch.data import frame_utils
from raft_tpu_torch.entry import entry
from raft_tpu_torch.models.ours import SparseRAFT
from raft_tpu_torch.models.raft import RAFT, scatter_carry
from raft_tpu_torch.utils import warm_start
from raft_tpu_torch.weights import load_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "assets", "golden")
WEIGHTS = os.path.join(GOLDEN, "weights.npz")
TOL = 1e-4
EARLY_EXIT = (0.038, 2)
EE_ITERS = 6
FMAP_ITERS = 2
IDX = np.array([2, 0], np.int32)          # the admitted requests' slots
REMAINING = np.array([5, 2, 4], np.int32)
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads while this file runs: the suite's xdist workers
    share one CPU (as tests/test_torch_raft.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_tree(tree):
    """A JAX result (dicts, tuples, arrays) as the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_torch_tree(v) for v in tree)
    return _t(tree)


def _assert_tree_close(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_tree_close(got[k], want[k], f"{what}.{k}")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_tree_close(a, b, f"{what}[{i}]")
        return
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0,
                                   err_msg=what)


@pytest.fixture(scope="module")
def frames():
    """Three 64x96 crops, one from each golden pair, float32 in [0, 255],
    and a flow_init of 0, 1 and 2 times a seeded draw in +-2 px."""
    manifest = json.load(open(os.path.join(GOLDEN, "manifest.json")))
    root = os.path.join(REPO, "assets", "demo-frames")
    crops = [(64, 80), (32, 64), (96, 120)]
    pairs = [[np.asarray(frame_utils.read_gen(os.path.join(root, p[k])),
                         np.float32)[y:y + 64, x:x + 96]
              for k in ("frame1", "frame2")]
             for p, (y, x) in zip(manifest["pairs"], crops)]
    init = np.random.default_rng(4).uniform(-2, 2, (3, 8, 12, 2))
    init = (init * np.array([0.0, 1.0, 2.0])[:, None, None, None]).astype(
        np.float32)
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]),
            init)


@pytest.fixture(scope="module")
def port_model():
    model = RAFT()
    model.load_state_dict(load_npz(WEIGHTS))
    return model.eval()


def _chunks(alternate_corr):
    """The refine_chunk calls held against JAX: with early exit on both
    engines, without it on the all-pairs one (the masking code is the
    same; a second JAX chunk costs compile time)."""
    return ((("chunk_ee", EARLY_EXIT),) if alternate_corr
            else (("chunk_ee", EARLY_EXIT), ("chunk", None)))


@pytest.fixture(scope="module")
def jax_results(frames):
    """Per engine, one compile: the early-exit forward, encode_features,
    the forward from feature maps, refine_init of the slot table and of
    two admitted requests, scatter_carry, refine_chunk with and without
    early exit, refine_finalize. Every result as numpy."""
    img1, img2, init = frames
    with np.load(WEIGHTS) as z:
        variables = convert_state_dict(
            {k: np.asarray(z[k], np.float32) for k in z.files})
    cache = {}

    def run(alternate_corr):
        if alternate_corr in cache:
            return cache[alternate_corr]
        cfg = JaxRAFTConfig(alternate_corr=alternate_corr)
        model = jraft.RAFT(cfg)

        def program(v, a, b, flow_init):
            out = {}
            if not alternate_corr:
                out["early_exit"] = model.apply(
                    v, a, b, iters=EE_ITERS, flow_init=flow_init,
                    test_mode=True, early_exit=EARLY_EXIT)
                fm1 = model.apply(v, a, method=jraft.RAFT.encode_features)
                fm2 = model.apply(v, b, method=jraft.RAFT.encode_features)
                out["fmaps"] = (fm1, fm2)
                out["from_fmaps"] = model.apply(
                    v, a, None, iters=FMAP_ITERS, flow_init=flow_init,
                    fmap1=fm1, fmap2=fm2, test_mode=True)
            full = model.apply(v, a, b, flow_init=flow_init,
                               method=jraft.RAFT.refine_init)
            fresh = model.apply(v, b[:2], a[:2],
                                method=jraft.RAFT.refine_init)
            carry = jraft.scatter_carry(full, fresh, jnp.asarray(IDX), 3)
            out.update(full=full, fresh=fresh, carry=carry)
            for name, ee in _chunks(alternate_corr):
                out[name] = jraft.refine_chunk(
                    cfg, v, carry, jnp.asarray(REMAINING), STEPS, ee)
            out["finalize"] = jraft.refine_finalize(cfg, v,
                                                    out["chunk_ee"][0])
            return out

        args = (variables, img1, img2, init)
        out = jax.jit(program).lower(*args).compile(
            compiler_options=fixture.FAST_COMPILE)(*args)
        cache[alternate_corr] = jax.tree_util.tree_map(np.asarray, out)
        return cache[alternate_corr]
    return run


def test_early_exit_matches_jax(port_model, frames, jax_results):
    """The masked refine loop: flows within TOL, ``iters_used`` equal,
    and the samples exit at different iterations."""
    img1, img2, init = frames
    jlow, jup, jused = jax_results(False)["early_exit"]
    with torch.inference_mode():
        low, up, used = port_model(_t(img1), _t(img2), iters=EE_ITERS,
                                   flow_init=_t(init),
                                   early_exit=EARLY_EXIT)
    assert used.dtype == torch.int32
    np.testing.assert_array_equal(used.numpy(), jused)
    assert len(set(jused.tolist())) > 1, jused
    _assert_tree_close((low, up), (jlow, jup), "early exit")


def test_early_exit_is_test_mode_only(port_model, frames):
    img1, img2, _ = frames
    with pytest.raises(ValueError, match="test-mode"):
        port_model(_t(img1), _t(img2), iters=1, train=True,
                   early_exit=EARLY_EXIT)


def test_encode_features_and_fmaps_match_jax(port_model, frames,
                                             jax_results):
    """encode_features of each image, and the forward from those maps
    with no second image."""
    img1, img2, init = frames
    want = jax_results(False)
    with torch.inference_mode():
        fm1 = port_model.encode_features(_t(img1))
        fm2 = port_model.encode_features(_t(img2))
        _assert_tree_close((fm1, fm2), want["fmaps"], "fmaps")
        got = port_model(_t(img1), None, iters=FMAP_ITERS,
                         flow_init=_t(init), fmap1=fm1, fmap2=fm2)
    _assert_tree_close(got, want["from_fmaps"], "from fmaps")
    with pytest.raises(ValueError, match="together"):
        port_model(_t(img1), None, fmap1=fm1)


@pytest.mark.parametrize("alternate_corr", [False, True],
                         ids=["allpairs", "alternate"])
def test_refine_carry_functions_match_jax(port_model, frames, jax_results,
                                          alternate_corr):
    """refine_init (the slot table and two admissions), scatter_carry
    into slots IDX, refine_chunk (``_chunks``) and refine_finalize, each
    from JAX's own input carry. With early exit, slot 0 exits after 3
    iterations, slot 1 spends its budget of 2, slot 2 runs all 4."""
    img1, img2, init = frames
    want = jax_results(alternate_corr)
    with torch.inference_mode():
        full = port_model.refine_init(_t(img1), _t(img2), flow_init=_t(init),
                                      alternate_corr=alternate_corr)
        fresh = port_model.refine_init(_t(img2[:2]), _t(img1[:2]),
                                       alternate_corr=alternate_corr)
        _assert_tree_close(full, want["full"], "full")
        _assert_tree_close(fresh, want["fresh"], "fresh")
        jfull, jfresh = _torch_tree(want["full"]), _torch_tree(want["fresh"])
        carry = scatter_carry(jfull, jfresh, _t(IDX), 3)
        _assert_tree_close(carry, want["carry"], "scatter")
        jcarry = _torch_tree(want["carry"])
        for name, ee in _chunks(alternate_corr):
            got = port_model.refine_chunk(jcarry, _t(REMAINING), STEPS, ee)
            _assert_tree_close(got, want[name], name)
        got = port_model.refine_finalize(_torch_tree(want["chunk_ee"][0]))
    _assert_tree_close(got, want["finalize"], "finalize")
    # the input carry is not changed by scatter or chunk
    _assert_tree_close(jcarry, want["carry"], "carry after")


def test_forward_interpolate_matches_jax_package():
    rng = np.random.default_rng(6)
    flow = rng.uniform(-3, 3, (12, 20, 2)).astype(np.float32)
    flow[0, 0] = (-50, 0)                  # leaves the frame: a hole
    np.testing.assert_array_equal(warm_start.forward_interpolate(flow),
                                  jwarm.forward_interpolate(flow))
    gone = np.full((4, 5, 2), 100.0, np.float32)
    assert not warm_start.forward_interpolate(gone).any()


@pytest.fixture(scope="module")
def predictor(port_model):
    return evaluate.FlowPredictor(port_model, iters=3, device="cpu",
                                  warm_iters=2, early_exit=EARLY_EXIT)


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_predictor_flow_init_and_iters(predictor, port_model, frames):
    """__call__'s flow_init and dispatch_batch's iters= (with the
    predictor's early exit, a third tensor) are the model calls they
    wrap; dispatch_batch returns tensors, predict_batch numpy."""
    img1, img2, init = frames
    assert not predictor.alternate_corr
    with torch.inference_mode():
        want = port_model(_t(img1[:1]), _t(img2[:1]), iters=3,
                          flow_init=_t(init[:1]))
        want_ee = port_model(_t(img1), _t(img2), iters=EE_ITERS,
                             early_exit=EARLY_EXIT)
        want_plain = port_model(_t(img1), _t(img2), iters=3)
    _same(predictor(img1[0], img2[0], flow_init=init[0]),
          (w[0].numpy() for w in want))
    got = predictor.dispatch_batch(img1, img2, iters=EE_ITERS)
    assert len(got) == 3 and all(torch.is_tensor(g) for g in got)
    _same(got, want_ee)
    _same(predictor.dispatch_batch(img1, img2), want_plain)
    _same(predictor.predict_batch(img1, img2),
          (w.numpy() for w in want_plain))
    with pytest.raises(ValueError, match="iters"):
        predictor.dispatch_batch(img1, img2, iters=0)


def test_predictor_stream_entry_points(predictor, port_model, frames):
    """encode_dispatch and refine_dispatch are the model's encoder and
    its forward from maps; warm refines run warm_iters from flow_init."""
    img1, img2, init = frames
    fm1 = predictor.encode_dispatch(img1)
    fm2 = predictor.encode_dispatch(img2)
    with torch.inference_mode():
        assert torch.equal(fm1, port_model.encode_features(_t(img1)))
        warm = port_model(_t(img1), None, iters=2, flow_init=_t(init),
                          fmap1=fm1, fmap2=fm2)
        cold = port_model(_t(img1), None, iters=3, fmap1=fm1, fmap2=fm2)
        five = port_model(_t(img1), None, iters=5, flow_init=_t(init),
                          fmap1=fm1, fmap2=fm2)
    _same(predictor.refine_dispatch(img1, fm1, fm2, flow_init=init,
                                    warm=True), warm)
    _same(predictor.refine_dispatch(img1, fm1, fm2), cold)
    _same(predictor.refine_dispatch(img1, fm1, fm2, flow_init=init,
                                    warm=True, iters=5), five)
    for kwargs, match in (({"warm": True}, "requires flow_init"),
                          ({"flow_init": init}, "takes no flow_init"),
                          ({"iters": 2}, "warm refine only")):
        with pytest.raises(ValueError, match=match):
            predictor.refine_dispatch(img1, fm1, fm2, **kwargs)


def test_predictor_step_entry_points(predictor, port_model, frames):
    """step_carry, step_admit, step and step_finalize are the model's
    refine functions; a request admitted at iters=k and stepped in chunks
    until its budget is spent gets dispatch_batch(iters=k)'s flow."""
    img1, img2, _ = frames
    carry = predictor.step_carry_dispatch(img1, img2)
    carry = predictor.step_admit_dispatch(img2[:1], img1[:1], [1], carry)
    with torch.inference_mode():
        want = scatter_carry(port_model.refine_init(_t(img1), _t(img2)),
                             port_model.refine_init(_t(img2[:1]),
                                                    _t(img1[:1])),
                             torch.tensor([1]), 3)
    _assert_tree_close(carry, want, "admit")
    k = 5
    remaining = np.array([0, k - 1, 0])
    while remaining[1]:
        carry, rem = predictor.step_dispatch(carry, remaining, 3)
        remaining = rem.numpy()
    low, up = predictor.step_finalize_dispatch(carry)
    wlow, wup, wused = predictor.dispatch_batch(img2[:1], img1[:1], iters=k)
    _assert_tree_close((low[1:2], up[1:2]), (wlow, wup), "request")
    assert carry["used"].tolist() == [0, int(wused[0]) - 1, 0]
    with pytest.raises(ValueError, match="steps"):
        predictor.step_dispatch(carry, remaining, 0)


def test_sparse_predictor_refuses_the_raft_serving_paths(frames):
    cfg = OursConfig(**fixture.TINY)
    pred = evaluate.FlowPredictor(SparseRAFT(cfg), device="cpu")
    img1, img2, init = frames
    for call in (lambda: pred.encode_dispatch(img1),
                 lambda: pred.refine_dispatch(img1, img1, img1),
                 lambda: pred.step_carry_dispatch(img1, img2),
                 lambda: pred.step_finalize_dispatch({}),
                 lambda: pred.dispatch_batch(img1, img2, iters=2),
                 lambda: pred(img1[0], img2[0], flow_init=init[0])):
        with pytest.raises(ValueError, match="canonical RAFT"):
            call()


@pytest.mark.parametrize("kwargs, match", [
    ({"warm_iters": 0}, "warm_iters"),
    ({"early_exit": (0.0, 2)}, "tol"),
    ({"early_exit": (0.1, 0)}, "patience")])
def test_predictor_serving_arguments_are_validated(port_model, kwargs,
                                                   match):
    with pytest.raises(ValueError, match=match):
        evaluate.FlowPredictor(port_model, device="cpu", **kwargs)


def test_entry_runs_on_the_cpu():
    fn, args = entry(device="cpu")
    assert [tuple(a.shape) for a in args] == [(1, 96, 128, 3)] * 2
    flow_up = fn(*args)
    assert flow_up.shape == (1, 96, 128, 2)
    assert torch.isfinite(flow_up).all()
