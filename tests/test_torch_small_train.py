"""RAFT-small's train step in the port against the JAX package's, on the
CPU, and ``train()`` through the data pipeline.

One step of RAFT-small at its full widths from ``weights_small.npz``, B=1
at 64x96, iters=2, chairs defaults (one-cycle schedule, clipping at 1.0;
RAFT-small has no batch norm), on the batch committed in
``assets/golden/small_train_jax.npz``, on both of the port's correlation
engines: the materialised pyramid, and ``alternate_corr=True`` through the
plain windowed lookup (the corr kernels' plain versions), which computes
the same lookup.

* float32: live against ``raft_tpu.parallel.make_train_step`` (one JAX
  compile for the file, at a low XLA optimisation level, on a state that
  carries the parameters as one flat vector, ``sparse_fixture``), held to
  ``tests/test_torch_train_step.py``'s bars;
* under the bf16 policy: against JAX's mixed step as committed by
  ``scripts/small_train_reference.py`` (its metrics rounding at every
  bfloat16 operation and under XLA's default excess precision, and its
  clipped gradients), held to ``tests/test_torch_mixed_train.py``'s bars:
  within twice JAX's own distance between its bf16 and float32 results,
  the float32 side being the port's float32 step, which the first tests
  tie to JAX's. A bf16 result's distance from float32 is a draw of
  rounding noise, so the step runs on three draws, the batch and
  (``draw<d>.*``) two copies with 1e-3 noise on the first frame, each held
  against JAX's step on the same draw to that draw's bar. The pixel shares
  take the largest distance over the draws: JAX's mixed step moves no
  pixel across the 1 px and 5 px thresholds on the batch, 2-3 on the
  others.

Then ``train(..., dataloader=None)`` end to end on a synthetic FlyingChairs
tree, in float32 and under the policy.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_small_train.py -q
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparse_fixture as fixture
from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.models.raft import RAFT as JaxRAFT
from raft_tpu.optim import fetch_optimizer as jax_fetch_optimizer
from raft_tpu.parallel.train_step import make_train_step as jax_train_step
from raft_tpu.utils.torch_convert import convert_state_dict
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.data.synthetic import write_chairs
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.parallel.train_step import (create_train_state,
                                                make_train_step)
from raft_tpu_torch.train import train
from raft_tpu_torch.weights import load_npz, state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "assets", "golden", "weights_small.npz")
GOLDEN = os.path.join(REPO, "assets", "golden", "small_train_jax.npz")
KW = dict(batch_size=1, image_size=(64, 96), num_steps=100, iters=2)
METRICS = ("loss", "epe", "1px", "3px", "5px", "grad_norm")
LR = 4e-4 / 25                   # the one-cycle schedule's first rate
ENGINES = ["pyramid", "alternate"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads per xdist worker, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    """The committed batch and JAX's metrics under XLA's default excess
    precision on it; then per draw (the batch, and its noisy copies): the
    batch, JAX's mixed metrics, JAX's float32 metrics (None on the batch,
    where the float32 step runs live) and JAX's mixed clipped
    gradients."""
    def metrics(z, key):
        return dict(zip(METRICS, map(float, z[key]))) if key in z else None

    with np.load(GOLDEN) as z:
        batch = {k[6:]: z[k] for k in z.files if k.startswith("batch.")}
        draws = [(batch, metrics(z, "metrics.mixed"), None,
                  {k[6:]: torch.from_numpy(z[k]) for k in z.files
                   if k.startswith("grads.")})]
        d = 1
        while f"draw{d}.image1" in z.files:
            pre = f"draw{d}."
            draws.append((dict(batch, image1=z[pre + "image1"]),
                          metrics(z, pre + "metrics.mixed"),
                          metrics(z, pre + "metrics.f32"),
                          {k[len(pre) + 6:]: torch.from_numpy(z[k])
                           for k in z.files if k.startswith(pre + "grads.")}))
            d += 1
        return batch, metrics(z, "metrics.default"), draws


@pytest.fixture(scope="module")
def jax_f32(golden):
    """JAX's float32 step: (metrics, the state after it, torch names)."""
    batch = golden[0]
    with np.load(WEIGHTS) as z:
        npz = {k: np.asarray(z[k], np.float32) for k in z.files}
    state, unflatten = fixture.flat_train_state(
        JaxRAFT(JaxRAFTConfig(small=True, iters=KW["iters"])),
        convert_state_dict(npz), jax_fetch_optimizer(JaxTrainConfig(**KW)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    step = jax_train_step(JaxTrainConfig(**KW), donate=False).lower(
        state, jbatch, key).compile(compiler_options=fixture.FAST_COMPILE)
    state, metrics = step(state, jbatch, key)
    return ({k: float(v) for k, v in metrics.items()},
            state_dict_from_flax(unflatten(state)))


@pytest.fixture(scope="module")
def port_steps(golden):
    """The port's step from the fixture weights on each draw, per (engine,
    policy, draw): (metrics, the model after the step, whose ``p.grad``
    holds the clipped gradient the update used)."""
    out = {}
    for d, draw in enumerate(golden[2]):
        batch = {k: torch.from_numpy(v) for k, v in draw[0].items()}
        for engine in ENGINES:
            for mixed in (False, True):
                model = RAFT(RAFTConfig(small=True, mixed_precision=mixed,
                                        alternate_corr=engine == "alternate"))
                model.load_state_dict(load_npz(WEIGHTS))
                tcfg = TrainConfig(**KW)
                state = create_train_state(model, tcfg)
                metrics = make_train_step(tcfg)(state, batch)
                assert state.step == 1 and metrics["skipped_steps"] == 0.0
                out[engine, mixed, d] = metrics, model
    return out


def _cancelled_by_norm(name: str) -> bool:
    """fnet's conv biases but the final projection's feed an instance
    norm, which subtracts them again: their gradient is 0 up to rounding.
    RAFT-small's cnet has no norm."""
    return re.fullmatch(r"fnet\.(conv1|layer\d\.\d\.(conv\d|downsample\.0))"
                        r"\.bias", name) is not None


def _dist(a, b) -> float:
    return float((torch.as_tensor(a).float()
                  - torch.as_tensor(b).float()).abs().max())


@pytest.mark.parametrize("engine", ENGINES)
def test_f32_step_metrics_match_jax(jax_f32, port_steps, engine):
    """Loss and its metrics to 1e-5 relative, the pre-clip gradient norm
    to 1e-4 relative; the clip active."""
    jmetrics = jax_f32[0]
    metrics = port_steps[engine, False, 0][0]
    assert jmetrics["skipped_steps"] == 0.0
    for k in ("loss", "epe", "1px", "3px", "5px"):
        assert metrics[k] == pytest.approx(jmetrics[k], rel=1e-5, abs=1e-6), k
    assert metrics["grad_norm"] > 1.0
    assert metrics["grad_norm"] == pytest.approx(jmetrics["grad_norm"],
                                                 rel=1e-4)


@pytest.mark.parametrize("engine", ENGINES)
def test_f32_step_updates_match_jax(jax_f32, port_steps, engine):
    """Every parameter after one clipped AdamW update at the one-cycle
    start rate within lr/8 of JAX's (Adam's first update lr * g / (|g| +
    1e-8) turns rounding near a zero gradient into up to a tenth of lr);
    the biases an instance norm cancels within lr; every parameter
    moved."""
    want = jax_f32[1]
    model = port_steps[engine, False, 0][1]
    got = model.state_dict()
    for name, b in want.items():
        bar = LR if _cancelled_by_norm(name) else LR / 8
        assert _dist(got[name], b) <= bar, (name, _dist(got[name], b))
    start = load_npz(WEIGHTS)
    assert all(not torch.equal(p.detach(), start[n])
               for n, p in model.named_parameters())


@pytest.mark.parametrize("engine", ENGINES)
def test_mixed_step_metrics_match_jax(golden, port_steps, engine):
    """On each draw: the loss, EPE and pre-clip gradient norm of the port's
    mixed step moved from its float32 step by at most twice as far as
    JAX's mixed step moved from float32 on that draw (on the batch, either
    of its two compiles), and within that of JAX's rounding step; the pixel
    shares, in pixels of the valid mask, within twice the most that JAX's
    mixed step moved them on any draw, or one pixel; the clip active. On
    the noisy draws the port's float32 metrics match JAX's float32 step's
    (the batch's are held in the float32 tests)."""
    default, draws = golden[1], golden[2]
    assert len(draws) == 3
    valid = float(golden[0]["valid"].sum())
    jfs = [port_steps[engine, False, d][0] for d in range(len(draws))]
    moved = {k: max(abs(round(jm[k] * valid) - round(jf[k] * valid))
                    for (_, jm, _, _), jf in zip(draws, jfs))
             for k in ("1px", "3px", "5px")}
    for d, (_, jm, jax_f32, _) in enumerate(draws):
        metrics, jf = port_steps[engine, True, d][0], jfs[d]
        assert metrics["grad_norm"] > 1.0
        for k in ("loss", "epe", "grad_norm"):
            if jax_f32 is not None:
                rel = 1e-4 if k == "grad_norm" else 1e-5
                assert jf[k] == pytest.approx(jax_f32[k], rel=rel,
                                              abs=1e-6), (d, k)
            shift = abs(jm[k] - jf[k])
            if d == 0:
                shift = max(shift, abs(default[k] - jf[k]))
            bar = 2 * shift
            assert 0 < bar and abs(metrics[k] - jf[k]) <= bar, (
                d, k, metrics[k], jf[k], bar)
            assert abs(metrics[k] - jm[k]) <= bar, (d, k, metrics[k], jm[k],
                                                    bar)
        for k in ("1px", "3px", "5px"):
            port, mixed = (round(m[k] * valid) for m in (metrics, jm))
            assert abs(port - mixed) <= max(2 * moved[k], 1), (
                d, k, port, mixed, moved[k])


@pytest.mark.parametrize("engine", ENGINES)
def test_mixed_step_gradients_match_jax(golden, port_steps, engine):
    """On each draw, every parameter's clipped gradient within twice the
    distance between JAX's mixed gradient of that tensor on that draw and
    the port's float32 one; the biases an instance norm cancels at most
    twice the larger of the two gradients."""
    for d, (_, _, _, jgrads) in enumerate(golden[2]):
        model = port_steps[engine, True, d][1]
        f32 = dict(port_steps[engine, False, d][1].named_parameters())
        assert set(jgrads) == {n for n, _ in model.named_parameters()}
        for name, prm in model.named_parameters():
            got, want, ref = prm.grad, jgrads[name], f32[name].grad
            if _cancelled_by_norm(name):
                bar = 2 * max(float(want.abs().max()), float(ref.abs().max()))
            else:
                bar = 2 * _dist(want, ref)
            assert _dist(got, want) <= bar, (d, name, _dist(got, want), bar)


@pytest.fixture(scope="module")
def chairs_root(tmp_path_factory):
    """A synthetic FlyingChairs tree: 8 pairs at 96x128, 7 of them in the
    training split."""
    root = str(tmp_path_factory.mktemp("datasets"))
    write_chairs(root, 8, (96, 128), seed=0)
    return root


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
def test_train_builds_the_pipeline_and_trains_small(chairs_root, mixed):
    """``train(TrainConfig(stage="chairs"), RAFTConfig(small=True),
    dataloader=None, data_root=...)`` builds ``fetch_dataloader`` for the
    stage and trains 2 steps at a 32x48 crop: finite, none skipped, every
    parameter moved, the loader's substitutions (none) in the metrics."""
    logged = []

    class Logger:
        def push(self, metrics, lr):
            logged.append(metrics)

    state = train(TrainConfig(stage="chairs", num_steps=2, iters=2,
                              batch_size=2, image_size=(32, 48)),
                  RAFTConfig(small=True, mixed_precision=mixed),
                  dataloader=None, data_root=chairs_root,
                  restore_ckpt=WEIGHTS, device="cpu", logger=Logger(),
                  loader="thread", num_workers=2)
    assert state.step == 2 and len(logged) == 2
    assert all(np.isfinite(m["loss"]) and m["skipped_steps"] == 0.0
               and m["substituted_samples"] == 0.0 for m in logged)
    start = load_npz(WEIGHTS)
    assert all(not torch.equal(p.detach(), start[n])
               for n, p in state.model.named_parameters())
