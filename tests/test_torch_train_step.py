"""One whole train step of the port against the JAX package's, on the CPU.

RAFT-large at its full widths from the fixture weights
(``assets/golden/weights.npz``), B=1 at 64x64, iters=2, chairs defaults
(batch norm trains, one-cycle schedule, clipping at 1.0): the same numpy
batch through ``raft_tpu.parallel.make_train_step(donate=False)`` and
through ``raft_tpu_torch.parallel.train_step.make_train_step``, both on the
materialised correlation pyramid (the CPU's engine in both packages). The
JAX step is compiled at a low XLA optimisation level, which changes its
compile time and not its arithmetic beyond float rounding, on a state that
carries the parameters and the batch statistics as one flat vector each
(``sparse_fixture.flat_train_state``): the same step, which XLA on the CPU
compiles in a fifth of the time it takes with the optimizer and the guard
spread over RAFT's 124 leaves.
"""

import os
import re

import numpy as np
import pytest
import torch

import sparse_fixture as fixture
from raft_tpu_torch.config import TrainConfig
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.parallel.train_step import (create_train_state,
                                                make_train_step)
from raft_tpu_torch.weights import load_npz, state_dict_from_flax

import jax
import jax.numpy as jnp

from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.models.raft import RAFT as JaxRAFT
from raft_tpu.optim import fetch_optimizer as jax_fetch_optimizer
from raft_tpu.parallel.train_step import make_train_step as jax_train_step
from raft_tpu.utils.torch_convert import convert_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "assets", "golden", "weights.npz")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads per xdist worker (see tests/test_torch_raft.py),
    restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both_steps():
    """The JAX and the port's state after one step on one batch, and the
    two steps' metrics."""
    rng = np.random.default_rng(11)
    img1 = rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    batch = {"image1": img1,
             "image2": np.roll(img1, (1, -2), axis=(1, 2)),
             "flow": (2.0 * rng.standard_normal((1, 64, 64, 2))).astype(
                 np.float32),
             "valid": (rng.uniform(size=(1, 64, 64)) > 0.2).astype(
                 np.float32)}
    kw = dict(batch_size=1, image_size=(64, 64), num_steps=100, iters=2)
    with np.load(WEIGHTS) as z:
        npz = {k: np.asarray(z[k], np.float32) for k in z.files}

    jstate, unflatten = fixture.flat_train_state(
        JaxRAFT(JaxRAFTConfig(iters=2)), convert_state_dict(npz),
        jax_fetch_optimizer(JaxTrainConfig(**kw)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    jstep = jax_train_step(JaxTrainConfig(**kw), donate=False).lower(
        jstate, jbatch, key).compile(compiler_options=fixture.FAST_COMPILE)
    jstate, jmetrics = jstep(jstate, jbatch, key)
    want = state_dict_from_flax(unflatten(jstate))

    model = RAFT()
    model.load_state_dict(load_npz(WEIGHTS))
    tcfg = TrainConfig(**kw)
    state = create_train_state(model, tcfg)
    metrics = make_train_step(tcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return ({k: float(v) for k, v in jmetrics.items()}, want, metrics,
            state)


def test_train_step_metrics_match_jax(both_steps):
    """Loss and its metrics to 1e-5 relative, the pre-clip gradient norm to
    1e-4 relative (float32 through 50 layers and the backward, summed in
    other orders); neither step skipped."""
    jmetrics, _, metrics, state = both_steps
    assert state.step == 1 and metrics["skipped_steps"] == 0.0
    assert jmetrics["skipped_steps"] == 0.0
    for k in ("loss", "epe", "1px", "3px", "5px"):
        assert metrics[k] == pytest.approx(jmetrics[k], rel=1e-5, abs=1e-6), k
    assert metrics["grad_norm"] > 1.0        # the clip is active
    assert metrics["grad_norm"] == pytest.approx(jmetrics["grad_norm"],
                                                 rel=1e-4)


def _cancelled_by_norm(name: str) -> bool:
    """The encoders' conv biases but the final projection's feed a norm
    (fnet's instance norms, cnet's batch norms on batch statistics), which
    subtracts them again: their gradient is 0 up to rounding."""
    return re.fullmatch(r"[fc]net\.(conv1|layer\d\.\d\.(conv\d|downsample"
                        r"\.0))\.bias", name) is not None


def test_train_step_updates_match_jax(both_steps):
    """Every parameter after one clipped AdamW update at the one-cycle
    start rate (lr = 4e-4 / 25) to 2e-6, and the batch-norm running
    statistics to 1e-5. Adam's first update is lr * g / (|g| + 1e-8), so
    where a gradient entry is within a few 1e-8 of zero, its float32
    rounding (about 1e-9 here) moves the update by up to a tenth of lr; the
    bar is an eighth of lr. The conv biases in front of the encoders' norms
    have a gradient that is rounding noise on both sides
    (``_cancelled_by_norm``); Adam moves them by at most lr, their bar."""
    _, want, _, state = both_steps
    got = state.model.state_dict()
    lr = 4e-4 / 25
    for name, b in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        a = got[name]
        bar = 1e-5 if "running" in name else lr / 8
        if _cancelled_by_norm(name):
            bar = lr
        diff = float((a - b).abs().max())
        assert diff <= bar, (name, diff)
    start = load_npz(WEIGHTS)
    moved = [n for n, p in state.model.named_parameters()
             if not torch.equal(p.detach(), start[n])]
    assert len(moved) == len(list(state.model.parameters()))
    assert int(got["cnet.norm1.num_batches_tracked"]) == 1
