"""The port's training slice against the JAX package, on the CPU.

``raft_tpu_torch``'s ``TrainConfig``, ``losses``, ``optim`` (schedules,
clipping, AdamW), the flax-semantics batch norm, the train step's
non-finite guard, the packed-weight cache after an update, the ``train``
loop on an injected loader and its refusals, and the weights' round trip
through ``.npz``. The whole train step against ``raft_tpu``'s is in
``tests/test_torch_train_step.py``; gradients in ``tests/test_torch_grad.py``.
Shapes are small; tolerances are stated per test.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from raft_tpu_torch import losses, optim, train as train_mod
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.models.extractor import BatchNorm
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.models.update import BasicUpdateBlock
from raft_tpu_torch.ops import corr_cuda, gru_cuda, motion_cuda, step_cuda
from raft_tpu_torch.parallel.train_step import (add_noise,
                                                create_train_state,
                                                make_train_step)
from raft_tpu_torch.weights import load_npz, state_dict_to_npz

try:
    import jax
    import jax.numpy as jnp
    import optax

    from raft_tpu import losses as jlosses
    from raft_tpu import optim as joptim
    from raft_tpu.config import TrainConfig as JaxTrainConfig
    from raft_tpu.models.extractor import Norm as JaxNorm
except ModuleNotFoundError:
    # The card's machine has no JAX; only the ``cuda`` tests run there:
    #   python -m pytest --noconftest tests/test_torch_train.py -m cuda
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "assets", "golden", "weights.npz")
HW = (64, 64)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads per xdist worker (see tests/test_torch_raft.py),
    restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


class SyntheticLoader:
    """``n`` batches of one random frame and its copy shifted 2 px right,
    with the matching constant flow (as the JAX tests' loader)."""

    def __init__(self, n=2, batch_size=1, hw=HW, seed=0):
        self.rng = np.random.default_rng(seed)
        self.n, self.batch_size, self.hw = n, batch_size, hw

    def __iter__(self):
        shape = (self.batch_size, *self.hw)
        for _ in range(self.n):
            img1 = self.rng.uniform(0, 255, (*shape, 3)).astype(np.float32)
            flow = np.zeros((*shape, 2), np.float32)
            flow[..., 0] = 2.0
            yield {"image1": img1, "image2": np.roll(img1, 2, axis=2),
                   "flow": flow, "valid": np.ones(shape, np.float32)}


def test_train_config_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    assert ours == theirs
    assert (TrainConfig().batch_size, TrainConfig().image_size,
            TrainConfig().iters) == (8, (368, 496), 12)


@pytest.mark.parametrize("normalization", ["all", "valid"])
def test_sequence_loss_matches_jax(normalization):
    """Loss and final-iteration metrics to 1e-6 relative, with a sparse
    valid mask and ground truth beyond MAX_FLOW."""
    rng = np.random.default_rng(1)
    preds = rng.normal(size=(3, 2, 10, 12, 2)).astype(np.float32)
    gt = (5.0 * rng.normal(size=(2, 10, 12, 2))).astype(np.float32)
    gt[0, 0, 0] = 500.0
    valid = (rng.uniform(size=(2, 10, 12)) < 0.3).astype(np.float32)
    want, wmetrics = jlosses.sequence_loss(
        jnp.asarray(preds), jnp.asarray(gt), jnp.asarray(valid), gamma=0.8,
        normalization=normalization)
    got, metrics = losses.sequence_loss(_t(preds), _t(gt), _t(valid),
                                        gamma=0.8,
                                        normalization=normalization)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert set(metrics) == set(wmetrics)
    for k, v in wmetrics.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-6), k
    direct = losses.epe_metrics(_t(preds[-1]), _t(gt), _t(valid))
    jdirect = jlosses.epe_metrics(jnp.asarray(preds[-1]), jnp.asarray(gt),
                                  jnp.asarray(valid))
    for k, v in jdirect.items():
        assert float(direct[k]) == pytest.approx(float(v), rel=1e-6), k
    with pytest.raises(ValueError, match="normalization"):
        losses.sequence_loss(_t(preds), _t(gt), _t(valid),
                             normalization="mean")


STEPS = [0, 1, 4, 5, 6, 99, 100, 149, 150, 400, 999, 1000, 1099, 1100, 2500]


@pytest.mark.parametrize("make", [
    lambda m: m.onecycle_schedule(4e-4, 1100),
    lambda m: m.step_schedule(4e-4, 1000),
    lambda m: m.cosine_warmup_restarts_schedule(4e-4, 1000, warmup_steps=50),
    lambda m: m.cosine_warmup_restarts_schedule(
        4e-4, 300, cycle_mult=2.0, warmup_steps=20, gamma=0.5)])
def test_schedules_match_jax(make):
    """Every schedule at sampled steps (warm-up edges, boundaries, cycle
    restarts, past the end) to 1e-6 of the peak rate: JAX computes in
    float32, rounding at about 1e-7 of the peak per operation, the port in
    float64."""
    mine, jaxs = make(optim), make(joptim)
    for n in STEPS:
        assert mine(n) == pytest.approx(float(jaxs(n)), rel=0, abs=4e-10), n


@pytest.mark.parametrize("scheduler", ["onecycle", "step", "cosine_warmup"])
def test_optimizer_rate_follows_make_schedule(scheduler):
    """``fetch_optimizer``'s scheduler sets update n's rate to
    ``make_schedule(cfg)(n)``, from n = 0 (optax's count), for each
    scheduler; ``make_schedule`` picks the JAX package's schedule (bar as
    above)."""
    cfg = TrainConfig(num_steps=40, scheduler=scheduler)
    mine = optim.make_schedule(cfg)
    jaxs = joptim.make_schedule(JaxTrainConfig(num_steps=40,
                                               scheduler=scheduler))
    for n in (0, 2, 30):
        assert mine(n) == pytest.approx(float(jaxs(n)), rel=0, abs=4e-10), n
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = optim.fetch_optimizer(cfg, [p])
    for n in range(45):
        assert opt.param_groups[0]["lr"] == mine(n), n
        p.grad = torch.ones(3)
        opt.step()
        sched.step()
    with pytest.raises(ValueError, match="scheduler"):
        optim.make_schedule(TrainConfig(scheduler="cyclic"))


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_and_adamw_match_optax(scale):
    """Two clipped AdamW updates of a small random parameter set against
    the JAX package's ``fetch_optimizer`` (optax): the gradients' global
    norm below the clip (``scale=0.01``) and above it; parameters to 1e-6
    (float32 Adam arithmetic in other orders)."""
    rng = np.random.default_rng(2)
    shapes = {"a": (4, 3), "b": (3,), "c": (2, 2, 3, 3)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (scale * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    cfg = dict(lr=1e-2, num_steps=10, wdecay=1e-2)

    tx = joptim.fetch_optimizer(JaxTrainConfig(**cfg))

    @jax.jit
    def update(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        jp, state = update({k: jnp.asarray(v) for k, v in g.items()}, state,
                           jp)

    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt, sched = optim.fetch_optimizer(TrainConfig(**cfg), tp.values())
    for g in grads:
        for k, p in tp.items():
            p.grad = _t(g[k])
        norm = torch.nn.utils.get_total_norm([p.grad for p in tp.values()])
        want = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                           for v in g.values()))
        assert float(norm) == pytest.approx(want, rel=1e-6)
        optim.clip_by_global_norm([p.grad for p in tp.values()], 1.0, norm)
        opt.step()
        sched.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_batch_norm_train_mode_matches_flax():
    """One training forward of the port's batch norm at a 4x6 map against
    the JAX package's ``Norm('batch')`` (flax ``BatchNorm``, momentum
    0.9): the output to 1e-5 and the running mean and variance to 1e-6.
    Stock ``nn.BatchNorm2d`` updates the running variance with the
    unbiased variance, 48/47 of flax's here, which this bar rejects."""
    rng = np.random.default_rng(3)
    c = 8
    x = (2.0 + 3.0 * rng.normal(size=(2, 4, 6, c))).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c), rng.normal(size=c)
    mean, var = rng.normal(size=c), rng.uniform(0.5, 2.0, c)
    variables = {"params": {"n": {"scale": scale, "bias": bias}},
                 "batch_stats": {"n": {"mean": mean, "var": var}}}
    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                             variables)
    want, mutated = JaxNorm(norm_fn="batch").apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    stats = mutated["batch_stats"]["n"]

    def port(module):
        module.load_state_dict({
            "weight": _t(scale), "bias": _t(bias), "running_mean": _t(mean),
            "running_var": _t(var),
            "num_batches_tracked": torch.tensor(0)})
        return module

    bn = port(BatchNorm(c, eps=1e-5, momentum=0.1))
    got = bn(_t(x).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=0, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1

    stock = port(torch.nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)).train()
    stock(_t(x).permute(0, 3, 1, 2))
    assert not np.allclose(stock.running_var.numpy(),
                           np.asarray(stats["var"]), rtol=0, atol=1e-6)
    # eval mode (train=False) reads the running statistics
    bn2 = port(BatchNorm(c, eps=1e-5, momentum=0.1))
    ref = ((x - mean) / np.sqrt(var + 1e-5) * scale + bias).astype(
        np.float32)
    np.testing.assert_allclose(
        bn2(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy(),
        ref, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def weights():
    return load_npz(WEIGHTS)


def _model(weights, **cfg):
    model = RAFT(RAFTConfig(**cfg))
    model.load_state_dict(weights)
    return model


def _batch(seed=0, nan=False):
    batch = next(iter(SyntheticLoader(n=1, seed=seed)))
    if nan:
        batch["image1"][0, 0, 0, 0] = np.nan
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_nonfinite_guard_skips_the_update(weights, tmp_path):
    """After a finite step, a batch with a NaN pixel leaves parameters,
    optimizer moments, scheduler count and batch-norm buffers exactly as
    they were, reports skipped_steps = 1 and advances the step; the next
    finite step trains again. The state then survives a save to ``.npz``
    and a reload under the same keys, running statistics and
    ``num_batches_tracked`` included."""
    tcfg = TrainConfig(iters=1, num_steps=10)
    model = _model(weights)
    state = create_train_state(model, tcfg)
    step = make_train_step(tcfg)
    assert step(state, _batch(0))["skipped_steps"] == 0.0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = {i: {k: v.clone() for k, v in s.items()}
               for i, s in enumerate(state.optimizer.state.values())}
    lr = state.scheduler.get_last_lr()

    metrics = step(state, _batch(1, nan=True))
    assert metrics["skipped_steps"] == 1.0 and state.step == 2
    assert not np.isfinite(metrics["loss"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for i, s in enumerate(state.optimizer.state.values()):
        for k, v in s.items():
            assert torch.equal(v, moments[i][k]), (i, k)
    assert state.scheduler.get_last_lr() == lr

    assert step(state, _batch(2))["skipped_steps"] == 0.0
    assert state.step == 3
    assert int(model.cnet.norm1.num_batches_tracked) == 2
    assert not torch.equal(model.cnet.norm1.running_mean,
                           before["cnet.norm1.running_mean"])

    path = str(tmp_path / "trained.npz")
    state_dict_to_npz(model.state_dict(), path)
    again = _model(load_npz(path))
    for k, v in again.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    assert int(again.cnet.norm1.num_batches_tracked) == 2


def test_packed_weights_follow_an_optimizer_step():
    """The packed-weight cache of ``BasicUpdateBlock`` is keyed on the
    parameters' storage and version: reused while nothing changed, and
    repacked after AdamW updates the weights in place."""
    block = BasicUpdateBlock()
    packed = {m: getattr(block, m).packed_weights()
              for m in ("encoder", "gru", "flow_head")}
    assert all(getattr(block, m).packed_weights() is packed[m]
               for m in packed)
    opt, _ = optim.fetch_optimizer(TrainConfig(), block.parameters())
    for p in block.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    fresh = {"encoder": motion_cuda.pack_weights(block.encoder.convs()),
             "gru": gru_cuda.pack_weights(block.gru.convs()),
             "flow_head": step_cuda.pack_flow_head(block.flow_head.convs())}
    for m, want in fresh.items():
        got = getattr(block, m).packed_weights()
        assert got is not packed[m], m
        assert all(torch.equal(a, b) for a, b in zip(got, want)), m


def test_train_runs_num_steps_on_an_injected_loader(weights, monkeypatch):
    """``train`` on the CPU repeats a 2-batch loader to take 3 steps, from
    the fixture weights, pushing each step's metrics and rate to the
    logger; the rates follow the one-cycle schedule."""
    monkeypatch.setattr(train_mod, "load_npz", lambda path: weights)
    pushed = []

    class Logger:
        def push(self, metrics, lr):
            pushed.append((metrics, lr))

    tcfg = TrainConfig(num_steps=3, iters=1, batch_size=1, image_size=HW)
    state = train_mod.train(tcfg, RAFTConfig(), dataloader=SyntheticLoader(),
                            restore_ckpt=WEIGHTS, device="cpu",
                            logger=Logger())
    assert state.step == 3 and len(pushed) == 3
    sched = optim.make_schedule(tcfg)
    for n, (metrics, lr) in enumerate(pushed):
        assert lr == pytest.approx(sched(n))
        assert metrics["skipped_steps"] == 0.0
        assert np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    assert int(state.model.cnet.norm1.num_batches_tracked) == 3


def test_train_corr_engine_and_refusals(monkeypatch, tmp_path):
    """The engine ``train`` picks, and the parts of the JAX ``train`` that
    are not ported raising ``NotImplementedError`` rather than being
    ignored; ``dataloader=None`` builds the stage's pipeline, which over a
    directory without datasets yields nothing, and ``train`` says so;
    without a card and without ``device='cpu'`` it raises."""
    pick = train_mod.resolve_train_corr_engine
    cuda_dev, cpu = torch.device("cuda"), torch.device("cpu")
    assert pick(cuda_dev, "auto", RAFTConfig()) is True
    assert pick(cuda_dev, "auto", RAFTConfig(small=True)) is True
    assert pick(cpu, "auto", RAFTConfig()) is False
    assert pick(cpu, "auto", RAFTConfig(alternate_corr=True)) is True
    assert pick(cuda_dev, "fixed", RAFTConfig()) is False
    assert pick(cuda_dev, "auto", RAFTConfig(corr_dtype="bfloat16")) is False
    with pytest.raises(ValueError, match="corr_impl"):
        pick(cpu, "on", RAFTConfig())

    tcfg = TrainConfig(num_steps=1)
    loader = SyntheticLoader()
    with pytest.raises(ValueError, match="no batch"):
        train_mod.train(tcfg, dataloader=None, data_root=str(tmp_path),
                        loader="thread", device="cpu")
    for kw in ({"resume": True},
               {"validation": ["sintel"]}, {"ckpt_dir": "ckpt"},
               {"log_dir": "runs"}, {"spatial_shards": 2}):
        args = {"dataloader": loader, "device": "cpu", **kw}
        with pytest.raises(NotImplementedError):
            train_mod.train(tcfg, **args)
    for cfg in (TrainConfig(model_family="dual_query"),
                TrainConfig(async_checkpointing=True)):
        with pytest.raises(NotImplementedError):
            train_mod.train(cfg, dataloader=loader, device="cpu")
    with pytest.raises(NotImplementedError, match="dropout"):
        RAFT(RAFTConfig(dropout=0.1))
    with pytest.raises(ValueError, match="update_impl"):
        train_mod.train(tcfg, dataloader=loader, device="cpu",
                        update_impl="fused")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.train(tcfg, dataloader=loader)


def test_noise_augmentation_is_seeded_and_clamped():
    img = torch.full((1, 8, 8, 3), 250.0)
    a = add_noise(torch.Generator().manual_seed(5), img, img.clone())
    b = add_noise(torch.Generator().manual_seed(5), img, img.clone())
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], img)
    assert float(a[0].max()) <= 255.0 and float(a[0].min()) >= 0.0


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_train_step_kernels_match_plain_on_card(cuda, weights, monkeypatch):
    """One train step on the card through the kernels (on-demand corr,
    corr_fwd, corr_bwd, update_step 'mg') against the same step with every
    wrapper replaced by its plain version, from the same weights and batch
    (B=2, 128x160, iters=3, TF32 off): loss to 1e-5 and grad_norm to 1e-4
    relative, batch-norm statistics to 1e-5, and the parameters after the
    update to 1e-6 but for at most one entry in 1e4. Adam's first update is
    lr * g / (|g| + 1e-8), so where a gradient entry is within a few 1e-8
    of zero its rounding moves the update by up to 2 lr, the bound of every
    entry. chip_smoke.py holds the gradients themselves to the plain
    route's own spread."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    tcfg = TrainConfig(iters=3, num_steps=100)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in next(iter(
        SyntheticLoader(n=1, batch_size=2, hw=(128, 160)))).items()}

    def run():
        model = _model(weights).to(cuda)
        state = create_train_state(model, tcfg)
        metrics = make_train_step(tcfg, alternate_corr=True)(state, batch)
        return metrics, model.state_dict()

    counts = (corr_cuda.launches, corr_cuda.bwd_launches, step_cuda.launches)
    metrics, got = run()
    assert (corr_cuda.launches - counts[0], corr_cuda.bwd_launches - counts[1],
            step_cuda.launches - counts[2]) == (3, 3, 3)
    monkeypatch.setattr(corr_cuda, "windowed_correlation_fused",
                        corr_cuda.windowed_correlation_fused_plain)
    monkeypatch.setattr(
        step_cuda, "fused_step",
        lambda net, inp, cor, flo, convs, packed:
        step_cuda.fused_step_plain(net, inp, cor, flo, convs))
    want_metrics, want = run()
    assert metrics["loss"] == pytest.approx(want_metrics["loss"], rel=1e-5)
    assert metrics["grad_norm"] == pytest.approx(want_metrics["grad_norm"],
                                                 rel=1e-4)
    lr = optim.make_schedule(tcfg)(0)
    beyond, total = 0, 0
    for name, b in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        diff = (got[name] - b).abs()
        if "running" in name:
            assert float(diff.max()) <= 1e-5, name
            continue
        assert float(diff.max()) <= 2 * lr, name
        beyond += int((diff > 1e-6).sum())
        total += diff.numel()
    assert beyond <= total // 10_000, (beyond, total)
