"""JAX's RAFT-small train step under the bf16 policy, committed for the
port's tests.

``tests/test_torch_small_train.py`` holds the port's mixed-precision
RAFT-small train step to the JAX package's. JAX's side is computed here,
once, and stored in ``assets/golden/small_train_jax.npz``:

- ``batch.<key>``: the batch both packages train on (B=1, 64x96, seeded
  numpy; the file's float32 step runs on it live against JAX too);
- ``metrics.mixed``: the loss, EPE, 1px, 3px, 5px and pre-clip gradient
  norm of JAX's ``make_train_step`` on ``weights_small.npz`` with
  ``RAFTConfig(small=True, mixed_precision=True)`` at iters=2, compiled to
  round at every bfloat16 operation as the policy does on a TPU (XLA's
  excess precision off);
- ``metrics.default``: the same step as XLA on the CPU compiles it by
  default, with its excess precision;
- ``grads.<name>``: the first step's clipped gradient of each parameter
  (torch names), read from AdamW's first moment, (1 - b1) times it;
- ``draw<d>.image1``, ``draw<d>.metrics.mixed``, ``draw<d>.metrics.f32``
  and ``draw<d>.grads.<name>`` for d in 1..``NOISY``: the same batch with
  its first frame perturbed by 1e-3 Gaussian noise (seed d - 1), and
  JAX's rounding step's metrics and gradients on it, beside its float32
  step's metrics. A bfloat16 result's distance from the float32 one is a
  draw of rounding noise, so the tests hold the port's mixed step against
  JAX's on each draw: its loss, EPE, gradient norm and gradients to that
  draw's bar, its pixel shares to the largest over the draws (JAX's step
  can move no pixel across a threshold on one draw).

RAFT-small has no batch norm, so there are no statistics to store. Run it
again after a change to those inputs (two minutes of CPU):

    JAX_PLATFORMS=cpu python scripts/small_train_reference.py

``--readings`` writes nothing: it runs the port's step (two torch threads,
as the tests) on each committed draw and engine, in float32 and under the
policy, and prints what the tests compare, each draw's bar being twice
JAX's distance from the port's float32 step: the largest port-vs-JAX
distance over its bar among the gradients (the biases an instance norm
cancels left out), one named gradient's three distances, and the pixels
that JAX's and the port's mixed steps move across each threshold.

    python scripts/small_train_reference.py --readings
"""

import os
import sys
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "assets", "golden", "weights_small.npz")
OUT = os.path.join(REPO, "assets", "golden", "small_train_jax.npz")
KW = dict(batch_size=1, image_size=(64, 96), num_steps=100, iters=2)
METRICS = ("loss", "epe", "1px", "3px", "5px", "grad_norm")
NOISY = 2           # perturbed draws of the batch


def make_batch() -> dict:
    """A seeded pair (the second frame the first moved by (1, -2) px), a
    random flow and a valid mask with a fifth of its pixels off."""
    rng = np.random.default_rng(11)
    h, w = KW["image_size"]
    img1 = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
    return {"image1": img1,
            "image2": np.roll(img1, (1, -2), axis=(1, 2)),
            "flow": (2.0 * rng.standard_normal((1, h, w, 2))).astype(
                np.float32),
            "valid": (rng.uniform(size=(1, h, w)) > 0.2).astype(np.float32)}


def jax_step(batch: dict, mixed: bool, excess: bool):
    """JAX's RAFT-small train step on the fixture weights: (metrics, the
    clipped gradient with torch names). ``excess``: XLA's excess precision
    (keeping bfloat16 intermediates in float32) on."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import sparse_fixture as fixture
    from raft_tpu.config import RAFTConfig
    from raft_tpu.config import TrainConfig
    from raft_tpu.models.raft import RAFT
    from raft_tpu.optim import fetch_optimizer
    from raft_tpu.parallel.train_step import make_train_step
    from raft_tpu.utils.torch_convert import convert_state_dict
    from raft_tpu_torch.weights import state_dict_from_flax

    with np.load(WEIGHTS) as z:
        npz = {k: np.asarray(z[k], np.float32) for k in z.files}
    state, unflatten = fixture.flat_train_state(
        RAFT(RAFTConfig(small=True, iters=KW["iters"],
                        mixed_precision=mixed)),
        convert_state_dict(npz), fetch_optimizer(TrainConfig(**KW)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    args = (state, jbatch, key)
    step = jax.jit(make_train_step(TrainConfig(**KW), donate=False))
    state, metrics = step.lower(*args).compile(compiler_options={
        **fixture.FAST_COMPILE,
        "xla_allow_excess_precision": excess})(*args)
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu"))
    grads = state_dict_from_flax(unflatten(SimpleNamespace(
        params={"flat": adam.mu["flat"] / 0.1},
        batch_stats=state.batch_stats)))
    return {k: float(v) for k, v in metrics.items()}, grads


def main():
    batch = make_batch()
    out = {f"batch.{k}": v for k, v in batch.items()}
    for name, excess in (("default", True), ("mixed", False)):
        metrics, grads = jax_step(batch, True, excess)
        out[f"metrics.{name}"] = np.array([metrics[k] for k in METRICS],
                                          np.float64)
        print(name, {k: metrics[k] for k in METRICS})
    out.update({f"grads.{k}": v.numpy().astype(np.float32)
                for k, v in grads.items()})
    for d in range(1, NOISY + 1):
        noise = np.random.default_rng(d - 1).standard_normal(
            batch["image1"].shape)
        noisy = dict(batch, image1=(batch["image1"] + 1e-3 * noise).astype(
            np.float32))
        out[f"draw{d}.image1"] = noisy["image1"]
        for name, policy in (("f32", False), ("mixed", True)):
            metrics, draw_grads = jax_step(noisy, policy, False)
            out[f"draw{d}.metrics.{name}"] = np.array(
                [metrics[k] for k in METRICS], np.float64)
            print(f"draw {d} {name}", {k: metrics[k] for k in METRICS})
        out.update({f"draw{d}.grads.{k}": v.numpy().astype(np.float32)
                    for k, v in draw_grads.items()})
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(grads)} gradients")


def readings(name: str = "fnet.layer1.1.conv3.weight"):
    """Print the per-draw readings the tests hold (see the docstring)."""
    import re

    import torch

    sys.path.insert(0, REPO)
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.models.raft import RAFT
    from raft_tpu_torch.parallel.train_step import (create_train_state,
                                                    make_train_step)
    from raft_tpu_torch.weights import load_npz

    torch.set_num_threads(2)
    cancelled = re.compile(r"fnet\.(conv1|layer\d\.\d\.(conv\d|downsample"
                           r"\.0))\.bias")

    def dist(a, b):
        return float((a.float() - b.float()).abs().max())

    z = np.load(OUT)
    batch = {k[6:]: z[k] for k in z.files if k.startswith("batch.")}
    draws = [(batch, "")] + [(dict(batch, image1=z[f"draw{d}.image1"]),
                              f"draw{d}.") for d in range(1, NOISY + 1)]
    valid = float(batch["valid"].sum())
    for engine in ("pyramid", "alternate"):
        for d, (b, pre) in enumerate(draws):
            tb = {k: torch.from_numpy(v) for k, v in b.items()}
            out = {}
            for mixed in (False, True):
                model = RAFT(RAFTConfig(small=True, mixed_precision=mixed,
                                        alternate_corr=engine == "alternate"))
                model.load_state_dict(load_npz(WEIGHTS))
                tcfg = TrainConfig(**KW)
                metrics = make_train_step(tcfg)(
                    create_train_state(model, tcfg), tb)
                out[mixed] = metrics, {n: p.grad for n, p
                                       in model.named_parameters()}
            jm = dict(zip(METRICS, z[pre + "metrics.mixed"]))
            ratios = []
            for n, g16 in out[True][1].items():
                jg = torch.from_numpy(z[pre + "grads." + n])
                if not cancelled.fullmatch(n):
                    ratios.append((dist(g16, jg)
                                   / (2 * dist(jg, out[False][1][n])), n))
            jg = torch.from_numpy(z[pre + "grads." + name])
            f32, g16 = out[False][1][name], out[True][1][name]
            moved = {k: (round(abs(jm[k] - out[False][0][k]) * valid),
                         round(abs(out[True][0][k] - out[False][0][k])
                               * valid),
                         round(abs(out[True][0][k] - jm[k]) * valid))
                     for k in ("1px", "3px", "5px")}
            print(f"{engine} draw {d}: largest port-vs-JAX over the bar "
                  f"{max(ratios)[0]:.3f} ({max(ratios)[1]}); {name}: JAX "
                  f"{dist(jg, f32):.3e}, port {dist(g16, f32):.3e}, port-vs-"
                  f"JAX {dist(g16, jg):.3e}; pixels moved (JAX, port, "
                  f"port-vs-JAX) {moved}")


if __name__ == "__main__":
    if "--readings" in sys.argv[1:]:
        readings()
    else:
        main()
