#!/usr/bin/env python3
"""Loss trajectories of RAFT-large training in float32 and under the bf16
mixed-precision policy, in the JAX package and in its PyTorch port, on the
CPU.

Seven steps of the chairs defaults at a small size (B=2, 64x96, iters=4,
the one-cycle schedule, clipping, AdamW) from the fixture weights
(``assets/golden/weights.npz``), on the same seven batches (random frames
from a seed, the second the first moved by (-3, 2) px, that flow, all
valid): JAX's ``make_train_step`` (compiled at a low XLA optimisation
level, as the tests compile it) and the port's ``train(device="cpu")``,
each with ``mixed_precision`` off and on. It prints each run's losses and,
step by step, the relative gap of each policy to its package's float32
run and of the port to JAX. A few minutes of CPU.

    JAX_PLATFORMS=cpu python3 scripts/mixed_train_trajectory.py
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH, HW, ITERS = 7, 2, (64, 96), 4


def batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        img1 = rng.uniform(0, 255, (BATCH, *HW, 3)).astype(np.float32)
        flow = np.zeros((BATCH, *HW, 2), np.float32)
        flow[..., 0], flow[..., 1] = -3.0, 2.0
        out.append({"image1": img1,
                    "image2": np.roll(img1, (2, -3), axis=(1, 2)),
                    "flow": flow,
                    "valid": np.ones((BATCH, *HW), np.float32)})
    return out


def jax_losses(npz, data, mixed):
    import jax
    import jax.numpy as jnp

    import sparse_fixture as fixture
    from raft_tpu.config import RAFTConfig, TrainConfig
    from raft_tpu.models.raft import RAFT
    from raft_tpu.optim import fetch_optimizer
    from raft_tpu.parallel.train_step import make_train_step
    from raft_tpu.utils.torch_convert import convert_state_dict

    kw = dict(batch_size=BATCH, image_size=HW, num_steps=STEPS, iters=ITERS)
    state, _ = fixture.flat_train_state(
        RAFT(RAFTConfig(iters=ITERS, mixed_precision=mixed)),
        convert_state_dict(npz), fetch_optimizer(TrainConfig(**kw)))
    key = jax.random.PRNGKey(0)
    first = {k: jnp.asarray(v) for k, v in data[0].items()}
    step = make_train_step(TrainConfig(**kw), donate=False).lower(
        state, first, key).compile(compiler_options=fixture.FAST_COMPILE)
    losses = []
    for batch in data:
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, key)
        losses.append(float(metrics["loss"]))
    return np.array(losses)


def port_losses(weights, data, mixed):
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.train import train

    losses = []

    class Logger:
        def push(self, metrics, lr):
            losses.append(metrics["loss"])

    train(TrainConfig(num_steps=STEPS, iters=ITERS, batch_size=BATCH,
                      image_size=HW), RAFTConfig(mixed_precision=mixed),
          dataloader=data, restore_ckpt=weights, device="cpu",
          logger=Logger())
    return np.array(losses)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    weights = os.path.join(REPO, "assets", "golden", "weights.npz")
    with np.load(weights) as z:
        npz = {k: np.asarray(z[k], np.float32) for k in z.files}
    data = batches()
    runs = {}
    for mixed in (False, True):
        runs[("jax", mixed)] = jax_losses(npz, data, mixed)
        runs[("port", mixed)] = port_losses(weights, data, mixed)
    for (pkg, mixed), losses in runs.items():
        print(f"{pkg} {'mixed' if mixed else 'f32'}: "
              + ", ".join(f"{v:.4f}" for v in losses))

    def gap(a, b):
        return ", ".join(f"{v:.4f}" for v in np.abs(a - b) / np.abs(b))

    for pkg in ("jax", "port"):
        print(f"{pkg} mixed vs {pkg} f32, relative: "
              + gap(runs[(pkg, True)], runs[(pkg, False)]))
    for mixed in (False, True):
        print(f"port vs jax, {'mixed' if mixed else 'f32'}, relative: "
              + gap(runs[("port", mixed)], runs[("jax", mixed)]))


if __name__ == "__main__":
    main()
