"""The sparse family's tiny configuration in both packages, and its JAX-made
fixture for the card (``assets/golden/sparse_tiny.npz``).

JAX's ``SparseRAFT.init`` at the tiny configuration takes about a minute of
CPU op by op, so the variables are built from ``jax.eval_shape`` of the init
and filled from a numpy seed instead. Every value is a small integer times a
power of two, so float16 holds it exactly and the fixture stores the
weights in half the bytes while both packages compute on the same float32
numbers. Batch variances stay in [0.5, 1.5] (noise there gave NaN).

Write the fixture (a minute of CPU):

    JAX_PLATFORMS=cpu python tests/sparse_fixture.py
"""

from __future__ import annotations

import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "assets", "golden", "sparse_tiny.npz")
# the configuration __graft_entry__.py trains the sparse family at
TINY = dict(base_channel=16, d_model=32, num_feature_levels=2,
            outer_iterations=2, num_keypoints=4, n_heads=4, n_points=2,
            dropout=0.0)
HW = (64, 96)
WEIGHT_SEED, FRAME_SEED = 11, 12
_TABLES = ("row_pos_embed", "col_pos_embed", "lvl_pos_embed",
           "img_pos_embed")
# XLA options for the tests' compiles of JAX programs: a low optimisation
# level takes less compile time and gives the same float32 arithmetic up
# to rounding
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def frames(batch: int, seed: int = FRAME_SEED):
    """``batch`` seeded pairs (B, H, W, 3) in [0, 255], integer-valued
    float32: random frames, the second the first moved by (2, -3) px with
    noise. Pair i is the same whatever the batch."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(batch):
        img1 = rng.integers(0, 256, (*HW, 3))
        img2 = np.roll(img1, (-3, 2), axis=(0, 1))
        img2 = np.clip(img2 + rng.integers(-8, 9, img2.shape), 0, 255)
        pairs.append((img1, img2))
    return tuple(np.stack(side).astype(np.float32) for side in zip(*pairs))


def _fill(path, shape, rng):
    """One leaf: integers k times a power of two, by the leaf's role."""
    name = path[-1]

    def ints(lo, hi):
        return rng.integers(lo, hi + 1, shape).astype(np.float32)

    if name == "var":
        return ints(8, 24) / 16
    if name == "mean":
        return ints(-8, 8) / 32
    if name == "scale":
        return 1 + ints(-4, 4) / 16
    if name == "bias":
        return ints(-8, 8) / 64
    if name in _TABLES:
        return ints(-8, 8) / 4
    if name == "query_embed":
        fan_in = shape[0] + shape[1]
    elif len(shape) == 3 and path[-2] == "out":       # (heads, hd, out)
        fan_in = shape[0] * shape[1]
    else:                                   # (in, ...) or HWIO
        fan_in = int(np.prod(shape[:-1])) if len(shape) != 3 else shape[0]
    step = 2.0 ** (round(np.log2(1 / np.sqrt(fan_in))) - 3)
    return ints(-8, 8) * step


def fill_variables(shapes, seed: int = WEIGHT_SEED):
    """Numpy variables for a tree of shapes (``jax.eval_shape`` of the
    init), leaves filled in sorted path order from ``seed``."""
    import jax

    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    keyed = [(tuple(str(p.key) for p in path), leaf) for path, leaf in leaves]
    values = {}
    for path, leaf in sorted(keyed):
        values[path] = _fill(path, tuple(leaf.shape), rng)
    return jax.tree_util.tree_unflatten(
        treedef, [values[p] for p, _ in keyed])


def jax_model(encoder_iterations: int = 0, alternate_corr: bool = True):
    from raft_tpu.config import OursConfig
    from raft_tpu.models.ours import SparseRAFT

    return SparseRAFT(OursConfig(**TINY,
                                 encoder_iterations=encoder_iterations,
                                 alternate_corr=alternate_corr))


def filled_init(module, *args, seed: int = WEIGHT_SEED, **kwargs):
    """A flax ``module``'s variables (numpy) for ``module.init(rngs, *args,
    **kwargs)``: the init's shapes by ``jax.eval_shape``, filled from
    ``seed`` (``fill_variables``). Running a flax init op by op takes
    seconds to minutes on the CPU; its shapes take a trace."""
    import jax

    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *args, **kwargs))
    return fill_variables(shapes, seed)


def jax_variables(model, batch: int = 1, seed: int = WEIGHT_SEED):
    """``model``'s variables (numpy), from the init's shapes and ``seed``."""
    import jax.numpy as jnp

    img = jnp.zeros((batch, *HW, 3), jnp.float32)
    return filled_init(model, img, img, seed=seed)


def flat_train_state(model, variables, tx):
    """A ``raft_tpu.parallel.train_step.RAFTTrainState`` at step 0 that
    carries ``variables``' parameters and batch statistics as one flat
    vector each (``jax.flatten_util.ravel_pytree``), unravelled inside its
    ``apply_fn``, and a function that turns such a state's vectors back
    into variables (numpy). ``make_train_step`` computes the same step on
    it (AdamW's decay mask holds every parameter of a model without
    frozen batch norms, and the clip's global norm sums the same squares),
    but XLA on the CPU compiles its optimizer and non-finite guard as a
    few fusions instead of several for every leaf, which takes minutes for
    a model of a few hundred leaves."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from raft_tpu.parallel.train_step import RAFTTrainState

    params, unravel_p = ravel_pytree(variables["params"])
    stats, unravel_s = ravel_pytree(variables["batch_stats"])

    def apply_fn(v, *args, **kwargs):
        out, mutated = model.apply(
            {"params": unravel_p(v["params"]["flat"]),
             "batch_stats": unravel_s(v["batch_stats"]["flat"])},
            *args, **kwargs)
        return out, {"batch_stats": {
            "flat": ravel_pytree(mutated["batch_stats"])[0]}}

    def unflatten(state):
        return jax.tree_util.tree_map(np.asarray, {
            "params": unravel_p(state.params["flat"]),
            "batch_stats": unravel_s(state.batch_stats["flat"])})

    state = RAFTTrainState(
        step=jnp.zeros((), jnp.int32), params={"flat": params},
        batch_stats={"flat": stats}, opt_state=tx.init({"flat": params}),
        apply_fn=apply_fn, tx=tx)
    return state, unflatten


def tiny_variables():
    """Variables of the tiny configuration with ``encoder_iterations`` 1
    and 0 from one ``eval_shape`` (each costs a trace of the model): the
    second are the first without the encoder's entries."""
    full = jax_variables(jax_model(1))
    enc = ("encoder_0", "context_encoder_0", "encoder_pos_proj")
    lean = {"params": {k: v for k, v in full["params"].items()
                       if k not in enc},
            "batch_stats": full["batch_stats"]}
    return {0: lean, 1: full}


def jax_forward(model, variables, img1, img2):
    """One compiled JAX forward (``test_mode=False``): ``(flow_low, flow_up,
    flow_predictions, sparse_predictions)`` as numpy. ``flow_low`` and
    ``flow_up`` are computed from the last prediction as
    ``SparseRAFT.__call__``'s ``test_mode`` branch computes them, which
    saves a second trace of the model."""
    import jax

    def run(v, a, b):
        flows, sparse = model.apply(v, a, b, test_mode=False)
        up = flows[-1]
        n, h, w, _ = up.shape
        low = jax.image.resize(up, (n, h // 8, w // 8, 2), "linear") / 8.0
        return low, up, flows, sparse

    args = (variables, img1, img2)
    return jax.tree_util.tree_map(np.asarray, jax.jit(run).lower(
        *args).compile(compiler_options=FAST_COMPILE)(*args))


def make_fixture():
    """The fixture's arrays: the tiny configuration's converted weights
    (float16, exact), one seeded pair and JAX's ``flow_up`` for it."""
    from raft_tpu_torch.weights import sparse_state_dict_from_flax

    variables = tiny_variables()[0]
    img1, img2 = frames(1)
    _, flow_up, _, _ = jax_forward(jax_model(), variables, img1, img2)
    state = sparse_state_dict_from_flax(variables)
    arrays = {f"weights.{k}": (v.numpy().astype(np.float16)
                               if v.is_floating_point() else v.numpy())
              for k, v in state.items()}
    arrays.update(config=np.array(json.dumps(TINY)),
                  image1=img1[0].astype(np.uint8),
                  image2=img2[0].astype(np.uint8),
                  flow_up=flow_up[0].astype(np.float32))
    return arrays


def load_fixture(path: str = FIXTURE):
    """``(config kwargs, state dict of float32 numpy arrays, image1, image2,
    flow_up)`` from the fixture file."""
    with np.load(path) as z:
        state = {k[len("weights."):]: np.asarray(z[k], np.float32)
                 for k in z.files if k.startswith("weights.")}
        return (json.loads(str(z["config"])), state,
                z["image1"].astype(np.float32),
                z["image2"].astype(np.float32), z["flow_up"])


if __name__ == "__main__":
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE}: {os.path.getsize(FIXTURE)} bytes")
