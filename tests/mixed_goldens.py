"""Committed JAX outputs for the mixed-precision tests of the port.

Each of ``tests/test_torch_mixed.py``, ``tests/test_torch_mixed_train.py``
and ``tests/test_torch_mixed_chain.py`` keeps its live comparisons with the
JAX package; a few of their JAX computations, each a compile of seconds to
tens of seconds on the CPU, are committed here in
``assets/golden/mixed_jax.npz`` instead:

- ``metrics.step``, ``metrics.chain``: the loss, EPE and gradient norm of
  JAX's mixed train step (on the step kernel, and on the chain) as XLA on
  the CPU compiles it by default, with its excess precision; the train
  tests compile the rounding step themselves and take these for their
  bars;
- ``lookup.<maps>``: the TPU lookup kernel at ``mxu_dtype="bfloat16"`` in
  the Pallas interpreter (``test_torch_mixed.jax_lookup``);
- ``step.<depth>.<output>``: the TPU step kernel at ``dtype=bfloat16`` in
  the interpreter (``test_torch_mixed.jax_step``);
- ``corr_bwd.<case>.<dtype>.<k>``: the TPU lookup's custom VJP, the Pallas
  backward kernel in the interpreter, df1 (k = 0) and df2 of each level
  (``test_torch_mixed_train.jax_corr_bwd``);
- ``chain.motion``, ``chain.gru.<parts>``, ``chain.block.<mask>.<k>``: the
  motion and GRU kernels in the interpreter and the flax block on its
  chain (``test_torch_mixed_chain.jax_motion``, ``jax_gru``,
  ``jax_chain_block``).

Each array is stored in float32 beside the dtype JAX gave it
(``dtype.<key>``). Rewrite them from the JAX package (a minute or two of
CPU):

    JAX_PLATFORMS=cpu python tests/mixed_goldens.py
"""

import os

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets", "golden", "mixed_jax.npz")
METRICS = ("loss", "epe", "grad_norm")


def _arrays() -> dict:
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def load() -> dict:
    """{"step": {metric: value}, "chain": {metric: value}}."""
    z = _arrays()
    return {kind: dict(zip(METRICS, map(float, z[f"metrics.{kind}"])))
            for kind in ("step", "chain")}


def array(key: str, dtype: str) -> np.ndarray:
    """JAX's output ``key`` in float32; JAX gave it in ``dtype``."""
    z = _arrays()
    assert str(z[f"dtype.{key}"]) == dtype, (key, str(z[f"dtype.{key}"]), dtype)
    return z[key]


def make() -> dict:
    """Every committed array, from the test files' own inputs."""
    import pytest

    import test_torch_mixed as mixed
    import test_torch_mixed_chain as chain
    import test_torch_mixed_train as step

    out = {}

    def put(key, a):
        out[key] = np.asarray(a).astype(np.float32)
        out[f"dtype.{key}"] = np.array(str(a.dtype))

    with np.load(step.WEIGHTS) as z:
        npz = {k: np.asarray(z[k], np.float32) for k in z.files}
    metrics = step._jax_step(npz, step._batch(), True, excess=True)[0]
    out["metrics.step"] = np.array([metrics[k] for k in METRICS], np.float64)
    mp = pytest.MonkeyPatch()
    for k, v in chain.CHAIN_CONV_FLAGS.items():
        mp.setenv(k, v)
    try:
        metrics = chain.jax_chain_step(npz, chain._batch(), excess=True)[1]
    finally:
        mp.undo()
    out["metrics.chain"] = np.array([float(metrics[k]) for k in METRICS], np.float64)
    for maps in ("bfloat16", "float32"):
        put(f"lookup.{maps}", mixed.jax_lookup(maps, maps))
    for depth in ("mg", "mgf"):
        for name, a in zip(("h2", "delta"), mixed.jax_step(depth)):
            put(f"step.{depth}.{name}", a)
    for case, (maps, *_) in enumerate(step.CORR_CASES):
        for dtype in ("bfloat16", "float32") if maps == "bfloat16" else ("float32",):
            for k, a in enumerate(step.jax_corr_bwd(case, dtype)):
                put(f"corr_bwd.{case}.{dtype}.{k}", a)
    put("chain.motion", chain.jax_motion())
    for parts in (1, 2):
        put(f"chain.gru.{parts}", chain.jax_gru(parts))
    mp = pytest.MonkeyPatch()
    for k, v in chain.CHAIN_FLAGS.items():
        mp.setenv(k, v)
    try:
        for mask, outs in zip(("mask", "nomask"), chain.jax_chain_block()):
            for k, a in enumerate(outs):
                if a is not None:
                    put(f"chain.block.{mask}.{k}", a)
    finally:
        mp.undo()
    return out


if __name__ == "__main__":
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.dirname(here)]
    # as tests/conftest.py sets them for the tests
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    arrays = make()
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {', '.join(k for k in arrays if not k.startswith('dtype.'))}")
