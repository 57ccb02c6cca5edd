"""Backward by recomputation, for the update-block kernels.

The motion, GRU and step kernels (``ops/motion_cuda.py``,
``ops/gru_cuda.py``, ``ops/step_cuda.py``) have no backward kernel, as
their TPU counterparts have none: the JAX custom VJPs (``_motion_bwd``,
``_gru_bwd``, ``_step_bwd``) recompute the forward through the plain jnp
twin and differentiate that. ``RecomputeFn`` does the same in PyTorch:
its forward runs a given callable (the kernel's wrapper, or in a CPU test
the plain version in its place) on the inputs, saving only the inputs;
its backward runs the plain version again under ``torch.enable_grad()``
and returns ``torch.autograd.grad`` of it with respect to every input that
needs one: the activations and the raw convolution weights and biases.
Packed weights are derived from the raw ones and never differentiated.
"""

from __future__ import annotations

import torch


class RecomputeFn(torch.autograd.Function):
    """``RecomputeFn.apply(run, plain, *inputs)``: ``run(*inputs)`` in the
    forward, gradients of ``plain(*inputs)`` in the backward. Both return a
    tensor or a tuple of tensors of the same shapes."""

    @staticmethod
    def forward(ctx, run, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return run(*inputs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*leaves)
            outs = out if isinstance(out, tuple) else (out,)
            wanted = [t for t, need in zip(leaves, needs) if need]
            got = iter(torch.autograd.grad(outs, wanted, grads,
                                           allow_unused=True))
        return (None, None, *(next(got) if need else None for need in needs))


def flatten(convs) -> list:
    """``[w0, b0, w1, b1, ...]`` of ``(weight, bias)`` pairs."""
    return [t for pair in convs for t in pair]


def pairs(flat) -> tuple:
    """The inverse of ``flatten``."""
    return tuple(zip(flat[0::2], flat[1::2]))
