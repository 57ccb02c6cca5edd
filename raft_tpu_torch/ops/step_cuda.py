"""One refine iteration of the update block: the CUDA kernel and its plain
version.

Counterpart of ``raft_tpu/ops/step_pallas.py``: the motion encoder
(``ops/motion_cuda.py``), then the SepConvGRU cell (``ops/gru_cuda.py``)
with x = ``(inp, [motion | flow])`` as two parts, and at depth ``'mgf'`` the
flow head (3x3 C->256, ReLU, 3x3 256->2), in float32. Depth ``'mg'``
returns h2, depth ``'mgf'`` returns ``(h2, delta)``. All tensors are NHWC:
``net`` (B, H, W, C), ``inp`` (B, H, W, Ci), ``corr`` (B, H, W, Cc),
``flow`` (B, H, W, 2).

``convs`` and ``packed`` are triples ``(motion, gru, head)`` of the three
modules' ``(weight, bias)`` pairs in torch layout and of their packed
weights (``motion_cuda.pack_weights``, ``gru_cuda.pack_weights``,
``pack_flow_head``); ``head`` is None at depth ``'mg'``.

``fused_step`` is the entry point: a tensor on the CPU goes to the plain
version, a CUDA tensor to the kernel in ``csrc/update_step.cu`` (one launch
per call, counted in ``launches``) through ``fused_step_autograd``, whose
backward recomputes through the plain version (``ops/recompute.py``, the
strategy of the JAX ``_step_bwd``).

The kernel's bf16 form (``fused_step_cuda`` on bfloat16 tensors, the JAX
kernel at ``dtype=bfloat16``) takes bfloat16 activations and the weights
packed by ``pack_bf16`` and returns bfloat16 h2 and delta; it rounds where
the JAX kernel rounds (``csrc/conv_phase.cuh``). Its plain version is
``fused_step_plain`` on bfloat16 inputs (``conv_pack.conv2d``), which is
also its backward: ``fused_step`` routes it through
``fused_step_autograd`` as it routes the float32 form, and the recompute's
bfloat16 convolutions cast the float32 weights in the graph, so the
gradients reach the float32 parameters (the JAX ``_step_bwd`` recomputes
through its bf16 ``reference_step`` the same way). It counts its launches
in ``bf16_launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from raft_tpu_torch.ops import build, gru_cuda, motion_cuda
from raft_tpu_torch.ops.build import check_operand
from raft_tpu_torch.ops.conv_pack import conv2d, pack_conv, pack_conv_bf16
from raft_tpu_torch.ops.conv_tile import c_plan
from raft_tpu_torch.ops.recompute import RecomputeFn, flatten, pairs

launches = 0          # calls computed by the CUDA kernel
bf16_launches = 0     # calls computed by its bf16 form
FLOW_HEAD_HIDDEN = 256


def plan_fusion(want_flow_head: bool) -> str:
    """The depth of the step kernel: ``'mgf'`` when the caller wants the
    flow head in the kernel (the iterations that skip the mask head),
    ``'mg'`` otherwise. The card has no VMEM ladder to refuse a shape, so
    there is no third answer (``step_pallas.plan_fusion`` may return None)."""
    return "mgf" if want_flow_head else "mg"


def pack_flow_head(convs) -> tuple:
    """``(wfh1 (2, 256, 9C), bfh1 (256), wfh2 (9*256, 2), bfh2 (2))``:
    K tap-major, wfh1 transposed and split into TF32 hi and lo
    (``ops/conv_pack.py``); the N = 2 conv keeps its two f32 columns."""
    return tuple(t for w, b in convs for t in pack_conv(w, b))


def pack_flow_head_bf16(convs) -> tuple:
    """``pack_flow_head``'s layout for the bf16 form: wfh1 one bfloat16
    (256, 9C) matrix, wfh2 a bfloat16 (64, 9*256) one (its two columns
    padded to the tile's 64), the biases float32 holding bfloat16 values
    (``conv_pack.pack_conv_bf16``)."""
    return tuple(t for w, b in convs for t in pack_conv_bf16(w, b))


def pack_bf16(convs) -> tuple:
    """The bf16 form's ``packed`` triple from the ``convs`` triple
    (``head`` None at depth 'mg')."""
    motion, gru, head = convs
    return (motion_cuda.pack_weights_bf16(motion),
            gru_cuda.pack_weights_bf16(gru),
            None if head is None else pack_flow_head_bf16(head))


def flow_head_plain(h: torch.Tensor, convs) -> torch.Tensor:
    """The flow head with ``F.conv2d`` (``conv_pack.conv2d``: in bfloat16
    for a bfloat16 ``h``), NHWC in and out."""
    (w1, b1), (w2, b2) = convs
    x = F.relu(conv2d(h.permute(0, 3, 1, 2), w1, b1, padding=1))
    return conv2d(x, w2, b2, padding=1).permute(0, 2, 3, 1).contiguous()


def fused_step_plain(net, inp, corr, flow, convs):
    """Motion encoder -> GRU with x parts (inp, motion) -> flow head (if
    ``convs[2]`` is not None), each the module's plain version; in the
    inputs' dtype (bfloat16: the bf16 form's plain version)."""
    motion, gru, head = convs
    mot = motion_cuda.motion_encoder_plain(flow, corr, motion)
    h2 = gru_cuda.sepconv_gru_plain(net, (inp, mot), gru)
    if head is None:
        return h2
    return h2, flow_head_plain(h2, head)


_ARGTYPES = [ctypes.c_void_p] * 29 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# the bf16 form's: the tile plan (ops/conv_tile.py) before the stream
_ARGTYPES_BF16 = _ARGTYPES[:-1] + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                   ctypes.c_void_p]


def _check_head(head, C: int, dev, bf16: bool) -> None:
    shapes = [(2, FLOW_HEAD_HIDDEN, 9 * C), (FLOW_HEAD_HIDDEN,),
              (9 * FLOW_HEAD_HIDDEN, 2), (2,)]
    if bf16:
        shapes = [(FLOW_HEAD_HIDDEN, 9 * C), (FLOW_HEAD_HIDDEN,),
                  (64, 9 * FLOW_HEAD_HIDDEN), (64,)]
    if len(head) != len(shapes):
        raise ValueError(f"expected {len(shapes)} packed flow-head "
                         f"tensors, got {len(head)}")
    for n, (t, s) in enumerate(zip(head, shapes)):
        check_operand(f"flow-head packed[{n}]", t, s, dev,
                      torch.bfloat16 if bf16 and n % 2 == 0 else None)


def fused_step_cuda(net, inp, corr, flow, packed):
    """Launch the kernel of ``csrc/update_step.cu`` on the current stream:
    its float32 form, or its bf16 form when ``net`` is bfloat16.

    ``net``, ``inp``, ``corr``, ``flow`` all float32 or all bfloat16,
    contiguous, on one CUDA device; C a multiple of 64, Ci of 16, Cc of 4;
    ``packed`` from the ``pack_*`` functions of that dtype's form
    (``pack_bf16`` for bfloat16). Returns h2 (B, H, W, C), or ``(h2, delta
    (B, H, W, 2))`` when ``packed[2]`` is not None, in ``net``'s dtype.
    Forward only: ``fused_step_autograd`` gives either form its gradient.
    """
    global launches, bf16_launches
    if net.device.type != "cuda":
        raise ValueError(f"the step kernel needs CUDA tensors, got "
                         f"{net.device}")
    bf16 = net.dtype == torch.bfloat16
    B, H, W, C = net.shape
    ci, cc = inp.shape[-1], corr.shape[-1]
    if C % 64 or ci % 16 or cc % 4:
        raise ValueError(f"C must be a multiple of 64, Ci of 16 and Cc of "
                         f"4, got C={C}, Ci={ci}, Cc={cc}")
    dev = net.device
    for name, t, ch in (("net", net, C), ("inp", inp, ci), ("corr", corr, cc),
                        ("flow", flow, 2)):
        check_operand(name, t, (B, H, W, ch), dev,
                      torch.bfloat16 if bf16 else None)
    motion, gru, head = packed
    motion_cuda.check_packed(motion, cc, dev, bf16)
    gru_cuda.check_packed(gru, gru_cuda.TAPS * (C + ci + motion_cuda.OUT_CHANNELS),
                          C, dev, bf16)
    if head is not None:
        _check_head(head, C, dev, bf16)
    m = B * H * W
    scratch = torch.empty(
        m * (motion_cuda.SCRATCH + motion_cuda.OUT_CHANNELS + 3 * C),
        device=dev, dtype=net.dtype)
    h2 = torch.empty_like(net)
    delta = None if head is None else torch.empty(B, H, W, 2, device=dev,
                                                  dtype=net.dtype)
    head_ptrs = [None] * 4 if head is None else [t.data_ptr() for t in head]
    symbol = "raft_update_step_bf16" if bf16 else "raft_update_step"
    plan = c_plan("step", C, ci, cc, head is not None) if bf16 else ()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.bind("update_step", symbol,
                         _ARGTYPES_BF16 if bf16 else _ARGTYPES)(
            net.data_ptr(), inp.data_ptr(), corr.data_ptr(), flow.data_ptr(),
            *[t.data_ptr() for t in motion], *[t.data_ptr() for t in gru],
            *head_ptrs, scratch.data_ptr(), h2.data_ptr(),
            None if delta is None else delta.data_ptr(),
            B, H, W, C, ci, cc, int(head is not None), *plan, stream)
    if err:
        raise RuntimeError(f"{symbol} failed: cudaError {err}")
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return h2 if delta is None else (h2, delta)


def fused_step_autograd(net, inp, corr, flow, convs, run):
    """The step as a ``RecomputeFn``: ``run(net, inp, corr, flow)`` in the
    forward (the kernel, or the plain version in a CPU test), and in the
    backward the gradients of ``fused_step_plain`` for the four activations
    and every raw weight and bias in ``convs`` (5 + 6 convolutions, + 2 at
    ``'mgf'``)."""
    motion, gru, head = convs
    n_motion, n_gru = 2 * len(motion), 2 * len(gru)

    def plain(net, inp, corr, flow, *w):
        return fused_step_plain(net, inp, corr, flow, (
            pairs(w[:n_motion]), pairs(w[n_motion:n_motion + n_gru]),
            pairs(w[n_motion + n_gru:]) if head is not None else None))

    return RecomputeFn.apply(lambda *a: run(*a[:4]), plain, net, inp, corr,
                             flow, *flatten(motion), *flatten(gru),
                             *flatten(head or ()))


def fused_step(net, inp, corr, flow, convs, packed):
    """One refine iteration: the plain version (``convs``) for a CPU
    tensor, the CUDA kernel (``packed``) for a CUDA tensor, differentiable
    either way; for bfloat16 tensors the kernel's bf16 form (``packed``
    from ``pack_bf16``). The packed weights feed only the kernel; the
    gradients come from the raw ``convs``. The depth is ``'mgf'`` when the
    head entry of the triples is not None."""
    if net.device.type == "cpu":
        return fused_step_plain(net, inp, corr, flow, convs)
    return fused_step_autograd(
        net, inp, corr, flow, convs,
        lambda *a: fused_step_cuda(*a, packed))
