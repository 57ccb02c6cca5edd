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
per call, counted in ``launches``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from raft_tpu_torch.ops import build, gru_cuda, motion_cuda
from raft_tpu_torch.ops.build import check_operand
from raft_tpu_torch.ops.conv_pack import pack_conv

launches = 0          # calls computed by the CUDA kernel
FLOW_HEAD_HIDDEN = 256


def plan_fusion(want_flow_head: bool) -> str:
    """The depth of the step kernel: ``'mgf'`` when the caller wants the
    flow head in the kernel (the iterations that skip the mask head),
    ``'mg'`` otherwise. The card has no VMEM ladder to refuse a shape, so
    there is no third answer (``step_pallas.plan_fusion`` may return None)."""
    return "mgf" if want_flow_head else "mg"


def pack_flow_head(convs) -> tuple:
    """``(wfh1 (9C, 256), bfh1 (256), wfh2 (9*256, 2), bfh2 (2))``: rows
    tap-major (``ops/conv_pack.py``); the N = 2 conv keeps its two
    columns."""
    return tuple(t for w, b in convs for t in pack_conv(w, b))


def flow_head_plain(h: torch.Tensor, convs) -> torch.Tensor:
    """The flow head with ``F.conv2d``, NHWC in and out."""
    (w1, b1), (w2, b2) = convs
    x = F.relu(F.conv2d(h.permute(0, 3, 1, 2), w1, b1, padding=1))
    return F.conv2d(x, w2, b2, padding=1).permute(0, 2, 3, 1).contiguous()


def fused_step_plain(net, inp, corr, flow, convs):
    """Motion encoder -> GRU with x parts (inp, motion) -> flow head (if
    ``convs[2]`` is not None), each the module's plain version."""
    motion, gru, head = convs
    mot = motion_cuda.motion_encoder_plain(flow, corr, motion)
    h2 = gru_cuda.sepconv_gru_plain(net, (inp, mot), gru)
    if head is None:
        return h2
    return h2, flow_head_plain(h2, head)


_ARGTYPES = [ctypes.c_void_p] * 29 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def fused_step_cuda(net, inp, corr, flow, packed):
    """Launch the kernel of ``csrc/update_step.cu`` on the current stream.

    Float32, contiguous, on one CUDA device; C a multiple of 64, Ci of 16,
    Cc of 4. Returns h2 (B, H, W, C), or ``(h2, delta (B, H, W, 2))`` when
    ``packed[2]`` is not None.
    """
    global launches
    if net.device.type != "cuda":
        raise ValueError(f"the step kernel needs CUDA tensors, got "
                         f"{net.device}")
    B, H, W, C = net.shape
    ci, cc = inp.shape[-1], corr.shape[-1]
    if C % 64 or ci % 16 or cc % 4:
        raise ValueError(f"C must be a multiple of 64, Ci of 16 and Cc of "
                         f"4, got C={C}, Ci={ci}, Cc={cc}")
    dev = net.device
    for name, t, ch in (("net", net, C), ("inp", inp, ci), ("corr", corr, cc),
                        ("flow", flow, 2)):
        check_operand(name, t, (B, H, W, ch), dev)
    motion, gru, head = packed
    motion_cuda.check_packed(motion, cc, dev)
    gru_cuda.check_packed(gru, gru_cuda.TAPS * (C + ci + motion_cuda.OUT_CHANNELS),
                          C, dev)
    if head is not None:
        shapes = [(9 * C, FLOW_HEAD_HIDDEN), (FLOW_HEAD_HIDDEN,),
                  (9 * FLOW_HEAD_HIDDEN, 2), (2,)]
        if len(head) != len(shapes):
            raise ValueError(f"expected {len(shapes)} packed flow-head "
                             f"tensors, got {len(head)}")
        for n, (t, s) in enumerate(zip(head, shapes)):
            check_operand(f"flow-head packed[{n}]", t, s, dev)
    m = B * H * W
    scratch = torch.empty(
        m * (motion_cuda.SCRATCH + motion_cuda.OUT_CHANNELS + 3 * C),
        device=dev)
    h2 = torch.empty_like(net)
    delta = None if head is None else torch.empty(B, H, W, 2, device=dev)
    head_ptrs = [None] * 4 if head is None else [t.data_ptr() for t in head]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.bind("update_step", "raft_update_step", _ARGTYPES)(
            net.data_ptr(), inp.data_ptr(), corr.data_ptr(), flow.data_ptr(),
            *[t.data_ptr() for t in motion], *[t.data_ptr() for t in gru],
            *head_ptrs, scratch.data_ptr(), h2.data_ptr(),
            None if delta is None else delta.data_ptr(),
            B, H, W, C, ci, cc, int(head is not None), stream)
    if err:
        raise RuntimeError(f"update_step kernel failed: cudaError {err}")
    launches += 1
    return h2 if delta is None else (h2, delta)


def fused_step(net, inp, corr, flow, convs, packed):
    """One refine iteration: the plain version (``convs``) for a CPU
    tensor, the CUDA kernel (``packed``) for a CUDA tensor. The depth is
    ``'mgf'`` when the head entry of the triples is not None."""
    if net.device.type == "cpu":
        return fused_step_plain(net, inp, corr, flow, convs)
    return fused_step_cuda(net, inp, corr, flow, packed)
