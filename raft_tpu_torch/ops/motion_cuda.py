"""BasicMotionEncoder: the CUDA kernel and its plain version.

Counterpart of ``raft_tpu/ops/motion_pallas.py``: RAFT-large's five motion
convolutions, each with bias and ReLU,

    cor = convc2(convc1(corr))    1x1 Cc->256, 3x3 256->192
    flo = convf2(convf1(flow))    7x7 2->128,  3x3 128->64
    out = conv([cor | flo])       3x3 256->126

emitted as ``[out (126) | flow (2)]`` with the flow passed through
untouched, in float32. ``flow`` (B, H, W, 2) and ``corr`` (B, H, W, Cc) are
NHWC, as is the output (B, H, W, 128). ``convs`` are the five ``(weight,
bias)`` pairs in torch layout, ordered (convc1, convc2, convf1, convf2,
conv).

``motion_encoder`` is the entry point: a tensor on the CPU goes to the
plain ``F.conv2d`` version, a CUDA tensor to the kernel in
``csrc/motion_fwd.cu`` (one launch, counted in ``launches``), which takes
the weights packed once by ``pack_weights``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.build import check_operand
from raft_tpu_torch.ops.conv_pack import BN, pack_conv, packed_rows, round_up

launches = 0          # calls computed by the CUDA kernel
# Output widths of convc1, convc2, convf1, convf2 and conv (fixed by
# RAFT-large; csrc/conv_phase.cuh holds the same constants).
WIDTHS = (256, 192, 128, 64, 126)
OUT_CHANNELS = WIDTHS[4] + 2
# Scratch floats a pixel: convc1's and convf1's outputs, [cor | flo].
SCRATCH = WIDTHS[0] + WIDTHS[2] + WIDTHS[1] + WIDTHS[3]
KSIZES = (1, 3, 7, 3, 3)


def motion_encoder_plain(flow: torch.Tensor, corr: torch.Tensor,
                         convs) -> torch.Tensor:
    """The encoder with ``F.conv2d``, NHWC in and out."""
    (wc1, bc1), (wc2, bc2), (wf1, bf1), (wf2, bf2), (wo, bo) = convs
    flo_c = flow.permute(0, 3, 1, 2)
    cor = F.relu(F.conv2d(corr.permute(0, 3, 1, 2), wc1, bc1))
    cor = F.relu(F.conv2d(cor, wc2, bc2, padding=1))
    flo = F.relu(F.conv2d(flo_c, wf1, bf1, padding=3))
    flo = F.relu(F.conv2d(flo, wf2, bf2, padding=1))
    out = F.relu(F.conv2d(torch.cat([cor, flo], dim=1), wo, bo, padding=1))
    return torch.cat([out, flo_c], dim=1).permute(0, 2, 3, 1).contiguous()


def pack_weights(convs) -> tuple:
    """The kernel's weight layout (``ops/conv_pack.py``): ``(wc1, bc1,
    wc2, bc2, wf1, bf1, wf2, bf2, wo, bo)``. wc1 is (round16(Cc), 256):
    Cc rows then zero rows. wf1 is (112, 128): 49 taps x 2 flow channels,
    then 14 zero rows. The fusing conv's rows hold, per tap, the cor row
    group (192) and then the flo row group (64), the order of its
    ``[cor | flo]`` input buffer; its 126 columns are padded to 128."""
    return tuple(t for w, b in convs for t in pack_conv(w, b))


def packed_shapes(cc: int) -> list:
    """Shapes of ``pack_weights`` output for Cc correlation channels."""
    cins = (cc, WIDTHS[0], 2, WIDTHS[2], WIDTHS[1] + WIDTHS[3])
    shapes = []
    for cin, k, n in zip(cins, KSIZES, WIDTHS):
        ldw = round_up(n, BN)
        shapes += [(packed_rows(cin, k * k), ldw), (ldw,)]
    return shapes


def check_packed(packed, cc: int, device) -> None:
    """Raise unless ``packed`` is ``pack_weights`` output for Cc = ``cc``
    on ``device``."""
    shapes = packed_shapes(cc)
    if len(packed) != len(shapes):
        raise ValueError(f"expected {len(shapes)} packed motion tensors, "
                         f"got {len(packed)}")
    for n, (t, s) in enumerate(zip(packed, shapes)):
        check_operand(f"motion packed[{n}]", t, s, device)


_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def motion_encoder_cuda(flow: torch.Tensor, corr: torch.Tensor,
                        packed) -> torch.Tensor:
    """Launch the kernel of ``csrc/motion_fwd.cu`` on the current stream.

    ``flow`` (B, H, W, 2) and ``corr`` (B, H, W, Cc): float32, contiguous,
    on one CUDA device, Cc a multiple of 4. ``packed`` is ``pack_weights``
    output on the same device. Returns (B, H, W, 128).
    """
    global launches
    if corr.device.type != "cuda":
        raise ValueError(f"the motion kernel needs CUDA tensors, got "
                         f"{corr.device}")
    B, H, W, cc = corr.shape
    if cc % 4:
        raise ValueError(f"Cc must be a multiple of 4, got {cc}")
    dev = corr.device
    check_operand("corr", corr, (B, H, W, cc), dev)
    check_operand("flow", flow, (B, H, W, 2), dev)
    check_packed(packed, cc, dev)
    out = torch.empty(B, H, W, OUT_CHANNELS, device=dev)
    scratch = torch.empty(B * H * W * SCRATCH, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.bind("motion_fwd", "raft_motion_fwd", _ARGTYPES)(
            corr.data_ptr(), flow.data_ptr(), *[t.data_ptr() for t in packed],
            scratch.data_ptr(), out.data_ptr(), B, H, W, cc, stream)
    if err:
        raise RuntimeError(f"motion_fwd kernel failed: cudaError {err}")
    launches += 1
    return out


def motion_encoder(flow: torch.Tensor, corr: torch.Tensor, convs,
                   packed) -> torch.Tensor:
    """The motion encoder: the plain version (``convs``) for a CPU tensor,
    the CUDA kernel (``packed``, from ``pack_weights(convs)``) for a CUDA
    tensor."""
    if corr.device.type == "cpu":
        return motion_encoder_plain(flow, corr, convs)
    return motion_encoder_cuda(flow, corr, packed)
