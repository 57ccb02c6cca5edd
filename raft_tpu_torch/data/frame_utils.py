"""Optical-flow file I/O, copied from ``raft_tpu/data/frame_utils.py``
(framework-free numpy; the port imports nothing of the JAX package).

The formats the reference reads and writes (``core/utils/frame_utils.py``):
Middlebury ``.flo`` (magic 202021.25), Freiburg ``.pfm``, KITTI 16-bit PNG
flow ``(value - 2^15) / 64`` with its validity channel, KITTI disparity
PNG, and the ``read_gen`` extension dispatcher. The KITTI readers and
writer need OpenCV (imported when called).
"""

from __future__ import annotations

import re
from os.path import splitext

import numpy as np
from PIL import Image

TAG_FLOAT = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Read a Middlebury .flo file → (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(TAG_FLOAT):
            raise ValueError(f"{path}: invalid .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write (H, W, 2) flow as Middlebury .flo."""
    flow = np.asarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError("flow must be (H, W, 2)")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([TAG_FLOAT], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.tofile(f)


def read_pfm(path: str):
    """Read a .pfm file → (data, scale); data is (H, W) or (H, W, 3)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    # PFM stores rows bottom-to-top.
    return np.flipud(data.reshape(shape)), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("image must be HxW, HxWx1 or HxWx3")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)


def read_flow_kitti(path: str):
    """Read KITTI 16-bit PNG flow → ((H, W, 2) float32, (H, W) valid)."""
    import cv2
    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)  # BGR → RGB = (u, v, valid)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    flow = (flow - 2 ** 15) / 64.0
    return flow, valid


def write_flow_kitti(path: str, flow: np.ndarray) -> None:
    import cv2
    flow = 64.0 * np.asarray(flow, np.float64) + 2 ** 15
    h, w = flow.shape[:2]
    out = np.concatenate([flow, np.ones((h, w, 1))], axis=-1).astype(np.uint16)
    cv2.imwrite(path, out[..., ::-1])


def read_disp_kitti(path: str):
    """Read KITTI disparity PNG as a flow field (u = -disp, v = 0)."""
    import cv2
    disp = cv2.imread(path, cv2.IMREAD_ANYDEPTH).astype(np.float32) / 256.0
    valid = disp > 0.0
    flow = np.stack([-disp, np.zeros_like(disp)], axis=-1)
    return flow, valid


def read_gen(path: str, pil: bool = False):
    """Extension-dispatched reader: images → PIL/ndarray, flow → arrays."""
    ext = splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        return Image.open(path)
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        data, _ = read_pfm(path)
        if data.ndim == 3:
            return data[:, :, :-1]  # drop the unused third channel
        return data
    return []


# Reference-compatible aliases (the reference exposes camelCase names,
# ``core/utils/frame_utils.py:12-120``); the snake_case functions above are
# the canonical spellings here.
readFlow = read_flo
writeFlow = write_flo
readPFM = read_pfm
writePFM = write_pfm
readFlowKITTI = read_flow_kitti
writeFlowKITTI = write_flow_kitti
readDispKITTI = read_disp_kitti
