"""Synthetic dataset trees in the layouts ``datasets.py`` reads, for smoke
runs and tests where the real FlyingChairs, FlyingThings3D, Sintel, KITTI
and HD1K files are absent.

Each pair is a frame of random texture and the same frame moved by a
whole-pixel shift drawn from ``seed`` (wrapped at the borders), with the
shift as its flow; the images are 8-bit RGB. ``write_tree(root, stage,
...)`` writes every dataset that ``fetch_dataloader(stage, root=root)``
reads. The KITTI and HD1K flow files are KITTI's 16-bit PNGs, which need
OpenCV (``frame_utils.write_flow_kitti``).

    python -c "from raft_tpu_torch.data.synthetic import write_chairs; \\
        write_chairs('/tmp/datasets', 64, (384, 512), seed=0)"
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Tuple

import numpy as np
from PIL import Image

from raft_tpu_torch.data import frame_utils

MAX_SHIFT = 6       # px, either way, a pair


def _pairs(n: int, hw: Tuple[int, int], seed: int):
    """``n`` (image1, image2, flow) of shape ``hw``: uint8 frames and the
    float32 flow (dx, dy) of image2 = image1 moved by (dx, dy)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        img1 = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        dx, dy = (int(v) for v in rng.integers(-MAX_SHIFT, MAX_SHIFT + 1, 2))
        img2 = np.roll(img1, (dy, dx), axis=(0, 1))
        flow = np.empty((*hw, 2), np.float32)
        flow[..., 0], flow[..., 1] = dx, dy
        yield img1, img2, flow


def _sequence(n: int, hw: Tuple[int, int], seed: int):
    """``n`` + 1 frames, each the last moved, and the ``n`` flows between
    them."""
    frames, flows = [], []
    for img1, img2, flow in _pairs(n, hw, seed):
        if frames:
            dx, dy = (int(v) for v in flow[0, 0])
            img2 = np.roll(frames[-1], (dy, dx), axis=(0, 1))
        else:
            frames.append(img1)
        frames.append(img2)
        flows.append(flow)
    return frames, flows


def _png(path: str, image: np.ndarray) -> None:
    os.makedirs(osp.dirname(path), exist_ok=True)
    Image.fromarray(image).save(path)


def write_chairs(root: str, pairs: int, hw: Tuple[int, int] = (384, 512),
                 seed: int = 0) -> str:
    """``root/FlyingChairs_release/data``: ``%05d_img1.ppm``,
    ``%05d_img2.ppm`` and ``%05d_flow.flo`` (FlyingChairs is 384x512).
    Which pairs train is the split file's business (``chairs_split.npz``:
    the first 64 hold 59 training pairs). Returns the data directory."""
    data = osp.join(root, "FlyingChairs_release", "data")
    os.makedirs(data, exist_ok=True)
    for i, (img1, img2, flow) in enumerate(_pairs(pairs, hw, seed), 1):
        Image.fromarray(img1).save(osp.join(data, f"{i:05d}_img1.ppm"))
        Image.fromarray(img2).save(osp.join(data, f"{i:05d}_img2.ppm"))
        frame_utils.write_flo(osp.join(data, f"{i:05d}_flow.flo"), flow)
    return data


def write_things(root: str, pairs: int, hw: Tuple[int, int] = (540, 960),
                 seed: int = 0) -> None:
    """``root/FlyingThings3D``: one scene (``TRAIN/A/0000``) of ``pairs`` + 1
    left frames in both passes, with ``.pfm`` flows into the future and the
    past (the 3-channel PFM of the dataset)."""
    base = osp.join(root, "FlyingThings3D")
    frames, flows = _sequence(pairs, hw, seed)
    for dstype in ("frames_cleanpass", "frames_finalpass"):
        for i, frame in enumerate(frames):
            _png(osp.join(base, dstype, "TRAIN", "A", "0000", "left",
                          f"{i + 6:04d}.png"), frame)
    for direction, sign in (("into_future", 1.0), ("into_past", -1.0)):
        out = osp.join(base, "optical_flow", "TRAIN", "A", "0000",
                       direction, "left")
        os.makedirs(out, exist_ok=True)
        # the flow of frame i into i + 1 (future), of i + 1 into i (past)
        for i in range(len(frames)):
            flow = flows[min(i if sign > 0 else i - 1, len(flows) - 1)]
            pfm = np.concatenate([sign * flow,
                                  np.zeros((*hw, 1), np.float32)], -1)
            frame_utils.write_pfm(osp.join(out, f"OpticalFlowInto"
                                           f"{direction[5:].title()}_"
                                           f"{i + 6:04d}_L.pfm"), pfm)


def write_sintel(root: str, pairs: int, hw: Tuple[int, int] = (436, 1024),
                 seed: int = 0) -> None:
    """``root/Sintel/training``: one scene of ``pairs`` + 1 frames in the
    clean and final passes and its ``.flo`` flows."""
    base = osp.join(root, "Sintel", "training")
    frames, flows = _sequence(pairs, hw, seed)
    for dstype in ("clean", "final"):
        for i, frame in enumerate(frames, 1):
            _png(osp.join(base, dstype, "alley_1", f"frame_{i:04d}.png"),
                 frame)
    os.makedirs(osp.join(base, "flow", "alley_1"), exist_ok=True)
    for i, flow in enumerate(flows, 1):
        frame_utils.write_flo(osp.join(base, "flow", "alley_1",
                                       f"frame_{i:04d}.flo"), flow)


def write_kitti(root: str, pairs: int, hw: Tuple[int, int] = (375, 1242),
                seed: int = 0) -> None:
    """``root/KITTI/training``: ``image_2/%06d_10.png``, ``%06d_11.png`` and
    the 16-bit ``flow_occ/%06d_10.png`` (every pixel valid)."""
    base = osp.join(root, "KITTI", "training")
    os.makedirs(osp.join(base, "flow_occ"), exist_ok=True)
    for i, (img1, img2, flow) in enumerate(_pairs(pairs, hw, seed)):
        _png(osp.join(base, "image_2", f"{i:06d}_10.png"), img1)
        _png(osp.join(base, "image_2", f"{i:06d}_11.png"), img2)
        frame_utils.write_flow_kitti(
            osp.join(base, "flow_occ", f"{i:06d}_10.png"), flow)


def write_hd1k(root: str, pairs: int, hw: Tuple[int, int] = (1080, 2560),
               seed: int = 0) -> None:
    """``root/HD1k``: one sequence of ``pairs`` + 1 frames
    (``hd1k_input/image_2/000000_%04d.png``) and as many 16-bit flows
    (``hd1k_flow_gt/flow_occ``; the dataset pairs frame i with flow i, the
    last flow unused)."""
    base = osp.join(root, "HD1k")
    frames, flows = _sequence(pairs, hw, seed)
    os.makedirs(osp.join(base, "hd1k_flow_gt", "flow_occ"), exist_ok=True)
    for i, frame in enumerate(frames):
        _png(osp.join(base, "hd1k_input", "image_2", f"000000_{i:04d}.png"),
             frame)
        frame_utils.write_flow_kitti(
            osp.join(base, "hd1k_flow_gt", "flow_occ",
                     f"000000_{i:04d}.png"), flows[min(i, len(flows) - 1)])


STAGE_WRITERS = {"chairs": (write_chairs,),
                 "things": (write_things,),
                 "sintel": (write_things, write_sintel, write_kitti,
                            write_hd1k),
                 "kitti": (write_kitti,)}


def write_tree(root: str, stage: str, pairs: int, hw: Tuple[int, int],
               seed: int = 0) -> str:
    """Every dataset that ``fetch_dataloader(stage, root=root)`` reads,
    ``pairs`` pairs of ``hw`` each, each dataset from its own seed."""
    for k, writer in enumerate(STAGE_WRITERS[stage]):
        writer(root, pairs, hw, seed + k)
    return root
