"""Host-side data augmentation (numpy, the native library, cv2 or PIL),
copied from ``raft_tpu/data/augmentor.py``: the same backends in the same
order (the native library for float32 images, then cv2, then PIL) and the
same draws from the same ``numpy.random.Generator``, so that a sample
equals the JAX package's bit for bit on the same backend. ``backends()``
names the backends this host takes.

The semantics of the reference augmentors
(``core/utils/augmentor.py:15-120`` FlowAugmentor, ``:122-246``
SparseFlowAugmentor): photometric jitter (asymmetric with prob 0.2), eraser
occlusion, random scale/stretch with a floor so the crop always fits,
h/v flips, random crop; the sparse variant resizes flow by exact
valid-coordinate scatter and uses margin-biased cropping.

Differences by design:
* a local ``numpy.random.Generator`` instead of global seeding — per-worker
  reproducibility without process-global state (the reference reseeds
  workers at ``core/datasets.py:48-54``);
* the torchvision ``ColorJitter`` is re-expressed in numpy (brightness /
  contrast / saturation / hue in a random order), keeping the same factor
  ranges (brightness 0.4, contrast 0.4, saturation 0.4, hue 0.5/pi); the
  hue shift needs cv2 and is skipped without it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

try:  # cv2 is the fast path; PIL fallback keeps the module importable
    import cv2
    cv2.setNumThreads(0)  # workers must not spawn thread pools (reference
    # core/utils/augmentor.py:7-8)
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def _resize(img: np.ndarray, fx: float, fy: float,
            nearest: bool = False) -> np.ndarray:
    h, w = img.shape[:2]
    h2, w2 = int(round(h * fy)), int(round(w * fx))
    if img.dtype == np.float32:
        from raft_tpu_torch import native
        if native.available():   # C++ hot path (cv2 semantics)
            fn = native.resize_nearest if nearest else native.resize_bilinear
            return fn(img, h2, w2, fx=fx, fy=fy)
    if _HAS_CV2:
        interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
        return cv2.resize(img, None, fx=fx, fy=fy, interpolation=interp)
    from PIL import Image  # pragma: no cover
    mode = Image.NEAREST if nearest else Image.BILINEAR
    return np.asarray(Image.fromarray(img).resize((w2, h2), mode))



def backends() -> dict:
    """The backends the augmentation takes on this host: ``resize`` of the
    float32 images and dense flows ("native", "cv2" or "PIL"), the
    brightness, contrast and saturation jitter (``colour``: "native" or
    "numpy"), the hue shift ("cv2", or "skipped" without cv2) and the
    sparse flow's resize (``sparse``: "native" or "numpy")."""
    from raft_tpu_torch import native
    nat = native.available()
    return {"resize": "native" if nat else "cv2" if _HAS_CV2 else "PIL",
            "colour": "native" if nat else "numpy",
            "hue": "cv2" if _HAS_CV2 else "skipped",
            "sparse": "native" if nat else "numpy"}

# ---------------------------------------------------------------------------
# numpy color jitter (torchvision-equivalent factor semantics)

def _native_rgb(img: np.ndarray) -> bool:
    from raft_tpu_torch import native
    return (img.dtype == np.float32 and img.ndim == 3
            and img.shape[-1] == 3 and native.available())


def _adjust_brightness(img: np.ndarray, f: float) -> np.ndarray:
    if _native_rgb(img):
        from raft_tpu_torch import native
        return native.adjust_brightness(img, f)
    return np.clip(img * f, 0, 255)


def _adjust_contrast(img: np.ndarray, f: float) -> np.ndarray:
    if _native_rgb(img):
        from raft_tpu_torch import native
        return native.adjust_contrast(img, f)
    # torchvision blends toward the mean of the grayscale image
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2]).mean()
    return np.clip(img * f + gray * (1 - f), 0, 255)


def _adjust_saturation(img: np.ndarray, f: float) -> np.ndarray:
    if _native_rgb(img):
        from raft_tpu_torch import native
        return native.adjust_saturation(img, f)
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]
    return np.clip(img * f + gray * (1 - f), 0, 255)


def _adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    """Hue shift in [-0.5, 0.5] turns of the hue circle."""
    if abs(shift) < 1.0 / 360.0:
        return img  # below cv2's 2-degree hue quantum; skip the roundtrip
    if _HAS_CV2:
        hsv = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2HSV)
        h = hsv[..., 0].astype(np.int32)  # cv2 hue range [0, 180)
        hsv[..., 0] = ((h + int(round(shift * 180))) % 180).astype(np.uint8)
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32)
    return img  # pragma: no cover


class ColorJitter:
    """Numpy color jitter with torchvision-compatible parameter ranges."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.4,
                 hue=0.5 / np.pi):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, img: np.ndarray, rng: np.random.Generator
                 ) -> np.ndarray:
        img = img.astype(np.float32)
        ops = [
            lambda x: _adjust_brightness(
                x, rng.uniform(max(0, 1 - self.brightness),
                               1 + self.brightness)),
            lambda x: _adjust_contrast(
                x, rng.uniform(max(0, 1 - self.contrast),
                               1 + self.contrast)),
            lambda x: _adjust_saturation(
                x, rng.uniform(max(0, 1 - self.saturation),
                               1 + self.saturation)),
            lambda x: _adjust_hue(x, rng.uniform(-self.hue, self.hue)),
        ]
        for i in rng.permutation(4):
            img = ops[i](img)
        return img.astype(np.float32)


class FlowAugmentor:
    """Dense-flow augmentation (reference ``core/utils/augmentor.py:15-120``)."""

    def __init__(self, crop_size: Tuple[int, int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: bool = True,
                 seed: Optional[int] = None):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_flip = do_flip
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_aug = ColorJitter()
        self.rng = np.random.default_rng(seed)

    # -- photometric ------------------------------------------------------
    def color_transform(self, img1, img2):
        """Asymmetric (per-image) jitter with prob 0.2, else shared
        (reference ``:36-50``)."""
        if self.rng.random() < self.asymmetric_color_aug_prob:
            img1 = self.photo_aug(img1, self.rng)
            img2 = self.photo_aug(img2, self.rng)
        else:
            stacked = np.concatenate([img1, img2], axis=0)
            stacked = self.photo_aug(stacked, self.rng)
            img1, img2 = np.split(stacked, 2, axis=0)
        return img1, img2

    def eraser_transform(self, img1, img2, bounds=(50, 100)):
        """Occlusion aug: mean-fill 1-2 random rectangles in img2
        (reference ``:52-65``)."""
        ht, wd = img1.shape[:2]
        if self.rng.random() < self.eraser_aug_prob:
            from raft_tpu_torch import native
            use_native = (native.available() and img2.dtype == np.float32
                          and img2.flags.c_contiguous)
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(int(self.rng.integers(1, 3))):
                x0 = int(self.rng.integers(0, wd))
                y0 = int(self.rng.integers(0, ht))
                dx = int(self.rng.integers(bounds[0], bounds[1]))
                dy = int(self.rng.integers(bounds[0], bounds[1]))
                if use_native:
                    native.erase_rect(img2, y0, x0, dy, dx,
                                      mean_color.astype(np.float32),
                                      inplace=True)
                else:
                    img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    # -- spatial ----------------------------------------------------------
    def spatial_transform(self, img1, img2, flow):
        """Random scale (2^U) + stretch, floor so the crop fits (+8 px),
        flips, random crop (reference ``:67-107``)."""
        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 8) / float(ht),
                        (self.crop_size[1] + 8) / float(wd))

        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if self.rng.random() < self.stretch_prob:
            scale_x *= 2 ** self.rng.uniform(-self.max_stretch,
                                             self.max_stretch)
            scale_y *= 2 ** self.rng.uniform(-self.max_stretch,
                                             self.max_stretch)
        scale_x = max(scale_x, min_scale)
        scale_y = max(scale_y, min_scale)

        if self.rng.random() < self.spatial_aug_prob:
            img1 = _resize(img1, scale_x, scale_y)
            img2 = _resize(img2, scale_x, scale_y)
            flow = _resize(flow, scale_x, scale_y)
            flow = flow * [scale_x, scale_y]
        else:
            # No rescale, but the crop must still fit.
            if min_scale > 1.0:
                img1 = _resize(img1, min_scale, min_scale)
                img2 = _resize(img2, min_scale, min_scale)
                flow = _resize(flow, min_scale, min_scale)
                flow = flow * [min_scale, min_scale]

        if self.do_flip:
            if self.rng.random() < self.h_flip_prob:
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if self.rng.random() < self.v_flip_prob:
                img1 = img1[::-1]
                img2 = img2[::-1]
                flow = flow[::-1] * [1.0, -1.0]

        y0 = int(self.rng.integers(0, img1.shape[0] - self.crop_size[0] + 1))
        x0 = int(self.rng.integers(0, img1.shape[1] - self.crop_size[1] + 1))
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl]

    def __call__(self, img1, img2, flow):
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, np.ascontiguousarray(img2))
        img1, img2, flow = self.spatial_transform(img1, img2, flow)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


class SparseFlowAugmentor(FlowAugmentor):
    """Sparse-flow (KITTI/HD1K) augmentation: exact scatter-based flow
    resize + margin-biased cropping (reference ``:122-246``)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5,
                 do_flip=False, seed=None):
        super().__init__(crop_size, min_scale, max_scale, do_flip, seed)
        self.spatial_aug_prob = 0.8
        self.eraser_aug_prob = 0.5

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        """Resize a sparse flow map by scattering the valid vectors onto
        the resized grid (reference ``:161-193``)."""
        from raft_tpu_torch import native
        if native.available():   # C++ scatter (identical semantics)
            return native.resize_sparse_flow(flow, valid, fx, fy)
        ht, wd = flow.shape[:2]
        coords = np.meshgrid(np.arange(wd), np.arange(ht))
        coords = np.stack(coords, axis=-1).astype(np.float32)

        coords = coords.reshape(-1, 2)
        flow = flow.reshape(-1, 2)
        valid = valid.reshape(-1).astype(bool)

        coords0 = coords[valid]
        flow0 = flow[valid]

        ht1 = int(round(ht * fy))
        wd1 = int(round(wd * fx))

        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]

        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)

        v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
        xx, yy, flow1 = xx[v], yy[v], flow1[v]

        flow_img = np.zeros((ht1, wd1, 2), dtype=np.float32)
        valid_img = np.zeros((ht1, wd1), dtype=np.int32)
        flow_img[yy, xx] = flow1
        valid_img[yy, xx] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid):
        """No stretch; clip scale; margin-biased crop (reference
        ``:195-237``)."""
        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 1) / float(ht),
                        (self.crop_size[1] + 1) / float(wd))
        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        scale_x = np.clip(scale, min_scale, None)
        scale_y = np.clip(scale, min_scale, None)

        if self.rng.random() < self.spatial_aug_prob:
            img1 = _resize(img1, scale_x, scale_y)
            img2 = _resize(img2, scale_x, scale_y)
            flow, valid = self.resize_sparse_flow_map(
                flow, valid, fx=scale_x, fy=scale_y)
        elif min_scale > 1.0:
            img1 = _resize(img1, min_scale, min_scale)
            img2 = _resize(img2, min_scale, min_scale)
            flow, valid = self.resize_sparse_flow_map(
                flow, valid, fx=min_scale, fy=min_scale)

        if self.do_flip and self.rng.random() < 0.5:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]

        # Margin-biased crop (reference :220-227): margins 20 (y), 50 (x).
        margin_y, margin_x = 20, 50
        y0 = int(self.rng.integers(0, img1.shape[0] - self.crop_size[0]
                                   + margin_y))
        x0 = int(self.rng.integers(-margin_x,
                                   img1.shape[1] - self.crop_size[1]
                                   + margin_x))
        y0 = int(np.clip(y0, 0, img1.shape[0] - self.crop_size[0]))
        x0 = int(np.clip(x0, 0, img1.shape[1] - self.crop_size[1]))
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl], valid[sl]

    def __call__(self, img1, img2, flow, valid):
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, np.ascontiguousarray(img2))
        img1, img2, flow, valid = self.spatial_transform(
            img1, img2, flow, valid)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), np.ascontiguousarray(valid))
