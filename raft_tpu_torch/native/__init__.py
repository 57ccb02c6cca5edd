"""Native (C++) host kernels of the data layer, the counterpart of
``raft_tpu/native/__init__.py``: the augmentation pipeline's hot loops
(bilinear and nearest resize, photometric jitter, the eraser, the sparse
flow scatter) in a ``g++``-built shared library (``build.py``) driven
through ctypes, with numpy, cv2 or PIL in their place when the library
cannot be built (``available()`` says which). Every wrapper matches its
numpy or cv2 counterpart (``raft_tpu``'s ``tests/test_native_augment.py``
holds the same source to them).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        from raft_tpu_torch.native.build import build
        lib = ctypes.CDLL(build())
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.resize_bilinear_f32.argtypes = [f32p] + [ctypes.c_int] * 3 + \
            [f32p] + [ctypes.c_int] * 2 + [ctypes.c_double] * 2
        lib.resize_nearest_f32.argtypes = lib.resize_bilinear_f32.argtypes
        onechan = [f32p, ctypes.c_int, ctypes.c_float]
        lib.adjust_brightness_f32.argtypes = onechan
        lib.adjust_contrast_f32.argtypes = onechan
        lib.adjust_saturation_f32.argtypes = onechan
        lib.erase_rect_f32.argtypes = [f32p] + [ctypes.c_int] * 7 + [f32p]
        lib.resize_sparse_flow_f32.argtypes = [f32p, f32p, ctypes.c_int,
                                               ctypes.c_int,
                                               ctypes.c_double,
                                               ctypes.c_double, f32p, f32p,
                                               ctypes.c_int, ctypes.c_int]
    except (RuntimeError, OSError, AttributeError):
        # a build failure, or a library without the expected symbols:
        # the callers fall back to numpy, cv2 or PIL
        return None
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native library is built and loadable."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _as_f32c(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def resize_bilinear(img: np.ndarray, h2: int, w2: int,
                    fx: float = 0.0, fy: float = 0.0) -> np.ndarray:
    """cv2-INTER_LINEAR-semantics resize of an HWC float image. Pass the
    caller's ``fx``/``fy`` when resizing by scale factors — cv2 uses the
    exact factors for coordinate mapping, which differs from the h2/w2
    size ratio at non-round scales."""
    lib = _load()
    assert lib is not None
    squeeze = img.ndim == 2
    img = _as_f32c(img if img.ndim == 3 else img[..., None])
    h, w, c = img.shape
    out = np.empty((h2, w2, c), np.float32)
    lib.resize_bilinear_f32(_ptr(img), h, w, c, _ptr(out), h2, w2,
                            1.0 / fx if fx else 0.0,
                            1.0 / fy if fy else 0.0)
    return out[..., 0] if squeeze else out


def resize_nearest(img: np.ndarray, h2: int, w2: int,
                   fx: float = 0.0, fy: float = 0.0) -> np.ndarray:
    lib = _load()
    assert lib is not None
    squeeze = img.ndim == 2
    img = _as_f32c(img if img.ndim == 3 else img[..., None])
    h, w, c = img.shape
    out = np.empty((h2, w2, c), np.float32)
    lib.resize_nearest_f32(_ptr(img), h, w, c, _ptr(out), h2, w2,
                           1.0 / fx if fx else 0.0,
                           1.0 / fy if fy else 0.0)
    return out[..., 0] if squeeze else out


def _photometric_op(name: str, img: np.ndarray, f: float,
                    inplace: bool) -> np.ndarray:
    lib = _load()
    assert lib is not None
    out = img if (inplace and img.dtype == np.float32
                  and img.flags.c_contiguous) else \
        np.array(img, dtype=np.float32, order="C", copy=True)
    getattr(lib, name)(_ptr(out), out.shape[0] * out.shape[1], float(f))
    return out


def adjust_brightness(img: np.ndarray, f: float,
                      inplace: bool = False) -> np.ndarray:
    """torchvision-factor brightness, clipped to [0, 255] (RGB HWC)."""
    return _photometric_op("adjust_brightness_f32", img, f, inplace)


def adjust_contrast(img: np.ndarray, f: float,
                    inplace: bool = False) -> np.ndarray:
    """Blend toward the scalar mean gray (torchvision semantics)."""
    return _photometric_op("adjust_contrast_f32", img, f, inplace)


def adjust_saturation(img: np.ndarray, f: float,
                      inplace: bool = False) -> np.ndarray:
    """Blend toward per-pixel gray (torchvision semantics)."""
    return _photometric_op("adjust_saturation_f32", img, f, inplace)


def erase_rect(img: np.ndarray, y0: int, x0: int, dy: int, dx: int,
               fill: np.ndarray, inplace: bool = False) -> np.ndarray:
    lib = _load()
    assert lib is not None
    out = img if (inplace and img.dtype == np.float32
                  and img.flags.c_contiguous) else _as_f32c(img).copy()
    h, w, c = out.shape
    fill = _as_f32c(fill).reshape(-1)
    lib.erase_rect_f32(_ptr(out), h, w, c, int(y0), int(x0), int(dy),
                       int(dx), _ptr(fill))
    return out


def resize_sparse_flow(flow: np.ndarray, valid: np.ndarray,
                       fx: float, fy: float
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Scatter-resize a sparse flow map (reference
    ``core/utils/augmentor.py:161-193`` semantics)."""
    lib = _load()
    assert lib is not None
    flow = _as_f32c(flow)
    validf = _as_f32c(valid.astype(np.float32))
    h, w = validf.shape[:2]
    h2, w2 = int(round(h * fy)), int(round(w * fx))
    flow_out = np.zeros((h2, w2, 2), np.float32)
    valid_out = np.zeros((h2, w2), np.float32)
    lib.resize_sparse_flow_f32(_ptr(flow), _ptr(validf), h, w,
                               float(fx), float(fy), _ptr(flow_out),
                               _ptr(valid_out), h2, w2)
    return flow_out, valid_out.astype(np.int32)
