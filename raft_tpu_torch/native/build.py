"""Build-on-first-use of the data layer's host library, the counterpart of
``raft_tpu/native/build.py``: ``augment.cpp`` compiled by ``g++`` into a
shared library in the port's build directory (``build/raft_tpu_torch/`` at
the repository root, where ``ops/build.py`` puts the CUDA kernels), named
by a hash of the source and the flags, so an edited source is never served
by a stale build. The compiler writes to a temporary file that is renamed
into place (another process may race the build). Nothing here runs at
import time, and nothing imports torch: the loader's worker processes
load this library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

from raft_tpu_torch.ops.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "augment.cpp")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def lib_path() -> str:
    """Where the library lives once built."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(" ".join(FLAGS).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR,
                        f"libraft_augment-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile ``augment.cpp`` unless it is built already; returns the
    library's path. Raises ``RuntimeError`` when the compiler cannot run or
    fails (``native._load`` then falls back to numpy, cv2 or PIL)."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed:\n{proc.stderr}")
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native build failed to launch: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
