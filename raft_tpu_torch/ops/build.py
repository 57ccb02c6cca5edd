"""Build-on-first-use and binding of the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``build/raft_tpu_torch/``
at the repository root and loaded with ``ctypes``: no PyTorch headers, so a
build takes seconds. The library's file name carries a hash of its source,
the headers of ``csrc/`` and the flags, so an edited source or header is
never served by a stale build. Like
``raft_tpu/native/build.py`` the compiler writes to a temporary file that is
renamed into place, and a failed build raises with the compiler's output.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "raft_tpu_torch")
KERNELS = ("corr_fwd", "corr_fwd_bf16", "corr_bwd", "sepconv_gru",
           "motion_fwd", "update_step", "msda_fwd", "msda_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default location, else ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def lib_path(name: str) -> str:
    """Where the library for ``csrc/<name>.cu`` lives once built: named by
    a hash of the source, every header in ``csrc/`` (a source may include
    any of them) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=KERNELS) -> dict:
    """Compile every named kernel that is not built yet, one ``nvcc`` each,
    all running at once. Returns ``{name: library path}``; raises
    ``RuntimeError`` with the compiler's output if any build fails. The
    compiler's report (registers, shared memory, spills) is kept beside
    each library as ``<library>.log``."""
    paths = {name: lib_path(name) for name in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    compiler = nvcc()
    jobs = []
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
            os.close(fd)
            cmd = [compiler, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, tmp, proc))
        failures = []
        for name, tmp, proc in jobs:
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                failures.append(f"--- {name}.cu (nvcc exit {proc.returncode})"
                                f"\n{log}")
                continue
            with open(paths[name] + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, paths[name])
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths


def bind(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``csrc/<name>.cu`` (built and loaded on
    first use) with its argument types set, returning a C int (the kernels
    return a ``cudaError_t``). Pointers must be ``ctypes.c_void_p``, or
    ctypes cuts them to 32 bits."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build((name,))[name])
        fn = getattr(_libs[name], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn


def check_operand(name: str, t, shape, device, dtype=None) -> None:
    """Raise ``ValueError`` unless ``t`` is a tensor of ``dtype`` (float32
    unless given: only the bf16 forms pass ``torch.bfloat16``) and
    ``shape``, contiguous, 16-byte aligned (the kernels load 16 bytes at a
    time) and on ``device``."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
