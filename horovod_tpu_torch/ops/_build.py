"""Build and load the package's CUDA kernels.

The sources under ``horovod_tpu_torch/csrc/`` are compiled by ``nvcc`` into
one shared library with a plain C interface, loaded with ``ctypes``. The
build runs on first use, never at import, goes into
``horovod_tpu_torch/_build/`` and is keyed on a hash of the sources and the
flags, so an edited source builds anew and an unchanged one is reused.
A missing ``nvcc`` or a failed build raises: there is no other path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "flash_attention.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_QKV_ARGS = [_I] * 14 + [_F, _P]   # B, S, H, D, 9 strides, causal; scale; stream
ARGTYPES = {
    "hvd_flash_fwd": [_P] * 6 + _QKV_ARGS,
    "hvd_flash_bwd_dkdv": [_P] * 9 + _QKV_ARGS,
    "hvd_flash_bwd_dq": [_P] * 8 + _QKV_ARGS,
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the flash-attention "
        "kernels are built from horovod_tpu_torch/csrc at first CUDA use")


def _key() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless a library for this hash exists; returns
    its path and records ``build_info`` (path, seconds, cached, ptxas)."""
    out = BUILD_DIR / f"libhvd_kernels_{_key()}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True, ptxas="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False, ptxas=proc.stderr)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
