"""Build and load the package's CUDA kernels.

The sources under ``horovod_tpu_torch/csrc/`` (every ``*.cu``) are compiled
by ``nvcc``, one process per source, all started together, then linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
build runs on first use, never at import, goes into
``horovod_tpu_torch/_build/`` and is keyed on a hash of every file under
``csrc/`` (sources and the ``*.cuh`` headers they include) and the flags, so
an edited source or header builds anew and an unchanged tree is reused.
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
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_QKV_ARGS = [_I] * 14 + [_F, _P]   # B, S, H, D, 9 strides, causal; scale; stream
# x, mu, var, gamma, beta, w, y, s, ws; M, Cin, Cout; eps; stream
_BN_CONV_ARGS = [_P] * 9 + [_I] * 3 + [_F, _P]
ARGTYPES = {
    "hvd_flash_fwd": [_P] * 6 + _QKV_ARGS,
    "hvd_flash_bwd_dkdv": [_P] * 9 + _QKV_ARGS,
    "hvd_flash_bwd_dq": [_P] * 8 + _QKV_ARGS,
    "hvd_fused_bn_conv_scratch": _BN_CONV_ARGS,
    "hvd_fused_bn_conv_revisit": _BN_CONV_ARGS,
    "hvd_fused_bn_conv_scratch_parts": [_I, _I],   # M, Cout -> partitions
    "hvd_fused_bn_conv_revisit_parts": [_I, _I],
    "hvd_fused_bn_conv_revisit_tile_n": [],        # -> K4's Cout tile
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
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
        "kernels are built from horovod_tpu_torch/csrc at first CUDA use")


def sources() -> list:
    """The translation units: every ``*.cu`` under ``CSRC``."""
    return sorted(CSRC.glob("*.cu"))


def hashed_files() -> list:
    """Every file the build reads: the sources and the headers they include."""
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def _key() -> str:
    h = hashlib.sha256()
    for path in hashed_files():
        h.update(path.name.encode())
        h.update(path.read_bytes())
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
            objs.append(obj)
        outputs = [proc.communicate() for _, proc in procs]   # wait for every compiler
        for (cmd, proc), (stdout, stderr) in zip(procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{stdout}\n{stderr}")
        ptxas = [stderr for _, stderr in outputs]
        tmp = os.path.join(work, "lib.so")
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False, ptxas="".join(ptxas))
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
