"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library on first use, under ``build/gnsslib_tpu_torch/`` at
the root of the checkout.  The library file name carries a hash of the
source and the flags, so a stale build is never loaded.  Nothing is
built or imported from CUDA when this module is imported.
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

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "gnsslib_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# name -> (seconds, compiler output) of the build this process ran
build_info: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, building it if no
    build of the current source exists."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        path = library_path(name)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.time()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                     str(CSRC / f"{name}.cu")],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {name}.cu:\n{proc.stderr}")
                os.replace(tmp, path)            # atomic: no half-built .so
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            build_info[name] = (time.time() - t0,
                                proc.stdout + proc.stderr)
        _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]
