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
import re
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
# name -> (seconds since its build batch started, compiler output) of
# the builds this process ran
build_info: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME)")


_INCLUDE = re.compile(r'^#include "([\w.]+\.cuh)"$', re.M)


def source(name: str) -> str:
    """``csrc/<name>.cu`` with each ``#include "<header>.cuh"`` of ``csrc/``
    replaced by the header's text: what nvcc compiles, in one string (the
    build hashes it; the profilers' source variants edit it)."""
    return _INCLUDE.sub(lambda m: (CSRC / m[1]).read_text(),
                        (CSRC / f"{name}.cu").read_text())


def library_path(name: str) -> Path:
    src = source(name).encode()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def _build(names) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` that has no build of
    its current source, one nvcc process each, all started together;
    raises after all have ended if any failed.  Holds ``_lock``."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    t0 = time.time()
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for name, (tmp, proc) in jobs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{err}")
                continue
            os.replace(tmp, library_path(name))   # atomic: no half-built .so
            build_info[name] = (time.time() - t0, out + err)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for tmp, proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, building it if no
    build of the current source exists."""
    with _lock:
        if name not in _loaded:
            _build([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]


def build_all(names) -> None:
    """Build the libraries of ``names`` that are not built yet, all nvcc
    processes in parallel (set-up time); :func:`load` then only loads."""
    with _lock:
        _build([n for n in names if n not in _loaded])
