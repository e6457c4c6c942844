"""Native host kernels (C++ through ctypes) with pure-Python fallbacks
(the port's copy of the JAX package's ``native`` module).

The reference links native code for its host hot paths: ka9q-fec's
Viterbi (SBAS), RTKLIB's CRCs and the front-end drivers' sample
expansion loops.  ``gnsslib_native.cpp`` holds the equivalents; g++
builds it on first use, one translation unit, into
``build/gnsslib_tpu_torch/`` at the root of the checkout, under a file
name that carries a hash of the source and the flags (as
:mod:`gnsslib_tpu_torch.cuda_build` names the kernels' libraries), so a
stale build is never loaded.  The decoders have the signature and the
output of their pure-Python versions (``nav/viterbi.py``,
``nav/bits.py``), which they fall back to when no compiler is present;
:func:`available` says which one runs.  The sample expanders' outputs
equal ``io/formats.py``'s (``_lib``, through ctypes).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "gnsslib_native.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
# the sample expanders (the float32 outputs per input byte: 1 or 2),
# entry points of the library as in the JAX package's copy
UNPACKERS = {"unpack_rtlsdr": 1, "unpack_gn3s_v3_2bit": 1,
             "unpack_gn3s_v3_4bit": 2, "unpack_stereo_fe1": 1,
             "unpack_stereo_fe2": 2}

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libgnsslib_native-{key[:16]}.so"


def ensure_built(force: bool = False) -> bool:
    """Compile the library if its build is missing and load it; returns
    whether it is available (False when g++ is absent or fails)."""
    global _lib, _tried
    with _lock:
        if _lib is not None and not force:
            return True
        if _tried and not force:
            return _lib is not None
        _tried = True
        path = library_path()
        if force or not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, path)       # atomic beside other builders
            except (OSError, subprocess.SubprocessError):
                return False
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return False
        lib.v27_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.crc24q.restype = ctypes.c_uint32
        lib.crc24q.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        for name in UNPACKERS:
            getattr(lib, name).argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return True


def available() -> bool:
    return ensure_built()


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def viterbi27_decode(symbols, nbits: int):
    """Native soft Viterbi27 (equal-metric start); falls back to
    nav.viterbi.viterbi27_decode."""
    if not ensure_built():
        from ..nav.viterbi import viterbi27_decode as py
        return py(symbols, nbits)
    sym = np.ascontiguousarray(np.asarray(symbols), dtype=np.uint8)
    nsteps = len(sym) // 2
    out = np.empty(nbits, np.uint8)
    _lib.v27_decode(_u8ptr(sym), nsteps, nbits, _u8ptr(out))
    return out


def crc24q_native(data) -> int:
    """CRC-24Q of ``data``; falls back to nav.bits.crc24q."""
    if not ensure_built():
        from ..nav.bits import crc24q as py
        return py(data)
    buf = np.frombuffer(bytes(bytearray(data)), dtype=np.uint8)
    return int(_lib.crc24q(_u8ptr(np.ascontiguousarray(buf)), len(buf)))

