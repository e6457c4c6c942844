"""File front-end: random-access block reader with absolute sample index.

Replaces the reference's grabber-thread + 327 MB ring buffer
(src/sdrrcv.c:194-226, 469-531) with direct seeked reads — the absolute
sample index (the reference's ``buffcnt*fendbuffsize`` global clock,
src/sdr.h:328) is preserved as the receiver timebase.  Real-time pacing
(sleepms(5) per 64 KB push, sdrrcv.c:389-390) is a replay artifact and is
dropped; the TPU receiver is throughput-bound, not wall-clock-paced.
"""
from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np

from ..constants import DType, FrontendType
from . import formats


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    """One RF path of a front end (reference sdrini fields FEND/CF/SF/IF/
    DTYPE, src/sdrinit.c:125-158)."""
    fend: int                 # FrontendType
    f_cf: float               # carrier frequency (Hz)
    f_sf: float               # sampling frequency (Hz)
    f_if: float               # intermediate frequency (Hz)
    dtype: int                # DType.REAL / DType.IQ
    ftype: int = 1            # 1 or 2 (STEREO FE selection)
    ppmerr: float = 0.0       # clock error; foffset = +ppmerr*1e-6*f_cf,
                              # the reference's sign convention
                              # (src/sdrinit.c:617: f_cf*rtlsdrppmerr*1e-6)

    @property
    def foffset(self) -> float:
        return self.ppmerr * 1e-6 * self.f_cf


# bytes consumed per output sample for each (fend, dtype, ftype)
def _bytes_per_sample(spec: FrontendSpec) -> int:
    f = spec.fend
    if f in (FrontendType.FILE,):
        return 2 if spec.dtype == DType.IQ else 1
    if f in (FrontendType.RTLSDR, FrontendType.FRTLSDR):
        return 2                       # u8 I + u8 Q
    if f in (FrontendType.GN3SV2, FrontendType.FGN3SV2):
        return 2                       # one byte per I/Q component
    if f in (FrontendType.GN3SV3, FrontendType.FGN3SV3):
        return 1                       # 2-bit real or 4-bit IQ: 1 byte
    if f in (FrontendType.STEREO, FrontendType.FSTEREO):
        return 1                       # both FEs packed in one byte
    if f in (FrontendType.BLADERF, FrontendType.FBLADERF):
        return 4                       # SC16 pairs
    raise ValueError(f"unknown front end {f}")


def _unpack(spec: FrontendSpec, raw: bytes) -> np.ndarray:
    f = spec.fend
    if f == FrontendType.FILE:
        return formats.unpack_int8(raw, spec.dtype == DType.IQ)
    if f in (FrontendType.RTLSDR, FrontendType.FRTLSDR):
        return formats.unpack_rtlsdr(raw)
    if f in (FrontendType.GN3SV2, FrontendType.FGN3SV2):
        return formats.unpack_gn3s_v2_aligned(raw)
    if f in (FrontendType.GN3SV3, FrontendType.FGN3SV3):
        if spec.dtype == DType.IQ:
            return formats.unpack_gn3s_v3_4bit(raw)
        return formats.unpack_gn3s_v3_2bit(raw)
    if f in (FrontendType.STEREO, FrontendType.FSTEREO):
        if spec.ftype == 2:
            return formats.unpack_stereo_fe2(raw)
        return formats.unpack_stereo_fe1(raw)
    if f in (FrontendType.BLADERF, FrontendType.FBLADERF):
        return formats.unpack_bladerf(raw)
    raise ValueError(f"unknown front end {f}")


class FileFrontend:
    """Seekable IF sample source for one RF path.

    ``read(start, n)`` returns float32 samples (n,) or (n, 2) for I/Q —
    the rcvgetbuff contract (src/sdrrcv.c:406-467) without the ring.
    """

    def __init__(self, path: str, spec: FrontendSpec):
        self.path = path
        self.spec = spec
        self.bps = _bytes_per_sample(spec)
        self._fp = open(path, "rb")
        # the device cache's prefetch worker reads concurrently with the
        # receiver's acquisition reads; seek+read must be atomic per call
        self._lock = threading.Lock()
        self.nbytes = os.fstat(self._fp.fileno()).st_size
        self._byte0 = 0
        if spec.fend in (FrontendType.GN3SV2, FrontendType.FGN3SV2):
            # v2 packet-shift realignment (gn3s.cpp:95-109) resolved ONCE
            # at stream start: a global one-byte offset keeps arbitrary
            # block reads seam-free (per-read detection would reinterpret
            # bit 1 of whatever byte a read lands on)
            head = self._fp.read(1)
            if head and (head[0] & 0x02) != 2:
                self._byte0 = 1
        self.nsamples = (self.nbytes - self._byte0) // self.bps

    def close(self) -> None:
        self._fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read(self, start: int, n: int) -> np.ndarray:
        """Samples [start, start+n); short reads are zero-padded at EOF
        (the reference stops instead, sdrrcv.c:486-490 — the receiver
        driver checks ``eof_at`` to stop cleanly)."""
        if start < 0:
            raise ValueError("negative sample index")
        with self._lock:
            self._fp.seek(self._byte0 + start * self.bps)
            raw = self._fp.read(n * self.bps)
        got = len(raw) // self.bps
        x = _unpack(self.spec, raw[:got * self.bps])
        if got < n:
            pad = np.zeros((n - got,) + x.shape[1:], np.float32)
            x = np.concatenate([x, pad], axis=0)
        return x

    def read_narrow(self, start: int, n: int) -> np.ndarray:
        """Like :meth:`read` but, for plain int8 FILE streams, returns the
        raw int8 samples without the float32 round-trip — the device
        block cache (io/devcache.py) ships these bytes as-is, so skipping
        the 4x-larger float materialization saves host time and memory on
        every segment upload.  Other formats fall back to ``read``."""
        if self.spec.fend == FrontendType.FILE:
            with self._lock:
                self._fp.seek(self._byte0 + start * self.bps)
                raw = np.frombuffer(self._fp.read(n * self.bps), np.int8)
            got = len(raw) // self.bps
            x = raw[:got * self.bps]
            if self.spec.dtype == DType.IQ:
                x = x.reshape(-1, 2)
            if got < n:
                x = np.concatenate(
                    [x, np.zeros((n - got,) + x.shape[1:], np.int8)])
            return x
        return self.read(start, n)

    @property
    def eof_at(self) -> int:
        return self.nsamples
