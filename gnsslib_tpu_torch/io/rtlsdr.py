"""In-process RTL-SDR driver binding (librtlsdr via ctypes).

The reference's driver (src/rcv/rtlsdr/rtlsdr.c) opens the dongle,
programs sample rate / center frequency / auto gain / ppm correction
(rtlsdr_initconf :68-100), resets the endpoint, and runs
``rtlsdr_read_async`` whose callback pushes each USB transfer into the
global ring buffer (:13-26, :107-127).  This binding reproduces that
contract in-process through ctypes — no compiled extension needed — with
the transfers landing in a :class:`~gnsslib_tpu_torch.io.live.SampleRing`
addressed by the absolute sample counter.

The vendor library is located from ``GNSSLIB_RTLSDR_LIB``, then
``ctypes.util.find_library("rtlsdr")``, then the conventional sonames.
Tests exercise the full binding against a mock librtlsdr built from
``tools/mock_rtlsdr.c`` (no USB hardware in CI).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading

import numpy as np

from ..constants import DType, FrontendType
from .frontend import FrontendSpec, _bytes_per_sample, _unpack
from .live import LiveFrontend, SampleRing

# reference transfer geometry (src/rcv/rtlsdr/rtl-sdr.h:33-36)
RTLSDR_DATABUFF_SIZE = 16384
RTLSDR_ASYNC_BUF_NUMBER = 15

_READ_CB = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_ubyte),
                            ctypes.c_uint32, ctypes.c_void_p)


def _load_library(path: str | None = None) -> ctypes.CDLL:
    cands = [path, os.environ.get("GNSSLIB_RTLSDR_LIB"),
             ctypes.util.find_library("rtlsdr"),
             "librtlsdr.so.0", "librtlsdr.so"]
    err = None
    for c in cands:
        if not c:
            continue
        try:
            return ctypes.CDLL(c)
        except OSError as e:
            err = e
    raise OSError(f"librtlsdr not found ({err}); install the vendor "
                  "library, point GNSSLIB_RTLSDR_LIB at it, or capture "
                  "with the rtl_sdr CLI and use ProcessFrontend")


class RtlSdrFrontend(LiveFrontend):
    """Live RTL-SDR capture through librtlsdr (u8 I/Q -> float32 I/Q).

    Parameters mirror what the reference programs from its INI
    (rtlsdr_initconf): rate/frequency from the spec, ppm from
    ``spec.ppmerr``, automatic tuner gain unless ``gain`` (dB) is given.
    """

    def __init__(self, spec: FrontendSpec, device: int = 0,
                 gain: float | None = None, lib: str | None = None,
                 ring_bytes: int = 64 << 20, timeout_s: float = 30.0):
        if spec.dtype != DType.IQ:
            raise ValueError("RTL-SDR streams are I/Q (DTYPE=2)")
        super().__init__(spec)
        self.bps = _bytes_per_sample(spec)          # 2 (u8 I + u8 Q)
        self.ring = SampleRing(ring_bytes)
        self.timeout_s = timeout_s
        self._lib = _load_library(lib)
        self._dev = ctypes.c_void_p()
        self._check("rtlsdr_open",
                    self._lib.rtlsdr_open(ctypes.byref(self._dev), device))
        try:
            # configuration order per rtlsdr_initconf (rtlsdr.c:68-100)
            self._check("set_sample_rate",
                        self._lib.rtlsdr_set_sample_rate(
                            self._dev, ctypes.c_uint32(int(spec.f_sf))))
            self._check("set_center_freq",
                        self._lib.rtlsdr_set_center_freq(
                            self._dev, ctypes.c_uint32(int(spec.f_cf))))
            if gain is None:
                self._check("set_tuner_gain_mode(auto)",
                            self._lib.rtlsdr_set_tuner_gain_mode(
                                self._dev, 0))
            else:
                self._check("set_tuner_gain_mode(manual)",
                            self._lib.rtlsdr_set_tuner_gain_mode(
                                self._dev, 1))
                self._check("set_tuner_gain",
                            self._lib.rtlsdr_set_tuner_gain(
                                self._dev, int(round(gain * 10))))
            if spec.ppmerr:
                self._check("set_freq_correction",
                            self._lib.rtlsdr_set_freq_correction(
                                self._dev, int(round(spec.ppmerr))))
            # mandatory endpoint reset before reading (rtlsdr.c:110-115)
            self._check("reset_buffer",
                        self._lib.rtlsdr_reset_buffer(self._dev))
        except Exception:
            self._lib.rtlsdr_close(self._dev)
            raise
        # async grabber: callback -> ring (rtlsdr.c:13-26, :118-120)
        self._cb = _READ_CB(self._on_transfer)      # keep a reference!
        self._thread = threading.Thread(target=self._grab, daemon=True)
        self._closed = False
        self._thread.start()

    @staticmethod
    def _check(what: str, ret: int) -> None:
        if ret < 0:
            raise OSError(f"rtlsdr {what} failed ({ret})")

    def _on_transfer(self, buf, length, _ctx) -> None:
        self.ring.write(ctypes.string_at(buf, length))

    def _grab(self) -> None:
        self._lib.rtlsdr_read_async(self._dev, self._cb, None,
                                    RTLSDR_ASYNC_BUF_NUMBER,
                                    2 * RTLSDR_DATABUFF_SIZE)
        self.ring.mark_eof()

    # -- consumer API ------------------------------------------------------ #
    @property
    def eof(self) -> bool:
        return self.ring.eof

    @property
    def overruns(self) -> int:
        return self.ring.overruns

    @property
    def nsamples(self) -> int:
        return self.ring.produced // self.bps

    def read(self, start: int, n: int) -> np.ndarray:
        raw = self.ring.read_span(start * self.bps, (start + n) * self.bps,
                                  self.timeout_s)
        got = len(raw) // self.bps
        x = _unpack(self.spec, raw[:got * self.bps])
        if got < n:
            pad = np.zeros((n - got,) + x.shape[1:], np.float32)
            x = np.concatenate([x, pad], axis=0)
        return x

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._lib.rtlsdr_cancel_async(self._dev)
        self._thread.join(timeout=10)
        self._lib.rtlsdr_close(self._dev)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
