"""In-process NSL STEREO driver binding (libnslstereo via ctypes).

The reference's driver (src/rcv/stereo/stereo.c + src/sdrrcv.c) calls
``STEREO_InitLibrary``/``STEREO_IsConnected`` at init (stereo_init
:29-46), ``STEREO_GrabInit``/``STEREO_GrabStart`` to arm the USB grabber
(sdrrcv.c:55, :299), then loops ``STEREO_RefillDataBuffer`` — each call
fills the library-exported ``STEREO_dataBuffer`` with one
STEREO_PKT_SIZE packet that stereo_pushtomembuf copies into the global
ring (stereo.c:235-247).  A negative refill return is a USB overrun and
stops the receiver (sdrrcv.c:330-334).

This binding reproduces that contract in-process through ctypes: a
grabber thread refills and lands each packet in a
:class:`~gnsslib_tpu_torch.io.live.SampleRing`.  Both STEREO RF paths share
one byte stream (FE1 2-bit real in bits 7-6, FE2 dual 3-bit I/Q in bits
5-0, stereo.c:160-205): :meth:`fe2` returns a
:class:`~gnsslib_tpu_torch.io.live.RingView` decoding the second path from
the same ring for dual-frontend receivers.

The vendor library is located from ``GNSSLIB_STEREO_LIB``, then
``ctypes.util.find_library("nslstereo")``, then the conventional
sonames.  Tests exercise the binding against a mock libnslstereo built
from ``tools/mock_stereo.c`` (no USB hardware in CI).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import os
import threading

import numpy as np

from ..constants import DType
from .frontend import FrontendSpec, _bytes_per_sample
from .live import LiveFrontend, RingView, SampleRing, ring_read


def _load_library(path: str | None = None) -> ctypes.CDLL:
    cands = [path, os.environ.get("GNSSLIB_STEREO_LIB"),
             ctypes.util.find_library("nslstereo"),
             "libnslstereo.so.1", "libnslstereo.so"]
    err = None
    for c in cands:
        if not c:
            continue
        try:
            return ctypes.CDLL(c)
        except OSError as e:
            err = e
    raise OSError(f"libnslstereo not found ({err}); install the vendor "
                  "library, point GNSSLIB_STEREO_LIB at it, or capture "
                  "externally and use StreamFrontend/FileFrontend")


class StereoFrontend(LiveFrontend):
    """Live NSL STEREO capture through libnslstereo.

    ``spec`` describes RF path 1 (max2769, 2-bit real); pass the FE2
    spec (max2112, I/Q) to :meth:`fe2` for the second path.  The board's
    register programming (firmware/FPGA/synth/ADC images selected by
    carrier frequency, stereo_initconf :119-154) happens out-of-band via
    the vendor's stereo_app; the binding drives the capture contract.
    """

    def __init__(self, spec: FrontendSpec, lib: str | None = None,
                 ring_bytes: int = 256 << 20, timeout_s: float = 30.0):
        super().__init__(spec)
        self.bps = _bytes_per_sample(spec)          # 1 (both FEs packed)
        self.ring = SampleRing(ring_bytes)
        self.timeout_s = timeout_s
        self._lib = lb = _load_library(lib)
        if lb.STEREO_InitLibrary() != 0:
            raise OSError("STEREO_InitLibrary failed (stereo.c:33-36)")
        if not lb.STEREO_IsConnected():
            lb.STEREO_QuitLibrary()
            raise OSError("STEREO does not appear to be connected "
                          "(stereo.c:38-40)")
        self.pkt_size = ctypes.c_uint32.in_dll(lb, "STEREO_PKT_SIZE").value
        self._databuf = (ctypes.c_uint8 * self.pkt_size).in_dll(
            lb, "STEREO_dataBuffer")
        if lb.STEREO_GrabInit() != 0:
            lb.STEREO_QuitLibrary()
            raise OSError("STEREO_GrabInit failed (sdrrcv.c:55-58)")
        if lb.STEREO_GrabStart() != 0:
            lb.STEREO_QuitLibrary()
            raise OSError("STEREO_GrabStart failed (sdrrcv.c:299-302)")
        self.usb_overrun = False
        self._closed = False
        self._thread = threading.Thread(target=self._grab, daemon=True)
        self._thread.start()

    def _grab(self) -> None:
        # rcvgrabdata loop: refill -> push packet (sdrrcv.c:325-336)
        while not self._closed:
            if self._lib.STEREO_RefillDataBuffer() < 0:
                # USB overrun is fatal in the reference (stopflag)
                self.usb_overrun = True
                break
            self.ring.write(bytes(self._databuf))
        self.ring.mark_eof()

    def fe2(self, spec: FrontendSpec | None = None) -> RingView:
        """RF path 2 view (max2112 I/Q) over the same byte stream."""
        if spec is None:
            spec = dataclasses.replace(self.spec, ftype=2, dtype=DType.IQ)
        return RingView(self, spec)

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
        return ring_read(self.ring, self.spec, self.bps, start, n,
                         self.timeout_s)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._thread.join(timeout=10)
        # stereo_quit (stereo.c:52-61)
        self._lib.STEREO_GrabStop()
        self._lib.STEREO_GrabClean()
        self._lib.STEREO_QuitLibrary()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
