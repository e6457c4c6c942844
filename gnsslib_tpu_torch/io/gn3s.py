"""In-process SiGe GN3S v2/v3 driver binding (libusb-1.0 via ctypes).

The reference drives the GN3S's Cypress FX2 directly over libusb
(src/rcv/gn3s/gn3s.cpp + fx2.cpp): find the dongle by VID 0x1781 and
PID 0x0b39 (v2) / 0x0b3a / 0x0b3f (v3) (fx2.cpp:74-97, gn3s.cpp:24-53),
claim RX interface 2 alt 0 (fx2.cpp:230-270), program it with FX2
vendor requests — v2: XFER on; v3: AGC off, CMODE wide, XFER cycle,
FLAGS read-back, CMODE GN3S_MODE, XFER on (gn3s.cpp:55-70) — then loop:
``check_rx_overrun`` (vendor-IN GET_STATUS, wIndex GS_RX_OVERRUN,
fx2.cpp:526-541) and a 16 kB bulk read from endpoint 0x86 into the
global ring (gn3s_pushtomembuf, gn3s.cpp:204-227).  An overrun is fatal
(sdrrcv.c:344-348).

This binding reproduces that contract in-process through ctypes on
libusb-1.0, landing each bulk transfer in a
:class:`~gnsslib_tpu_torch.io.live.SampleRing`.  The v2 packet-shift (bit 1
of the first byte, gn3s.cpp:95-109) is resolved ONCE at stream start
as a global one-byte offset — identical to the file front-end — so
arbitrary block reads stay seam-free.

The library is located from ``GNSSLIB_LIBUSB``, then
``ctypes.util.find_library("usb-1.0")``, then the conventional sonames.
Tests exercise the binding against a mock libusb built from
``tools/mock_gn3s_usb.c`` (no USB hardware in CI).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading

import numpy as np

from ..constants import FrontendType
from .frontend import FrontendSpec, _bytes_per_sample
from .live import LiveFrontend, SampleRing, ring_read

# FX2 protocol constants (fx2.h:13-38, gn3s.h:7-19)
GN3S_VID = 0x1781
GN3S_PIDS = ((0x0B39, 2), (0x0B3A, 3), (0x0B3F, 3))
RX_ENDPOINT = 0x86
RX_INTERFACE = 2
RX_ALTINTERFACE = 0
VRT_VENDOR_IN = 0xC0
VRT_VENDOR_OUT = 0x40
VRQ_XFER = 0x01
VRQ_AGC = 0x08
VRQ_CMODE = 0x0F
VRQ_GET_STATUS = 0x80
VRQ_FLAGS = 0x90
GS_RX_OVERRUN = 1
MODE_NARROW_16_I = 32          # GN3S_MODE: 16.368 Msps, IF 4.092, 2bit I
MODE_WIDE_16_I = 132
GN3S_BUFFSIZE = 32 * 512       # 16 kB bulk reads (gn3s.h:19)


def _load_library(path: str | None = None) -> ctypes.CDLL:
    cands = [path, os.environ.get("GNSSLIB_LIBUSB"),
             ctypes.util.find_library("usb-1.0"),
             "libusb-1.0.so.0", "libusb-1.0.so"]
    err = None
    for c in cands:
        if not c:
            continue
        try:
            return ctypes.CDLL(c)
        except OSError as e:
            err = e
    raise OSError(f"libusb-1.0 not found ({err}); install it, point "
                  "GNSSLIB_LIBUSB at it, or capture externally and use "
                  "StreamFrontend/FileFrontend")


class Gn3sFrontend(LiveFrontend):
    """Live SiGe GN3S capture through libusb-1.0 (FX2 bulk endpoint).

    ``spec.fend`` selects the hardware generation (GN3SV2 sign bits /
    GN3SV3 2-bit real or 4-bit I/Q) and must match the dongle found on
    the bus — the reference errors out on a mismatch (gn3s.cpp:26-52).
    """

    def __init__(self, spec: FrontendSpec, lib: str | None = None,
                 mode: int | None = None, ring_bytes: int = 64 << 20,
                 timeout_s: float = 30.0):
        if spec.fend not in (FrontendType.GN3SV2, FrontendType.GN3SV3):
            raise ValueError("spec.fend must be GN3SV2 or GN3SV3")
        super().__init__(spec)
        self.bps = _bytes_per_sample(spec)
        self.ring = SampleRing(ring_bytes)
        self.timeout_s = timeout_s
        self._lib = lb = _load_library(lib)
        lb.libusb_open_device_with_vid_pid.restype = ctypes.c_void_p
        self._ctx = ctypes.c_void_p()
        if lb.libusb_init(ctypes.byref(self._ctx)) != 0:
            raise OSError("libusb_init failed")
        self._h = None
        version = None
        for pid, ver in GN3S_PIDS:          # probe order of gn3s_init
            h = lb.libusb_open_device_with_vid_pid(self._ctx, GN3S_VID,
                                                   pid)
            if h:
                self._h = ctypes.c_void_p(h)
                version = ver
                break
        if self._h is None:
            lb.libusb_exit(self._ctx)
            raise OSError("no GN3S frontend found (VID 0x1781, "
                          "PID 0x0b39/0x0b3a/0x0b3f)")
        want = 2 if spec.fend == FrontendType.GN3SV2 else 3
        if version != want:
            self._usb_close()
            raise OSError(f"wrong frontend type, GN3SV{version} is found "
                          "(gn3s.cpp:26-52)")
        self.version = version
        try:
            # usb_fx2_init (fx2.cpp:230-270)
            self._check("claim_interface", lb.libusb_claim_interface(
                self._h, RX_INTERFACE))
            self._check("set_alt_setting",
                        lb.libusb_set_interface_alt_setting(
                            self._h, RX_INTERFACE, RX_ALTINTERFACE))
            if version == 2:
                self._xfer(VRQ_XFER, 1)      # gn3s.cpp:57
            else:                            # gn3s.cpp:60-69
                self._xfer(VRQ_AGC, 0)
                self._xfer(VRQ_CMODE, MODE_WIDE_16_I)
                self._xfer(VRQ_XFER, 0)
                self._xfer(VRQ_XFER, 1)
                flags = (ctypes.c_ubyte * 5)()
                self._ctrl(VRQ_FLAGS, 0, 0, flags, 5)
                self._xfer(VRQ_XFER, 0)
                self._xfer(VRQ_CMODE,
                           MODE_NARROW_16_I if mode is None else mode)
                self._xfer(VRQ_XFER, 1)
        except Exception:
            self._usb_close()
            raise
        self.usb_overrun = False
        self._byte0 = None                   # v2 shift, resolved at start
        self._closed = False
        self._thread = threading.Thread(target=self._grab, daemon=True)
        self._thread.start()

    # -- FX2 vendor requests ------------------------------------------------ #
    def _ctrl(self, request: int, value: int, index: int, buf, length: int
              ) -> int:
        # write_cmd: direction from bit 7 of the request (fx2.cpp:507-512)
        reqtype = VRT_VENDOR_IN if request & 0x80 else VRT_VENDOR_OUT
        return self._lib.libusb_control_transfer(
            self._h, reqtype, request, value, index, buf, length, 1000)

    def _xfer(self, request: int, value: int) -> None:
        if self._ctrl(request, value, 0, None, 0) < 0:
            raise OSError(f"gn3s vendor request {request:#x} failed")

    def _check(self, what: str, ret: int) -> None:
        if ret < 0:
            raise OSError(f"gn3s {what} failed ({ret})")

    def _rx_overrun(self) -> bool:
        status = (ctypes.c_ubyte * 1)()
        if self._ctrl(VRQ_GET_STATUS, 0, GS_RX_OVERRUN, status, 1) != 1:
            return True                      # fx2.cpp:526-533: trouble
        return bool(status[0])

    # -- grabber thread ------------------------------------------------------ #
    def _grab(self) -> None:
        buf = (ctypes.c_ubyte * GN3S_BUFFSIZE)()
        got = ctypes.c_int()
        while not self._closed:
            # gn3s_pushtomembuf (gn3s.cpp:204-227)
            if self._rx_overrun():
                self.usb_overrun = True      # fatal (sdrrcv.c:344-348)
                break
            r = self._lib.libusb_bulk_transfer(
                self._h, RX_ENDPOINT, buf, GN3S_BUFFSIZE,
                ctypes.byref(got), 1000)
            if r != 0 or got.value <= 0:
                break
            chunk = ctypes.string_at(buf, got.value)
            if self._byte0 is None:
                # v2 packet shift, once at stream start (gn3s.cpp:95-109)
                self._byte0 = (1 if self.spec.fend == FrontendType.GN3SV2
                               and (chunk[0] & 0x02) != 2 else 0)
            self.ring.write(chunk)
        self.ring.mark_eof()

    # -- consumer API -------------------------------------------------------- #
    @property
    def eof(self) -> bool:
        return self.ring.eof

    @property
    def overruns(self) -> int:
        return self.ring.overruns

    @property
    def nsamples(self) -> int:
        b0 = self._byte0 or 0
        return max(0, self.ring.produced - b0) // self.bps

    def _wait_byte0(self) -> int:
        """Block until the first transfer resolved the v2 packet shift
        (a read racing the very first bulk transfer must not guess)."""
        import time
        deadline = time.monotonic() + self.timeout_s
        while self._byte0 is None and not self.ring.eof:
            if time.monotonic() > deadline:
                break
            time.sleep(0.001)
        return self._byte0 or 0

    def read(self, start: int, n: int) -> np.ndarray:
        return ring_read(self.ring, self.spec, self.bps, start, n,
                         self.timeout_s, self._wait_byte0())

    def _usb_close(self) -> None:
        self._lib.libusb_close(self._h)
        self._lib.libusb_exit(self._ctx)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._thread.join(timeout=10)
        self._lib.libusb_release_interface(self._h, RX_INTERFACE)
        self._usb_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
