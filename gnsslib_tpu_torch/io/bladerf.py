"""In-process Nuand bladeRF driver binding (libbladeRF via ctypes).

The reference's driver (src/rcv/bladerf/bladerf.c) opens the board,
verifies/loads the FPGA (bladerf_init :54-106), programs frequency /
bandwidth (half the sample rate) / sample rate, initializes a 16-buffer
SC16 Q11 async stream (bladerf_initconf :121-161), and runs
``bladerf_stream`` whose callback masks each int16 to 12 bits and pushes
it into the global ring (stream_callback :19-48).  This binding
reproduces that contract in-process through ctypes: the stream callback
lands raw SC16 transfers in a :class:`~gnsslib_tpu_torch.io.live.SampleRing`
and the read path applies the same 12-bit mask + per-block DC removal
as the file-replay twin (io/formats.py unpack_bladerf).

The vendor library is located from ``GNSSLIB_BLADERF_LIB``, then
``ctypes.util.find_library("bladeRF")``, then the conventional sonames.
Tests exercise the binding against a mock libbladeRF built from
``tools/mock_bladerf.c`` (no USB hardware in CI).

ABI note: this binds the v1 libbladeRF API the reference bundles
(src/rcv/bladerf/libbladeRF.h, 2014) — ``bladerf_set_frequency`` takes a
uint32 and modules are the RX/TX enum.  libbladeRF 2.x widened frequency
to uint64 and renamed modules to channels; point GNSSLIB_BLADERF_LIB at
a v1 library (or adapt the ctypes signatures) for live hardware.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading

import numpy as np

from ..constants import DType
from .frontend import FrontendSpec, _bytes_per_sample
from .live import LiveFrontend, SampleRing, ring_read

# reference stream geometry (bladerf.c:153-154, libbladeRF.h:33)
BLADERF_DATABUFF_SIZE = 32768
BLADERF_NUM_BUFFERS = 16
BLADERF_NUM_TRANSFERS = 16
BLADERF_MODULE_RX = 0
BLADERF_FORMAT_SC16_Q11 = 0

# void *cb(struct bladerf*, struct bladerf_stream*, struct
#          bladerf_metadata*, void *samples, size_t n, void *user)
_STREAM_CB = ctypes.CFUNCTYPE(
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p)


def _load_library(path: str | None = None) -> ctypes.CDLL:
    cands = [path, os.environ.get("GNSSLIB_BLADERF_LIB"),
             ctypes.util.find_library("bladeRF"),
             "libbladeRF.so.2", "libbladeRF.so.1", "libbladeRF.so"]
    err = None
    for c in cands:
        if not c:
            continue
        try:
            return ctypes.CDLL(c)
        except OSError as e:
            err = e
    raise OSError(f"libbladeRF not found ({err}); install the vendor "
                  "library, point GNSSLIB_BLADERF_LIB at it, or capture "
                  "with bladeRF-cli and use ProcessFrontend")


class BladeRfFrontend(LiveFrontend):
    """Live bladeRF capture through libbladeRF (SC16 Q11 -> float32 I/Q).

    The configuration sequence mirrors bladerf_initconf
    (src/rcv/bladerf/bladerf.c:121-161): RX module, center frequency from
    the spec, bandwidth = f_sf/2, sample rate = f_sf, 16-buffer SC16 Q11
    async stream.  ``fpga`` optionally points at a hosted .rbf image to
    load when the FPGA is unconfigured (bladerf_init :73-97).
    """

    def __init__(self, spec: FrontendSpec, fpga: str | None = None,
                 lib: str | None = None, ring_bytes: int = 256 << 20,
                 timeout_s: float = 30.0):
        if spec.dtype != DType.IQ:
            raise ValueError("bladeRF streams are I/Q (DTYPE=2)")
        super().__init__(spec)
        self.bps = _bytes_per_sample(spec)          # 4 (int16 I + int16 Q)
        self.ring = SampleRing(ring_bytes)
        self.timeout_s = timeout_s
        self._lib = lb = _load_library(lib)
        lb.bladerf_strerror.restype = ctypes.c_char_p
        # three of its counts are size_t: undeclared, ctypes would pass
        # them as 32-bit ints with undefined upper halves
        lb.bladerf_init_stream.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, _STREAM_CB,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_void_p)), ctypes.c_size_t,
            ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p]
        self._dev = ctypes.c_void_p()
        self._check("open", lb.bladerf_open(ctypes.byref(self._dev), None))
        try:
            cfgd = lb.bladerf_is_fpga_configured(self._dev)
            self._check("is_fpga_configured", cfgd)
            if cfgd == 0:
                if not fpga:
                    raise OSError("bladerf FPGA not configured and no "
                                  "fpga= image given (bladerf.c:73-97)")
                self._check("load_fpga", lb.bladerf_load_fpga(
                    self._dev, fpga.encode()))
            # bladerf_initconf order (bladerf.c:127-154)
            self._check("set_frequency", lb.bladerf_set_frequency(
                self._dev, BLADERF_MODULE_RX,
                ctypes.c_uint32(int(spec.f_cf))))
            actual = ctypes.c_uint32()
            self._check("set_bandwidth", lb.bladerf_set_bandwidth(
                self._dev, BLADERF_MODULE_RX,
                ctypes.c_uint32(int(spec.f_sf) // 2), ctypes.byref(actual)))
            self._check("set_sample_rate", lb.bladerf_set_sample_rate(
                self._dev, BLADERF_MODULE_RX,
                ctypes.c_uint32(int(spec.f_sf)), ctypes.byref(actual)))
            self._cb = _STREAM_CB(self._on_samples)     # keep a reference!
            self._stream = ctypes.c_void_p()
            self._buffers = ctypes.POINTER(ctypes.c_void_p)()
            self._check("init_stream", lb.bladerf_init_stream(
                ctypes.byref(self._stream), self._dev, self._cb,
                ctypes.byref(self._buffers), BLADERF_NUM_BUFFERS,
                BLADERF_FORMAT_SC16_Q11, BLADERF_DATABUFF_SIZE,
                BLADERF_NUM_TRANSFERS, None))
            self._check("enable_module", lb.bladerf_enable_module(
                self._dev, BLADERF_MODULE_RX, True))
        except Exception:
            lb.bladerf_close(self._dev)
            raise
        self._count = 0
        self._closed = False
        self._thread = threading.Thread(target=self._grab, daemon=True)
        self._thread.start()

    @staticmethod
    def _check(what: str, ret: int) -> None:
        if ret < 0:
            raise OSError(f"bladerf {what} failed ({ret})")

    # stream callback: raw SC16 transfer -> ring; next buffer from the
    # 16-deep pool, NULL stops the stream (bladerf.c:19-48)
    def _on_samples(self, dev, stream, meta, samples, num_samples, user):
        self.ring.write(ctypes.string_at(samples, int(num_samples) * 4))
        if self._closed:
            return None
        buf = self._buffers[self._count % BLADERF_NUM_BUFFERS]
        self._count += 1
        return buf

    def _grab(self) -> None:
        # blocking until the callback returns NULL (bladerf.c:179)
        self._lib.bladerf_stream(self._stream, BLADERF_MODULE_RX)
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
        return ring_read(self.ring, self.spec, self.bps, start, n,
                         self.timeout_s)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True                 # next callback returns NULL
        self._thread.join(timeout=10)
        self._lib.bladerf_enable_module(self._dev, BLADERF_MODULE_RX,
                                        False)
        self._lib.bladerf_deinit_stream(self._stream)
        self._lib.bladerf_close(self._dev)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
