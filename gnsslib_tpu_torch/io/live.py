"""Live front ends: capture-process ring buffer + growing-file follower.

The reference drives four USB front-ends in-process (src/rcv/*: RTL-SDR
via librtlsdr, BladeRF via libbladeRF, SiGe GN3S via libusb/FX2, NSL
STEREO via libnslstereo): an async grabber callback pushes each USB
transfer into a global ring buffer (rtlsdr.c:13-26, sdrrcv.c:207-225)
that the channel threads read at their own pace.  The in-process
bindings (io/rtlsdr.py, bladerf.py, gn3s.py, stereo.py) keep that
design; without a vendor shared library the grabber is an external
CAPTURE PROCESS speaking the vendor CLI contract (``rtl_sdr`` writes raw
u8 I/Q to stdout; ``bladeRF-cli`` writes SC16; any tool that emits the
byte format its file-replay twin in io.formats decodes):

* ``ProcessFrontend`` — spawns the grabber, drains its stdout into a
  host ring buffer on a reader thread, and serves ``read(start, n)``
  with blocking catch-up, OVERRUN detection (consumer fell a whole ring
  behind — the reference's driver overrun sets stopflag, rtlsdr.c:25),
  and producer-exit EOF.
* ``StreamFrontend`` — follows a growing capture file / FIFO written by
  an external grabber (filesystem as the ring).
"""
from __future__ import annotations

import os
import subprocess
import threading
import time

import numpy as np

from .frontend import FrontendSpec, _bytes_per_sample, _unpack


class StreamOverrun(RuntimeError):
    """The producer lapped the consumer: requested samples were already
    overwritten in the ring (reference: driver overrun -> stopflag)."""


class SampleRing:
    """Absolute-indexed byte ring shared by the live front ends — the
    reference's global membuf ring + buffcnt clock (src/sdrrcv.c:207-225,
    src/sdr.h:328) with the producer thread as the grabber."""

    def __init__(self, ring_bytes: int):
        self.ring_bytes = int(ring_bytes)
        self._buf = bytearray(self.ring_bytes)
        self.produced = 0                # absolute bytes written
        self.overruns = 0
        self.eof = False
        self._cond = threading.Condition()

    def write(self, chunk: bytes) -> None:
        with self._cond:
            pos = self.produced % self.ring_bytes
            end = pos + len(chunk)
            if end <= self.ring_bytes:
                self._buf[pos:end] = chunk
            else:                        # wraparound splice
                cut = self.ring_bytes - pos
                self._buf[pos:] = chunk[:cut]
                self._buf[:end - self.ring_bytes] = chunk[cut:]
            self.produced += len(chunk)
            self._cond.notify_all()

    def mark_eof(self) -> None:
        with self._cond:
            self.eof = True
            self._cond.notify_all()

    def read_span(self, b0: int, b1: int, timeout_s: float) -> bytes:
        """Bytes [b0, min(b1, produced)); blocks while the producer
        catches up; raises StreamOverrun for overwritten spans."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self.produced < b1 and not self.eof:
                if not self._cond.wait(
                        timeout=max(0.0, deadline - time.monotonic())):
                    break
            produced = self.produced
            if b0 < produced - self.ring_bytes:
                self.overruns += 1
                raise StreamOverrun(
                    f"bytes [{b0}, {b1}) overwritten: producer at "
                    f"{produced}, ring {self.ring_bytes}")
            hi = min(b1, produced)
            out = bytearray(max(0, hi - b0))
            if hi > b0:
                pos = b0 % self.ring_bytes
                end = pos + len(out)
                if end <= self.ring_bytes:
                    out[:] = self._buf[pos:end]
                else:                    # wraparound splice (sdrrcv.c:508)
                    cut = self.ring_bytes - pos
                    out[:cut] = self._buf[pos:]
                    out[cut:] = self._buf[:end - self.ring_bytes]
            return bytes(out)


def ring_read(ring: SampleRing, spec: FrontendSpec, bps: int, start: int,
              n: int, timeout_s: float, byte0: int = 0) -> np.ndarray:
    """Decode samples [start, start+n) from a live ring: the shared
    consumer path of every in-process driver binding (the reference's
    rcvgetbuff dispatch, src/sdrrcv.c:406-467).  ``byte0`` shifts the
    byte origin (GN3S v2 packet-shift realignment)."""
    raw = ring.read_span(byte0 + start * bps, byte0 + (start + n) * bps,
                         timeout_s)
    got = len(raw) // bps
    x = _unpack(spec, raw[:got * bps])
    if got < n:
        pad = np.zeros((n - got,) + x.shape[1:], np.float32)
        x = np.concatenate([x, pad], axis=0)
    return x


class LiveFrontend:
    """Abstract live front end: subclass binds a capture source."""

    is_live = True

    def __init__(self, spec: FrontendSpec):
        self.spec = spec

    def read(self, start: int, n: int) -> np.ndarray:   # pragma: no cover
        raise NotImplementedError

    @property
    def nsamples(self) -> int:                          # pragma: no cover
        raise NotImplementedError


class RingView(LiveFrontend):
    """A second RF path decoded from ANOTHER front end's ring: the NSL
    STEREO packs FE1 (2-bit real) and FE2 (dual 3-bit I/Q) into the SAME
    byte stream (src/rcv/stereo/stereo.c:160-205), so a dual-path
    receiver reads one USB stream through two views."""

    def __init__(self, owner: "LiveFrontend", spec: FrontendSpec):
        super().__init__(spec)
        self.owner = owner
        self.ring = owner.ring
        self.bps = _bytes_per_sample(spec)
        self.timeout_s = owner.timeout_s

    @property
    def eof(self) -> bool:
        return self.ring.eof

    @property
    def nsamples(self) -> int:
        return self.ring.produced // self.bps

    def read(self, start: int, n: int) -> np.ndarray:
        return ring_read(self.ring, self.spec, self.bps, start, n,
                         self.timeout_s, getattr(self.owner, "_byte0", 0))


class ProcessFrontend(LiveFrontend):
    """Live capture through an external grabber process.

    ``argv`` is the capture command writing raw samples to stdout (the
    vendor CLI contract).  A drain thread moves its output into a ring of
    ``ring_bytes`` addressed by the ABSOLUTE byte counter (the
    ``buffcnt*fendbuffsize`` clock of src/sdr.h:328), so ``read(start,
    n)`` serves any span still in the ring, blocks while the producer
    catches up, and raises :class:`StreamOverrun` for spans already
    overwritten.  Producer exit marks EOF; remaining ring content stays
    readable.
    """

    def __init__(self, argv: list[str], spec: FrontendSpec,
                 ring_bytes: int = 64 << 20, timeout_s: float = 30.0):
        super().__init__(spec)
        self.bps = _bytes_per_sample(spec)
        self.ring = SampleRing(ring_bytes)
        self.timeout_s = timeout_s
        self.argv = list(argv)
        self.proc = subprocess.Popen(self.argv, stdout=subprocess.PIPE,
                                     bufsize=0)
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    # -- vendor CLI constructors ---------------------------------------- #
    @staticmethod
    def rtl_sdr_argv(spec: FrontendSpec, device: int = 0,
                     gain: float | None = None,
                     binary: str = "rtl_sdr") -> list[str]:
        """`rtl_sdr` capture command (u8 I/Q on stdout): frequency/rate
        from the spec, ppm correction from spec.ppmerr — the parameters
        rtlsdr_initconf programs in-process (src/rcv/rtlsdr/rtlsdr.c:
        68-105)."""
        argv = [binary, "-f", str(int(spec.f_cf)),
                "-s", str(int(spec.f_sf)), "-d", str(device)]
        if gain is not None:
            argv += ["-g", str(gain)]
        if spec.ppmerr:
            argv += ["-p", str(int(round(spec.ppmerr)))]
        return argv + ["-"]

    @classmethod
    def rtl_sdr(cls, spec: FrontendSpec, device: int = 0,
                gain: float | None = None, binary: str = "rtl_sdr",
                **kw) -> "ProcessFrontend":
        return cls(cls.rtl_sdr_argv(spec, device, gain, binary), spec,
                   **kw)

    # -- grabber thread --------------------------------------------------- #
    def _drain(self) -> None:
        chunk_sz = 65536                 # FILE_BUFFSIZE (sdr.h:137)
        out = self.proc.stdout
        while True:
            chunk = out.read(chunk_sz)
            if not chunk:
                break
            self.ring.write(chunk)
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
        """Samples fully produced so far (grows while the grabber runs)."""
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
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:   # pragma: no cover
                self.proc.kill()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StreamFrontend:
    """Follows a growing capture file / FIFO from an external grabber.

    ``read`` blocks (sleep-poll, like the reference's sleepms(1) wait in
    sdrtracking, src/sdrtrk.c:30-50) until the producer has written the
    requested span, then decodes it with the spec's byte format.
    """

    is_live = True

    def __init__(self, path: str, spec: FrontendSpec,
                 poll_s: float = 0.05, timeout_s: float = 30.0):
        self.path = path
        self.spec = spec
        self.bps = _bytes_per_sample(spec)
        self.poll_s = poll_s
        self.timeout_s = timeout_s
        self._fp = open(path, "rb")
        self.eof = False

    def close(self):
        self._fp.close()

    @property
    def nsamples(self) -> int:
        """Current known stream length (grows while the producer runs)."""
        return os.fstat(self._fp.fileno()).st_size // self.bps

    def read(self, start: int, n: int) -> np.ndarray:
        need = (start + n) * self.bps
        deadline = time.monotonic() + self.timeout_s
        while os.fstat(self._fp.fileno()).st_size < need:
            if time.monotonic() > deadline:
                self.eof = True
                break
            time.sleep(self.poll_s)
        self._fp.seek(start * self.bps)
        raw = self._fp.read(n * self.bps)
        got = len(raw) // self.bps
        x = _unpack(self.spec, raw[:got * self.bps])
        if got < n:
            pad = np.zeros((n - got,) + x.shape[1:], np.float32)
            x = np.concatenate([x, pad], axis=0)
        return x
