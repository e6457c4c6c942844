"""Live diagnostics on the reference spectrum-thread cadence (port of
:mod:`gnsslib_tpu.diag.monitor`).

The reference's specthread refreshes a 3-bit sample histogram and a
Welch power spectrum every SPEC_MS=200 ms of wall time from the latest
SPEC_LEN=7 ms of ring data (src/sdrspec.c:29-110).  Here the cadence is
STREAM time (deterministic for replay; equal to wall time when running
real-time): the receiver calls :meth:`SpectrumMonitor.maybe_update` once
per block and the monitor recomputes whenever the stream crosses the next
grid point.  Frames are kept in a bounded deque for a UI/plot consumer;
``on_frame`` receives each frame as it is produced (the gnuplot-pipe role,
src/sdrplot.c).

On a CUDA card the receiver calls the monitor while tracking blocks are
still queued on the default stream, and a plain copy to the host there
would wait for all of them.  So the monitor uploads its span through a
pinned buffer, computes and copies the spectrum back on a CUDA stream of
its own, and waits only for an event recorded on that stream.  On the CPU
it runs :func:`~.spectrum.power_db` in place.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from ..constants import SPEC_LEN, SPEC_MS, SPEC_NFFT, SPEC_NLOOP
from .spectrum import (hanning, power_db, sample_histogram, spectrum_axis,
                       window_offsets)


@dataclasses.dataclass
class SpecFrame:
    t_stream: float            # stream time of the snapshot (s)
    hist_edges: np.ndarray     # histogram bin edges (3-bit view)
    hist_counts: np.ndarray
    freq_hz: np.ndarray        # spectrum frequency axis
    pspec_db: np.ndarray       # averaged power spectrum (dB)


class _SideStream:
    """The spectrum of one span on a CUDA stream of the monitor's own:
    span and offsets staged in pinned host buffers, uploaded, windowed and
    transformed on that stream, the result copied into a pinned buffer,
    and only that stream's event waited for."""

    def __init__(self, device, nint: int, iq: bool, nfft: int, nloop: int):
        self.iq = iq
        self.stream = torch.cuda.Stream(device)
        self.event = torch.cuda.Event()
        shape = (nint, 2) if iq else (nint,)
        self.span = torch.empty(shape, dtype=torch.float32, pin_memory=True)
        self.offs = torch.empty(nloop, dtype=torch.int64, pin_memory=True)
        self.out = torch.empty(nfft if iq else nfft // 2,
                               dtype=torch.float32, pin_memory=True)
        with torch.cuda.stream(self.stream):
            self.han = torch.from_numpy(
                np.hanning(nfft).astype(np.float32)).pin_memory().to(
                    device, non_blocking=True)
        self.device = device

    def __call__(self, x: np.ndarray, offs: np.ndarray) -> np.ndarray:
        # the previous frame's event was waited for: the pinned buffers
        # are free to overwrite
        self.span.numpy()[...] = x
        self.offs.numpy()[...] = offs
        with torch.cuda.stream(self.stream):
            span = self.span.to(self.device, non_blocking=True)
            offs_d = self.offs.to(self.device, non_blocking=True)
            self.out.copy_(power_db(span, offs_d, self.han, self.iq),
                           non_blocking=True)
            self.event.record(self.stream)
        self.event.synchronize()
        return self.out.numpy().copy()


class SpectrumMonitor:
    """Periodic IF histogram + spectrum snapshots from a frontend, the
    spectrum computed on ``device``."""

    def __init__(self, frontend, f_sf: float, iq: bool,
                 spec_ms: int = SPEC_MS, keep: int = 32, nbit: int = 3,
                 on_frame=None, *, device):
        self.fe = frontend
        self.f_sf = f_sf
        self.iq = bool(iq)
        self.spec_ms = int(spec_ms)
        self.nbit = nbit
        self.on_frame = on_frame
        self.frames: collections.deque[SpecFrame] = collections.deque(
            maxlen=keep)
        self._next_k = 0
        self._nint = int(SPEC_LEN * 1e-3 * f_sf)        # 7 ms of samples
        self.device = torch.device(device)
        self._side = None              # built at the first frame on a card
        self._han = None
        # frames made and the wall seconds spent making them
        self.nframes = 0
        self.seconds = 0.0

    @property
    def latest(self) -> SpecFrame | None:
        return self.frames[-1] if self.frames else None

    def _power_db(self, x: np.ndarray, offs: np.ndarray) -> np.ndarray:
        if self.device.type == "cuda":
            if self._side is None:
                self._side = _SideStream(self.device, self._nint, self.iq,
                                         SPEC_NFFT, SPEC_NLOOP)
            return self._side(x, offs)
        if self._han is None:
            self._han = hanning(SPEC_NFFT, self.device)
        return power_db(torch.from_numpy(x), torch.from_numpy(offs),
                        self._han, self.iq).numpy()

    def maybe_update(self, base: int) -> None:
        """Snapshot if stream sample index ``base`` crossed the next
        SPEC_MS grid point (catching up emits ONE frame, not a backlog —
        the reference thread also just samples the latest data)."""
        t_ms = base / self.f_sf * 1000.0
        if t_ms < self._next_k * self.spec_ms:
            return
        t0 = time.perf_counter()
        self._next_k = int(t_ms // self.spec_ms) + 1
        start = max(0, base - self._nint)
        x = np.ascontiguousarray(self.fe.read(start, self._nint), np.float32)
        edges, counts = sample_histogram(x, nbit=self.nbit)
        offs = window_offsets(x.shape[0], SPEC_NFFT, SPEC_NLOOP,
                              self._next_k)
        freq, pdb = spectrum_axis(self._power_db(x, offs), self.f_sf,
                                  SPEC_NFFT, self.iq)
        frame = SpecFrame(t_stream=base / self.f_sf, hist_edges=edges,
                          hist_counts=counts, freq_hz=freq, pspec_db=pdb)
        self.frames.append(frame)
        self.nframes += 1
        self.seconds += time.perf_counter() - t0
        if self.on_frame is not None:
            self.on_frame(frame)
