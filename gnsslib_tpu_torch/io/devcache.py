"""Device-resident IF samples (port of the ``get(start, n)`` contract of
:class:`gnsslib_tpu.io.devcache.DeviceBlockCache`).

File replay (:class:`DeviceBlockCache`): the capture is read once and
held on the device in the narrowest exact dtype (int8 for the plain FILE
alphabet, else int16 or float32); each block is cut on the device and
cast to float32, so the values equal
``torch.from_numpy(frontend.read(start, n))``.  A post-processing capture
at the 16.368 Msps envelope is ~1 GB per minute as int8, well inside the
card's memory, so there is no segment ladder or prefetch thread.

A live stream (:class:`LiveBlockCache`) is still growing, so it cannot be
read whole: each block's new samples are read from the front end's ring
once the producer has written them, staged in a pinned host buffer and
uploaded by a non-blocking copy into a device window that keeps the
newest samples.  :func:`block_cache` picks the cache for a front end.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import DType
from ..track.loop import resolve_device
from .live import StreamOverrun


def _narrow(x: np.ndarray) -> np.ndarray:
    """Narrowest dtype that represents the decoded samples exactly."""
    if x.dtype in (np.int8, np.int16):
        return x
    for dt in (np.int8, np.int16):
        xi = x.astype(dt)
        if np.array_equal(xi.astype(np.float32), x):
            return xi
    return x.astype(np.float32, copy=False)


class DeviceBlockCache:
    """``get(start, n)`` -> float32 device tensor of samples
    [start, start+n), zero-padded before the start of the capture (a
    negative ``start``) and past its end, like ``FileFrontend.read``."""

    def __init__(self, frontend, *, device):
        self.fe = frontend
        self.device = resolve_device(device)
        self._data = None
        self._last = None                 # (start, n, block) of the last get

    def _load(self) -> torch.Tensor:
        read = getattr(self.fe, "read_narrow", self.fe.read)
        x = np.ascontiguousarray(
            _narrow(np.asarray(read(0, int(self.fe.nsamples)))))
        if not x.flags.writeable:          # a view of the file's bytes
            x = x.copy()
        return torch.from_numpy(x).to(self.device)

    def get(self, start: int, n: int) -> torch.Tensor:
        if self._last is not None and self._last[:2] == (start, n):
            return self._last[2]
        if self._data is None:
            self._data = self._load()
        lo = max(int(start), 0)
        seg = self._data[lo:max(start + n, lo)].to(torch.float32)
        if seg.shape[0] < n:
            def zeros(k):
                return torch.zeros((k,) + tuple(self._data.shape[1:]),
                                   dtype=torch.float32, device=self.device)
            head = min(lo - start, n)
            seg = torch.cat([zeros(head), seg,
                             zeros(n - head - seg.shape[0])])
        self._last = (start, n, seg)
        return seg


class LiveBlockCache:
    """``get(start, n)`` over a live front end's growing stream (an
    ``is_live`` front end with ``nsamples``, ``eof`` and ``read``).

    The device holds a window of at most ``capacity`` samples of the
    stream as float32.  A request reads only the samples past the window's
    end, once: the producer must have written them (``nsamples``) unless
    the stream has ended (``eof``), past whose end the front end's read
    pads zeros.  A request for samples the producer has not written yet
    raises ``RuntimeError``; nothing is zero-padded inside the stream.
    The new samples are staged in a pinned host buffer (on a card) and
    uploaded by a non-blocking copy; the staging buffer is reused only
    after its last upload has completed.  When the window is full it
    drops its oldest samples but keeps ``retain`` samples before each
    request's start (the other channel groups of the path read blocks at
    their own origins); a request below the window raises
    :class:`StreamOverrun`, as the host ring does for a span the producer
    has overwritten.  Samples before sample 0 read as zeros."""

    def __init__(self, frontend, *, device, capacity: int, retain: int):
        self.fe = frontend
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.retain = int(retain)
        iq = frontend.spec.dtype == DType.IQ
        self._tail = (2,) if iq else ()
        self._buf = torch.zeros((self.capacity,) + self._tail,
                                dtype=torch.float32, device=self.device)
        self._lo = 0                      # stream sample of _buf[0]
        self._hi = 0                      # end of the samples held
        self._stage = None                # pinned host staging buffer
        self._uploaded = None             # event of its last upload
        self.uploaded_samples = 0

    def _upload(self, x: np.ndarray, at: int) -> None:
        """Copy host samples ``x`` into ``_buf[at:at + len(x)]``."""
        dst = self._buf[at:at + x.shape[0]]
        src = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if self.device.type != "cuda":
            dst.copy_(src)
            return
        if self._stage is None or self._stage.shape[0] < x.shape[0]:
            if self._uploaded is not None:
                self._uploaded.synchronize()
            self._stage = torch.empty((x.shape[0],) + self._tail,
                                      dtype=torch.float32, pin_memory=True)
        elif self._uploaded is not None:
            self._uploaded.synchronize()   # the stage's last copy is done
        stage = self._stage[:x.shape[0]]
        stage.copy_(src)
        dst.copy_(stage, non_blocking=True)
        self._uploaded = torch.cuda.Event()
        self._uploaded.record()

    def _fill(self, start: int, end: int) -> None:
        """Read the stream's samples [_hi, end) into the window."""
        eof = getattr(self.fe, "eof", False)   # before nsamples: final
        produced = int(self.fe.nsamples)
        if end > produced and not eof:
            raise RuntimeError(
                f"live stream: samples [{self._hi}, {end}) requested but "
                f"the producer has written {produced}")
        if end - self._lo > self.capacity:     # drop the oldest samples
            keep = min(max(start - self.retain, self._lo), self._hi)
            if end - keep > self.capacity:
                raise ValueError(f"a request of {end - start} samples "
                                 f"exceeds the live cache's capacity "
                                 f"{self.capacity} less its retention")
            if keep > self._lo:
                self._buf[:self._hi - keep] = \
                    self._buf[keep - self._lo:self._hi - self._lo].clone()
                self._lo = keep
        x = np.asarray(self.fe.read(self._hi, end - self._hi))
        self._upload(x, self._hi - self._lo)
        self.uploaded_samples += end - self._hi
        self._hi = end

    def get(self, start: int, n: int) -> torch.Tensor:
        start, end = int(start), int(start) + int(n)
        if end > self._hi:
            self._fill(start, end)
        lo = max(start, 0)
        if lo < self._lo:
            raise StreamOverrun(
                f"samples [{lo}, {end}) requested, the live cache holds "
                f"[{self._lo}, {self._hi})")
        seg = self._buf[lo - self._lo:end - self._lo].clone()
        if lo > start:                         # before sample 0
            seg = torch.cat([torch.zeros((lo - start,) + self._tail,
                                         dtype=torch.float32,
                                         device=self.device), seg])
        return seg


def block_cache(frontend, *, device, span: int):
    """The sample cache of ``frontend`` for blocks of ``span`` samples: a
    :class:`LiveBlockCache` for a live front end (a window of three
    blocks, keeping one block before each request), else the whole
    capture on the device."""
    if getattr(frontend, "is_live", False):
        return LiveBlockCache(frontend, device=device, capacity=3 * span,
                              retain=span)
    return DeviceBlockCache(frontend, device=device)
