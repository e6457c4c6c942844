"""Device-resident IF samples (port of the ``get(start, n)`` contract of
:class:`gnsslib_tpu.io.devcache.DeviceBlockCache`).

The capture is read once and held on the device in the narrowest exact
dtype (int8 for the plain FILE alphabet, else int16 or float32); each
block is cut on the device and cast to float32, so the values equal
``torch.from_numpy(frontend.read(start, n))``.  A post-processing capture
at the 16.368 Msps envelope is ~1 GB per minute as int8, well inside the
card's memory, so there is no segment ladder or prefetch thread.
"""
from __future__ import annotations

import numpy as np
import torch

from ..track.loop import resolve_device


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

    def __init__(self, frontend, block_len: int, *, device):
        self.fe = frontend
        self.block_len = int(block_len)
        self.device = resolve_device(device)
        self._data = None
        self._last = None                 # (start, block) of the last get

    def _load(self) -> torch.Tensor:
        read = getattr(self.fe, "read_narrow", self.fe.read)
        x = np.ascontiguousarray(
            _narrow(np.asarray(read(0, int(self.fe.nsamples)))))
        if not x.flags.writeable:          # a view of the file's bytes
            x = x.copy()
        return torch.from_numpy(x).to(self.device)

    def get(self, start: int, n: int) -> torch.Tensor:
        if n != self.block_len:
            raise ValueError(f"block length {n} != {self.block_len}")
        if self._last is not None and self._last[0] == start:
            return self._last[1]
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
        self._last = (start, seg)
        return seg
