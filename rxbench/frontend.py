"""An in-memory front end: a capture held in host memory as int8, with
the interface of the receiver's file front end (``spec``, ``nsamples``,
``read``, ``read_narrow``, ``close``), so that no capture is written to
disk."""
from __future__ import annotations

import numpy as np


class MemoryFrontend:
    """Real int8 samples ``data`` (a 1-D numpy int8 array or a CPU int8
    tensor) under the front-end spec ``spec``."""

    def __init__(self, data, spec):
        self.spec = spec
        self._x = np.asarray(data)
        if self._x.dtype != np.int8 or self._x.ndim != 1:
            raise ValueError("MemoryFrontend holds 1-D int8 real samples")
        self.nsamples = int(self._x.shape[0])
        self.path = "<memory>"

    def read_narrow(self, start: int, n: int) -> np.ndarray:
        """Samples [start, start + n) as int8, zeros past the end."""
        if start < 0:
            raise ValueError("negative sample index")
        x = self._x[start:start + n]
        if x.shape[0] < n:
            x = np.concatenate([x, np.zeros(n - x.shape[0], np.int8)])
        return x

    def read(self, start: int, n: int) -> np.ndarray:
        """Samples [start, start + n) as float32, zeros past the end."""
        return self.read_narrow(start, n).astype(np.float32)

    def close(self) -> None:
        pass
