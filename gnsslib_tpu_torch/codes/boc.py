"""Binary-offset-carrier (BOC) modulation.

Reference behavior: src/sdrcode.c:480-514.  Each chip is repeated
N = 2*m/n times and the square-wave subcarrier negates the first half-chip
sample of each pair.
"""
from __future__ import annotations

import numpy as np


def boc(code: np.ndarray, m: int = 1, n: int = 1) -> tuple[np.ndarray, int]:
    """BOC(m,n)-modulate a ±1 code; returns (modulated code, rate multiplier N)."""
    N = 2 * m // n
    out = np.repeat(code, N).astype(np.int8)
    out[0::2] *= -1
    return out, N
