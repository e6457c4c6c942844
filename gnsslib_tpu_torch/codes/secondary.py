"""Neuman-Hoffman secondary (overlay) codes.

Reference behavior: src/sdrcode.c:446-479.  Chips are ±1 with the
reference's sign convention (its table stores the chip values directly).
"""
from __future__ import annotations

import numpy as np

LEN_NH10 = 10
LEN_NH20 = 20
CRATE_NH10 = 1000.0
CRATE_NH20 = 500.0

_NH10 = np.array([-1, -1, -1, -1, 1, 1, -1, 1, -1, 1], dtype=np.int8)
_NH20 = np.array([-1, -1, -1, -1, -1, 1, -1, -1, 1, 1,
                  -1, 1, -1, 1, -1, -1, 1, 1, 1, -1], dtype=np.int8)


def gencode_nh10() -> np.ndarray:
    return _NH10.copy()


def gencode_nh20() -> np.ndarray:
    return _NH20.copy()
