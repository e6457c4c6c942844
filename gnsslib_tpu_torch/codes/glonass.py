"""GLONASS G1/G2 C/A ranging code (GLONASS ICD).

9-stage m-sequence, identical for all satellites (FDMA separates them).
Reference behavior: src/sdrcode.c:425-444 — note the reference's dispatch
never reaches this generator (missing CTYPE_G1 case); here it is wired.
"""
from __future__ import annotations

import numpy as np

LEN_G1G2 = 511
CRATE_G1G2 = 0.511e6


def gencode_g1g2() -> np.ndarray:
    """Return the 511-chip ±1 GLONASS C/A code (bit 1 -> +1)."""
    r = np.ones(9, dtype=np.uint8)
    bits = np.empty(LEN_G1G2, dtype=np.uint8)
    for i in range(LEN_G1G2):
        bits[i] = r[6]          # output from stage 7
        fb = r[4] ^ r[8]        # taps at stages 5 and 9
        r[1:] = r[:-1]
        r[0] = fb
    return (2 * bits.astype(np.int8) - 1)
