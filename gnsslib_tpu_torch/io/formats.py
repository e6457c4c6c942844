"""Vectorized IF sample unpackers — one per front-end byte format.

Each mirrors the corresponding driver's expansion routine, returning
float32 sample values identical to the reference's sign-expanded chars:

* plain int8 file          — src/sdrrcv.c:469-531 (FEND_FILE)
* RTL-SDR u8               — src/rcv/rtlsdr/rtlsdr.c:136-143 (u8 - 127.5)
* GN3S v2 1-bit            — src/rcv/gn3s/gn3s.cpp:89-110 (LUT {1,-1},
                             packet-shift realignment)
* GN3S v3 2-bit sign/mag   — src/rcv/gn3s/gn3s.cpp:143-176 LUT {1,-1,3,-3}
* GN3S v3 4-bit I/Q        — same, I/Q LUTs
* NSL STEREO packed byte   — src/rcv/stereo/stereo.c:160-205 (FE1 2-bit
                             real, FE2 dual-3-bit I/Q in one byte)
* BladeRF SC16 Q11         — src/rcv/bladerf/bladerf.c:19-48,216-261
                             (mask 0xfff -> u8 store, per-block DC removal)
"""
from __future__ import annotations

import numpy as np

# --- simple formats -----------------------------------------------------------


def unpack_int8(raw: np.ndarray, iq: bool) -> np.ndarray:
    """Plain int8 stream; IQ interleaved pairs -> (n, 2)."""
    x = np.frombuffer(raw, dtype=np.int8).astype(np.float32)
    return x.reshape(-1, 2) if iq else x


def unpack_rtlsdr(raw: np.ndarray) -> np.ndarray:
    """RTL-SDR u8 I/Q: value - 127.5, truncated toward zero like the
    reference's (char) cast (rtlsdr.c:141)."""
    x = np.frombuffer(raw, dtype=np.uint8).astype(np.float64) - 127.5
    x = np.trunc(x).astype(np.float32)
    return x.reshape(-1, 2)


# --- GN3S ---------------------------------------------------------------------

_LUT_1BIT = np.array([1, -1], dtype=np.float32)
_LUT_2BIT = np.array([1, -1, 3, -3], dtype=np.float32)
_LUT_I_4BIT = np.zeros(16, np.float32)
_LUT_I_4BIT[[0, 1, 4, 5]] = [1, -1, 3, -3]
_LUT_Q_4BIT = np.zeros(16, np.float32)
_LUT_Q_4BIT[[0, 2, 8, 10]] = [1, -1, 3, -3]


def unpack_gn3s_v2(raw: np.ndarray) -> np.ndarray:
    """GN3S v2: one sign bit per byte (bit 0), I/Q interleaved; USB packet
    shift realignment by bit 1 of the first/last byte (gn3s.cpp:95-109)."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    n = len(buf)
    out = np.zeros(n, np.float32)
    shift = (buf[0] & 0x02) != 2
    endshift = (buf[-1] & 0x02) != 0
    if shift:
        out[:n - 1] = _LUT_1BIT[buf[1:] & 0x01]
        if endshift:
            out[n - 2] = 0.0
        # else out[n-1] stays 0
    else:
        out[:] = _LUT_1BIT[buf & 0x01]
        if endshift:
            out[n - 1] = 0.0
    return out.reshape(-1, 2)


def unpack_gn3s_v2_aligned(raw: np.ndarray) -> np.ndarray:
    """GN3S v2 payload with the packet shift already resolved (the file
    front-end detects the shift ONCE at stream start and offsets reads by
    one byte): plain per-byte sign decode, I/Q interleaved.  Using the
    per-read detection of unpack_gn3s_v2 on arbitrary block boundaries
    would re-interpret bit 1 of whatever byte the read happens to start
    on and zero/shift samples at every seam."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    return _LUT_1BIT[buf & 0x01].reshape(-1, 2)


def unpack_gn3s_v3_2bit(raw: np.ndarray) -> np.ndarray:
    """GN3S v3 2-bit sign/magnitude real samples."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    return _LUT_2BIT[buf & 0x03]


def unpack_gn3s_v3_4bit(raw: np.ndarray) -> np.ndarray:
    """GN3S v3 4-bit packed I/Q -> (n, 2)."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    i = _LUT_I_4BIT[buf & 0x05]
    q = _LUT_Q_4BIT[buf & 0x0A]
    return np.stack([i, q], axis=-1)


# --- NSL STEREO ---------------------------------------------------------------

_BASELUT1 = np.array([-3, -1, 1, 3], dtype=np.float32)
_BASELUT2 = np.array([1, 3, 5, 7, -7, -5, -3, -1], dtype=np.float32)
_r = np.arange(256)
_STEREO_LUT1 = _BASELUT1[(_r >> 6) & 0x03]
_STEREO_LUT2_I = _BASELUT2[(_r >> 3) & 0x07]
_STEREO_LUT2_Q = _BASELUT2[_r & 0x07]


def unpack_stereo_fe1(raw: np.ndarray) -> np.ndarray:
    """STEREO front-end 1 (max2769): 2-bit real in bits 7-6."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    return _STEREO_LUT1[buf]


def unpack_stereo_fe2(raw: np.ndarray) -> np.ndarray:
    """STEREO front-end 2 (max2112): dual 3-bit I/Q in bits 5-0 -> (n, 2)."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    return np.stack([_STEREO_LUT2_I[buf], _STEREO_LUT2_Q[buf]], axis=-1)


# --- BladeRF ------------------------------------------------------------------


def unpack_bladerf(raw: np.ndarray) -> np.ndarray:
    """BladeRF SC16 Q11 file replay: uint16 pairs masked to 12 bits and
    truncated to u8 at capture (bladerf.c:32-34, 290-309), then per-block
    I/Q DC-offset removal with (char) truncation (bladerf.c:216-239)."""
    u = np.frombuffer(raw, dtype=np.uint16)
    b = (u & 0xFFF).astype(np.uint8).astype(np.float64).reshape(-1, 2)
    b -= b.mean(axis=0, keepdims=True)
    return np.trunc(b).astype(np.float32)
