"""Bitfield and CRC utilities (RTKLIB-equivalent surface).

Own implementations of the RTKLIB helpers the reference links
(getbitu/getbits/setbitu, rtk_crc24q, rtk_crc32 — lib/RTKLIB/src/rtkcmn.c)
plus the reference's multi-field and bit-packing helpers
(src/sdrnav.c:94-196).
"""
from __future__ import annotations

import numpy as np

# --- bit extraction ---------------------------------------------------------


def getbitu(buff, pos: int, length: int) -> int:
    """Unsigned bitfield from a byte buffer, MSB-first (RTKLIB getbitu)."""
    bits = 0
    for i in range(pos, pos + length):
        bits = (bits << 1) | ((int(buff[i // 8]) >> (7 - i % 8)) & 1)
    return bits


def getbits(buff, pos: int, length: int) -> int:
    """Two's-complement signed bitfield (RTKLIB getbits)."""
    u = getbitu(buff, pos, length)
    if length <= 0 or length >= 32 or not (u & (1 << (length - 1))):
        return u
    return u - (1 << length)


def setbitu(buff, pos: int, length: int, data: int) -> None:
    """Write an unsigned bitfield MSB-first (RTKLIB setbitu)."""
    mask = 1 << (length - 1)
    if length <= 0 or length > 32:
        return
    for i in range(pos, pos + length):
        if data & mask:
            buff[i // 8] |= 1 << (7 - i % 8)
        else:
            buff[i // 8] &= ~(1 << (7 - i % 8))
        mask >>= 1


def setbits(buff, pos: int, length: int, data: int) -> None:
    """Write a signed bitfield (RTKLIB setbits)."""
    if data < 0:
        data |= 1 << (length - 1)
    else:
        data &= ~(1 << (length - 1))
    setbitu(buff, pos, length, data)


# split-field variants (reference src/sdrnav.c:94-144)

def getbitu2(buff, p1, l1, p2, l2) -> int:
    return (getbitu(buff, p1, l1) << l2) + getbitu(buff, p2, l2)


def getbits2(buff, p1, l1, p2, l2) -> int:
    if getbitu(buff, p1, 1):
        return (getbits(buff, p1, l1) << l2) + getbitu(buff, p2, l2)
    return getbitu2(buff, p1, l1, p2, l2)


def getbitu3(buff, p1, l1, p2, l2, p3, l3) -> int:
    return ((getbitu(buff, p1, l1) << (l2 + l3)) +
            (getbitu(buff, p2, l2) << l3) + getbitu(buff, p3, l3))


def getbits3(buff, p1, l1, p2, l2, p3, l3) -> int:
    if getbitu(buff, p1, 1):
        return ((getbits(buff, p1, l1) << (l2 + l3)) +
                (getbitu(buff, p2, l2) << l3) + getbitu(buff, p3, l3))
    return getbitu3(buff, p1, l1, p2, l2, p3, l3)


def getbits_glo(buff, pos: int, length: int) -> int:
    """Sign-magnitude bitfield (GLONASS ICD; reference src/sdrnav_glo.c:15-20)."""
    mag = getbitu(buff, pos + 1, length - 1)
    return -mag if getbitu(buff, pos, 1) else mag


# --- ±1 bit vector <-> bytes (reference src/sdrnav.c:154-196) ----------------


def bits2byte(bits, nbits: int, nbin: int, right: bool = False) -> np.ndarray:
    """Pack ±1 bits into bytes; -1 maps to binary 1, +1 to binary 0.

    ``right=True`` right-aligns the bits in the nbin-byte output (used for
    CRC framing).  Mirrors reference bits2byte (src/sdrnav.c:154-176).
    """
    buf = np.zeros(8 * nbin, dtype=np.int64)
    rem = 8 * nbin - nbits
    start = rem if right else 0
    buf[start:start + nbits] = np.asarray(bits[:nbits])
    b01 = (buf < 0).astype(np.uint8)
    return np.packbits(b01)


def byte2bits(data: bytes | np.ndarray, nbits: int | None = None) -> np.ndarray:
    """Unpack bytes to ±1 bits (binary 1 -> -1), inverse of bits2byte."""
    b01 = np.unpackbits(np.frombuffer(bytes(data), dtype=np.uint8))
    if nbits is not None:
        b01 = b01[:nbits]
    return (1 - 2 * b01.astype(np.int64)).astype(np.int64)


def interleave(bits, row: int, col: int) -> np.ndarray:
    """Block (de)interleave: read by rows, write by columns
    (reference src/sdrnav.c:180-196)."""
    a = np.asarray(bits[:row * col]).reshape(col, row)
    return a.T.reshape(-1).copy()


# --- CRCs (RTKLIB-compatible) -------------------------------------------------

_CRC24_POLY = 0x1864CFB


def _crc24_table():
    tbl = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        crc = b << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24_POLY
        tbl[b] = crc & 0xFFFFFF
    return tbl


_CRC24_TBL = _crc24_table()


def crc24q(data, length: int | None = None) -> int:
    """CRC-24Q (RTCM/SBAS; RTKLIB rtk_crc24q)."""
    buf = np.frombuffer(bytes(bytearray(data)), dtype=np.uint8)
    if length is not None:
        buf = buf[:length]
    crc = 0
    for b in buf:
        crc = ((crc << 8) & 0xFFFFFF) ^ int(_CRC24_TBL[(crc >> 16) ^ int(b)])
    return crc


def crc32_rtk(data, length: int | None = None) -> int:
    """RTKLIB rtk_crc32: reflected 0xEDB88320, zero init, no final xor
    (differs from zlib crc32)."""
    buf = np.frombuffer(bytes(bytearray(data)), dtype=np.uint8)
    if length is not None:
        buf = buf[:length]
    crc = 0
    for b in buf:
        crc ^= int(b)
        for _ in range(8):
            crc = (crc >> 1) ^ 0xEDB88320 if crc & 1 else crc >> 1
    return crc
