"""SBAS L1 250 bps message decode + NovAtel OEM6 framing.

Mirrors src/sdrnav_sbs.c: CRC-24Q check over the 226-bit body, MT12 GPS
time extraction, and RAWSBASFRAME (msg id 973) NovAtel framing so the
stream is consumable by RTKLIB tools.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import LENSBASMSG, LENSBASNOV
from .bits import bits2byte, crc24q, crc32_rtk, getbitu, setbitu

OEMSYNC1, OEMSYNC2, OEMSYNC3 = 0xAA, 0x44, 0x12
OEMHLEN = 28
OEMSBASLEN = 48
ID_RAWSBASFRAME = 973

# two consecutive 8-bit preambles of the repeating 53/9A/C6 cycle
# (reference pre_sbs, src/sdrinit.c:498-500; note its element 20 typo
# `1 -1` — harmless there since prelen=16 — fixed here)
PREAMBLE_SBAS = np.array([1, -1, 1, -1, 1, 1, -1, -1,
                          -1, 1, 1, -1, -1, 1, -1, 1,
                          -1, -1, 1, 1, -1, 1, -1, -1], dtype=np.int64)


@dataclasses.dataclass
class SbasMsg:
    """Reference sdrsbas_t (src/sdr.h:436-443)."""
    week: int = 0
    tow: float = 0.0
    msg: bytearray = dataclasses.field(default_factory=lambda: bytearray(LENSBASMSG))
    id: int = 0
    novatelmsg: bytearray = dataclasses.field(
        default_factory=lambda: bytearray(LENSBASNOV))


def _set_u2_le(p: bytearray, off: int, u: int) -> None:
    p[off] = u & 0xFF
    p[off + 1] = (u >> 8) & 0xFF


def _set_u4_le(p: bytearray, off: int, u: int) -> None:
    for i in range(4):
        p[off + i] = (u >> (8 * i)) & 0xFF


def gen_novatel_sbasmsg(sbas: SbasMsg) -> None:
    """Frame the current message as NovAtel OEM6 RAWSBASFRAME
    (src/sdrnav_sbs.c:40-67)."""
    m = sbas.novatelmsg
    for i in range(LENSBASNOV):
        m[i] = 0
    m[0], m[1], m[2] = OEMSYNC1, OEMSYNC2, OEMSYNC3
    _set_u2_le(m, 4, ID_RAWSBASFRAME)
    _set_u2_le(m, 8, OEMSBASLEN)
    _set_u2_le(m, 14, sbas.week)
    _set_u4_le(m, 16, int(sbas.tow * 1000))
    _set_u4_le(m, OEMHLEN + 4, 183)          # PRN (reference hardcodes 183)
    _set_u4_le(m, OEMHLEN + 8, sbas.id)
    m[OEMHLEN + 12:OEMHLEN + 12 + 29] = sbas.msg[:29]
    _set_u4_le(m, OEMHLEN + 48, crc32_rtk(m, OEMHLEN + 48))


def decode_MT12(buff, sbas: SbasMsg, ref_week: int = 2200) -> None:
    """MT12 time: 20-bit tow (s) + 10-bit GPS week.

    The reference adds a fixed 1024 rollover (src/sdrnav_sbs.c:69-77),
    wrong for weeks >= 2048; we resolve the 10-bit field against
    ``ref_week`` (same policy as gtime.adjgpsweek)."""
    sbas.tow = getbitu(buff, 107, 20) + 1.0
    w10 = getbitu(buff, 127, 10)
    sbas.week = w10 + (ref_week - w10 + 512) // 1024 * 1024


def decode_msg_sbas(buff, sbas: SbasMsg, ref_week: int = 2200) -> int:
    """Extract message type; MT12 carries GPS time (src/sdrnav_sbs.c:80-98)."""
    sbas.id = getbitu(buff, 8, 6)
    if sbas.id == 12:
        decode_MT12(buff, sbas, ref_week)
    else:
        sbas.tow += 1.0
    return sbas.id


def check_crc_sbas(bits250, polarity: int = 1) -> bool:
    """CRC-24Q over the 226-bit body vs the trailing 24 parity bits
    (src/sdrnav_sbs.c:100-117, sdrnav.c:351-360)."""
    bits = np.asarray(bits250[:250], dtype=np.int64) * polarity
    body = bits2byte(bits[:226], 226, 29, right=True)
    par = bits2byte(bits[226:250], 24, 3, right=False)
    return crc24q(body, 29) == getbitu(par, 0, 24)


def decode_l1sbas_bits(bits250, polarity: int, sbas: SbasMsg,
                       ref_week: int = 2200) -> int:
    """Decode one 250-bit SBAS message (already FEC-decoded, ±1)."""
    bits = np.asarray(bits250[:250], dtype=np.int64) * polarity
    sbas.msg = bytearray(bits2byte(bits, 250, LENSBASMSG, right=False))
    return decode_msg_sbas(sbas.msg, sbas, ref_week)


def encode_sbas_message(mt: int, payload_bits212, preamble8: int,
                        ) -> np.ndarray:
    """Build one 250-bit SBAS message (±1) with valid CRC-24Q: 8-bit
    preamble + 6-bit type + 212-bit payload + 24-bit CRC (DO-229 4.4.3)."""
    body = bytearray(29)   # right-aligned 226 bits: 6 pad + 220... use setbitu
    bits01 = np.zeros(250, dtype=np.int64)
    bits01[0:8] = [(preamble8 >> (7 - i)) & 1 for i in range(8)]
    bits01[8:14] = [(mt >> (5 - i)) & 1 for i in range(6)]
    bits01[14:226] = np.asarray(payload_bits212, dtype=np.int64)[:212]
    # crc over the 226-bit body, right-aligned in 29 bytes
    buf = bytearray(29)
    rem = 29 * 8 - 226
    for i, b in enumerate(bits01[:226]):
        setbitu(buf, rem + i, 1, int(b))
    crc = crc24q(buf, 29)
    bits01[226:250] = [(crc >> (23 - i)) & 1 for i in range(24)]
    return (1 - 2 * bits01).astype(np.int64)
