"""GLONASS G1 navigation-string decode + encode.

Decode mirrors the reference (src/sdrnav_glo.c; GLONASS ICD 5.1), including
the meander removal / relative-code (differential) conversion of the raw
100 sps symbol stream (src/sdrnav_glo.c:199-224).  The encoder inverts the
pipeline for the simulator / round-trip tests.
"""
from __future__ import annotations

import numpy as np

from ..constants import SYS_GLO
from ..gtime import glot2time, time2gpst, time2epoch, epoch2time, utc2gpst
from ..sat import satno
from .bits import getbitu, getbits_glo, bits2byte
from .eph import SdrEph

P2_11 = 2.0 ** -11
P2_20 = 2.0 ** -20
P2_30 = 2.0 ** -30
P2_40 = 2.0 ** -40

# 30-symbol time mark (reference pre_g1, src/sdrinit.c:494-496)
TIMEMARK_G1 = np.array([-1, -1, -1, -1, -1, 1, 1, 1, -1, -1,
                        1, -1, -1, -1, 1, -1, 1, -1, 1, 1,
                        1, 1, -1, 1, 1, -1, 1, -1, -1, 1], dtype=np.int64)


def decode_g1s1(buff, eph: SdrEph) -> None:
    eph.tk[0] = getbitu(buff, 9, 5) - 3   # 3 h Moscow-UTC bias
    eph.tk[1] = getbitu(buff, 14, 6)
    eph.tk[2] = getbitu(buff, 20, 1) * 30
    eph.geph.vel[0] = getbits_glo(buff, 21, 24) * P2_20 * 1000
    eph.geph.acc[0] = getbits_glo(buff, 45, 5) * P2_30 * 1000
    eph.geph.pos[0] = getbits_glo(buff, 50, 27) * P2_11 * 1000
    eph.cnt += 1


def decode_g1s2(buff, eph: SdrEph) -> None:
    oldiode = eph.geph.iode
    eph.geph.svh = getbitu(buff, 5, 1)
    eph.geph.iode = getbitu(buff, 9, 7)
    eph.geph.vel[1] = getbits_glo(buff, 21, 24) * P2_20 * 1000
    eph.geph.acc[1] = getbits_glo(buff, 45, 5) * P2_30 * 1000
    eph.geph.pos[1] = getbits_glo(buff, 50, 27) * P2_11 * 1000
    if oldiode != eph.geph.iode:
        eph.update = True
    eph.cnt += 1


def decode_g1s3(buff, eph: SdrEph) -> None:
    eph.geph.gamn = getbits_glo(buff, 6, 11) * P2_40
    eph.geph.vel[2] = getbits_glo(buff, 21, 24) * P2_20 * 1000
    eph.geph.acc[2] = getbits_glo(buff, 45, 5) * P2_30 * 1000
    eph.geph.pos[2] = getbits_glo(buff, 50, 27) * P2_11 * 1000
    eph.cnt += 1


def decode_g1s4(buff, eph: SdrEph) -> None:
    eph.geph.taun = getbits_glo(buff, 5, 22) * P2_30
    eph.geph.dtaun = getbits_glo(buff, 27, 5) * P2_30
    eph.geph.age = getbitu(buff, 32, 5)
    eph.geph.sva = getbitu(buff, 52, 4)
    eph.nt = getbitu(buff, 59, 11)
    eph.prn = getbitu(buff, 70, 5)
    eph.geph.sat = satno(SYS_GLO, eph.prn)
    eph.cnt += 1


def decode_g1s5(buff, eph: SdrEph) -> None:
    eph.n4 = getbitu(buff, 49, 5)
    eph.cnt += 1


def merge_g1(eph: SdrEph) -> None:
    """Combine strings into geph + GPST tow (src/sdrnav_glo.c:157-175)."""
    eph.geph.tof = glot2time(eph.nt, eph.n4, eph.tk[0], eph.tk[1], eph.tk[2])
    tow, week = time2gpst(eph.geph.tof)
    eph.tow_gpst = tow + eph.s1cnt * 2.0
    eph.eph.week = week
    eph.week_gpst = week
    ep = time2epoch(eph.geph.tof)
    ep[3], ep[4], ep[5] = 0, eph.geph.iode * 15 - 60 * 3, 0
    eph.geph.toe = utc2gpst(epoch2time(ep))


def decode_frame_g1(buff, eph: SdrEph) -> int:
    """Dispatch one 85-bit string packed into bytes (src/sdrnav_glo.c:177-197)."""
    sid = getbitu(buff, 1, 4)
    if sid == 1:
        decode_g1s1(buff, eph)
        eph.s1cnt = 1
    elif sid == 2:
        decode_g1s2(buff, eph)
        eph.s1cnt += 1
    elif sid == 3:
        decode_g1s3(buff, eph)
        eph.s1cnt += 1
    elif sid == 4:
        decode_g1s4(buff, eph)
        eph.s1cnt += 1
    elif sid == 5:
        decode_g1s5(buff, eph)
        eph.s1cnt += 1
    else:
        eph.s1cnt += 1
    if eph.cnt == eph.cntth:
        merge_g1(eph)
    return sid


def decode_g1_symbols(fbits, polarity: int, eph: SdrEph) -> int:
    """Full G1 string decode from 200 raw 10 ms symbols.

    Meander removal + differential (relative-code) decode
    (src/sdrnav_glo.c:199-224): symbol stream is bi-binary (meander) coded
    at 100 sps; data bits are the product of adjacent de-meandered symbols.
    The first 170 symbols carry the string; the last 30 are the time mark.
    """
    fb = np.asarray(fbits[:170], dtype=np.int64) * polarity
    bits1 = fb.copy()
    bits1[1::2] *= -1                       # strip meander
    bits2 = np.empty(85, dtype=np.int64)
    bits2[0] = -1                           # idle bit (always binary 0 -> +1?
    # reference sets bits2[0]=-1: sdrnav_glo.c:219)
    bits2[1:85] = bits1[0:168:2] * bits1[2:170:2]
    bin_ = bits2byte(bits2, 85, 11, right=False)
    return decode_frame_g1(bin_, eph)


# --- encoder (simulator / round-trip oracle) ---------------------------------

def encode_string_g1(bits85_01: np.ndarray) -> np.ndarray:
    """85 logical string bits (0/1, bit 0 = idle 0) -> 170 ±1 line symbols
    (differential then meander), followed on air by the 30-symbol time mark.

    Inverse of decode_g1_symbols for the simulator.
    """
    b = np.asarray(bits85_01, dtype=np.int64)
    assert b.shape == (85,) and b[0] == 0, "string starts with idle 0"
    pm = 1 - 2 * b                          # ±1, +1 = binary 0
    # differential: choose de-meandered symbols s.t. s[k]*s[k+1] = bit k+1
    sym = np.empty(85 + 1, dtype=np.int64)
    sym[0] = 1
    for k in range(85):
        sym[k + 1] = sym[k] * pm[k]
    # each data bit lasts 2 symbols de-meandered; re-apply meander
    line = np.repeat(sym[1:], 2)[:170]
    line[1::2] *= -1
    return line
