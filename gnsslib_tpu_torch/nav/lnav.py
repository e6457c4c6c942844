"""GPS/QZSS L1 C/A LNAV subframe decode + encode.

Decode mirrors the reference field map exactly (src/sdrnav_gps.c:14-190;
IS-GPS-200 Table 20-I).  The encoder is the inverse — the simulator / test
oracle uses it to build bit-true subframes so ephemeris decode round-trips
(the test pyramid SURVEY.md §4 calls for).
"""
from __future__ import annotations

import numpy as np

from ..constants import PI
from ..gtime import adjgpsweek, gpst2time
from .bits import getbitu, getbits, getbitu2, getbits2, setbitu, setbits
from .eph import SdrEph

# power-of-two scale factors (RTKLIB rtkcmn.h)
P2_5 = 2.0 ** -5
P2_19 = 2.0 ** -19
P2_29 = 2.0 ** -29
P2_31 = 2.0 ** -31
P2_33 = 2.0 ** -33
P2_43 = 2.0 ** -43
P2_55 = 2.0 ** -55
SC2RAD = PI  # semicircles -> rad

PREAMBLE_L1CA = np.array([1, -1, -1, -1, 1, -1, 1, 1], dtype=np.int64)


# --- decode (src/sdrnav_gps.c:14-140) ----------------------------------------

def _adjweek_time(week: int, sec: float, tow: float):
    """toe/toc seconds-of-week -> GTime, adjusted into the half-week
    window around the transmission tow (week-rollover guard)."""
    if sec < tow - 302400.0:
        week += 1
    elif sec > tow + 302400.0:
        week -= 1
    return gpst2time(week, sec)


def decode_subfrm1(buff, eph: SdrEph, ref_week: int = 2200) -> None:
    eph.tow_gpst = getbitu(buff, 30, 17) * 6.0
    week = getbitu(buff, 60, 10) + 1024
    eph.eph.code = getbitu(buff, 70, 2)
    eph.eph.sva = getbitu(buff, 72, 4)
    eph.eph.svh = getbitu(buff, 76, 6)
    eph.eph.iodc = getbitu2(buff, 82, 2, 210, 8)
    eph.eph.flag = getbitu(buff, 90, 1)
    tgd = list(eph.eph.tgd)
    tgd[0] = getbits(buff, 196, 8) * P2_31
    eph.eph.tgd = tuple(tgd)
    toc = getbitu(buff, 218, 16) * 16.0
    eph.eph.f2 = getbits(buff, 240, 8) * P2_55
    eph.eph.f1 = getbits(buff, 248, 16) * P2_43
    eph.eph.f0 = getbits(buff, 270, 22) * P2_31

    eph.eph.week = adjgpsweek(week, ref_week)
    eph.week_gpst = eph.eph.week
    eph.eph.ttr = gpst2time(eph.eph.week, eph.tow_gpst)
    eph.eph.toc = _adjweek_time(eph.eph.week, toc, eph.tow_gpst)
    if eph.iode_sf2 >= 0:
        # subframe 2 arrived before 1 (toes may legitimately be 0.0 at
        # the week boundary, so test the seen-marker, not the value):
        # materialize toe now that the week is known
        eph.eph.toe = _adjweek_time(eph.eph.week, eph.eph.toes,
                                    eph.tow_gpst)
    eph.cnt += 1


def decode_subfrm2(buff, eph: SdrEph) -> None:
    oldiode = eph.eph.iode
    eph.tow_gpst = getbitu(buff, 30, 17) * 6.0
    eph.eph.iode = getbitu(buff, 60, 8)
    eph.eph.crs = getbits(buff, 68, 16) * P2_5
    eph.eph.deln = getbits(buff, 90, 16) * P2_43 * SC2RAD
    eph.eph.M0 = getbits2(buff, 106, 8, 120, 24) * P2_31 * SC2RAD
    eph.eph.cuc = getbits(buff, 150, 16) * P2_29
    eph.eph.e = getbitu2(buff, 166, 8, 180, 24) * P2_33
    eph.eph.cus = getbits(buff, 210, 16) * P2_29
    sqrtA = getbitu2(buff, 226, 8, 240, 24) * P2_19
    eph.eph.toes = getbitu(buff, 270, 16) * 16.0
    eph.eph.fit = getbitu(buff, 286, 1)
    eph.eph.A = sqrtA * sqrtA
    eph.iode_sf2 = eph.eph.iode
    if eph.eph.week:
        eph.eph.toe = _adjweek_time(eph.eph.week, eph.eph.toes,
                                    eph.tow_gpst)
    if oldiode != eph.eph.iode:
        eph.update = True
    eph.cnt += 1


def decode_subfrm3(buff, eph: SdrEph) -> None:
    oldiode = eph.eph.iode
    eph.tow_gpst = getbitu(buff, 30, 17) * 6.0
    eph.eph.cic = getbits(buff, 60, 16) * P2_29
    eph.eph.OMG0 = getbits2(buff, 76, 8, 90, 24) * P2_31 * SC2RAD
    eph.eph.cis = getbits(buff, 120, 16) * P2_29
    eph.eph.i0 = getbits2(buff, 136, 8, 150, 24) * P2_31 * SC2RAD
    eph.eph.crc = getbits(buff, 180, 16) * P2_5
    eph.eph.omg = getbits2(buff, 196, 8, 210, 24) * P2_31 * SC2RAD
    eph.eph.OMGd = getbits(buff, 240, 24) * P2_43 * SC2RAD
    eph.eph.iode = getbitu(buff, 270, 8)
    eph.iode_sf3 = eph.eph.iode
    eph.eph.idot = getbits(buff, 278, 14) * P2_43 * SC2RAD
    if oldiode != eph.eph.iode:
        eph.update = True
    eph.cnt += 1


def decode_frame_l1ca(buff, eph: SdrEph, ref_week: int = 2200) -> int:
    """Decode one 300-bit LNAV subframe packed MSB-first into bytes;
    returns the subframe ID (src/sdrnav_gps.c:123-140)."""
    sfid = getbitu(buff, 49, 3)
    if sfid == 1:
        decode_subfrm1(buff, eph, ref_week)
    elif sfid == 2:
        decode_subfrm2(buff, eph)
    elif sfid == 3:
        decode_subfrm3(buff, eph)
    elif sfid in (4, 5):
        eph.tow_gpst = getbitu(buff, 30, 17) * 6.0
        eph.week_gpst = eph.eph.week
    return sfid


# --- parity (src/sdrnav_gps.c:141-168; IS-GPS-200 20.3.5.2) -------------------

_PAR_TAPS = (
    (0, 2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22, 25),
    (0, 2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (1, 2, 4, 6, 7, 8, 10, 11, 15, 16, 17, 18, 19, 22, 23, 25),
    (0, 4, 6, 7, 9, 10, 11, 12, 14, 16, 20, 23, 24, 25),
)


def paritycheck_l1ca(bits) -> bool:
    """Word parity on ±1 bits [D29* D30* d1..d24 D25..D30] (32 entries used
    as reference's 2+30 layout: bits[0..1]=previous parity tail,
    bits[2..31]=word)."""
    b = np.asarray(bits[:32], dtype=np.int64)
    for k, taps in enumerate(_PAR_TAPS):
        p = 1
        for t in taps:
            p *= b[t]
        if p != b[26 + k]:
            return False
    return True


def parity_word(d24: np.ndarray, b29: int, b30: int) -> np.ndarray:
    """Compute D25..D30 (0/1) for transmitted data bits d1..d24 (0/1) given
    previous word's D29*, D30* (IS-GPS-200 20.3.5.2)."""
    # taps above are expressed on ±1; equivalent XOR taps on 0/1:
    t = np.asarray(d24, dtype=np.int64)
    x = [b29, b30, b29, b30, b30, b29]
    tap_idx = (
        (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),
        (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
        (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),
        (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
        (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
        (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),
    )
    out = []
    for k, taps in enumerate(tap_idx):
        p = x[k]
        for i in taps:
            p ^= int(t[i - 1])
        out.append(p)
    return np.asarray(out, dtype=np.int64)


# --- encode (test oracle / simulator) -----------------------------------------

def _word(d24_source, b29, b30):
    """Encode 24 source bits into a transmitted 30-bit word.

    Parity D25..D30 is computed from SOURCE bits; transmitted data is
    source XOR D30* of the previous word (IS-GPS-200 20.3.5; the reference
    undoes the inversion at sdrnav_gps.c:176-181).
    """
    par = parity_word(d24_source, b29, b30)
    d24 = [(b ^ b30) for b in d24_source]
    return d24 + list(par), int(par[4]), int(par[5])


def _solve_how_tail(how22, b29, b30):
    """Pick HOW t23,t24 so D29=D30=0 (IS-GPS-200 HOW constraint)."""
    for t23 in (0, 1):
        for t24 in (0, 1):
            cand = how22 + [t23, t24]
            w, n29, n30 = _word(cand, b29, b30)
            if n29 == 0 and n30 == 0:
                return w
    raise AssertionError("unreachable: HOW parity-solve always has a solution")


def encode_frame_l1ca(eph: SdrEph, sfid: int, tow_next6: int,
                      b29: int = 0, b30: int = 0, seed: int = 7) -> np.ndarray:
    """Encode subframe ``sfid`` (1-3 carry the given ephemeris; 4-5 carry
    TOW + filler) to 300 transmitted bits as ±1 (+1 = binary 0).

    tow_next6 = truncated TOW count (TOW of next subframe / 6 s).
    """
    rng = np.random.default_rng(seed * 10 + sfid)
    sf = bytearray(38)

    def u(pos, length, val):
        setbitu(sf, pos, length, int(val))

    def s(pos, length, val):
        setbits(sf, pos, length, int(round(val)))

    def u2(p1, l1, p2, l2, val):
        v = int(val)
        u(p1, l1, (v >> l2) & ((1 << l1) - 1))
        u(p2, l2, v & ((1 << l2) - 1))

    def s2(p1, l1, p2, l2, val):
        v = int(round(val))
        if v < 0:
            v += 1 << (l1 + l2)
        u2(p1, l1, p2, l2, v)

    # word 1 TLM: preamble + message + reserved
    u(0, 8, 0b10001011)
    u(8, 14, rng.integers(0, 1 << 14))
    # word 2 HOW
    u(30, 17, tow_next6)
    u(49, 3, sfid)

    e = eph.eph
    if sfid == 1:
        u(60, 10, (e.week - 1024) & 0x3FF)
        u(70, 2, e.code)
        u(72, 4, e.sva)
        u(76, 6, e.svh)
        u2(82, 2, 210, 8, e.iodc)
        u(90, 1, e.flag)
        s(196, 8, e.tgd[0] / P2_31)
        toc_tow = (e.toc.time - gpst2time(e.week, 0.0).time) + e.toc.sec
        u(218, 16, toc_tow / 16.0)
        s(240, 8, e.f2 / P2_55)
        s(248, 16, e.f1 / P2_43)
        s(270, 22, e.f0 / P2_31)
    elif sfid == 2:
        u(60, 8, e.iode)
        s(68, 16, e.crs / P2_5)
        s(90, 16, e.deln / (P2_43 * SC2RAD))
        s2(106, 8, 120, 24, e.M0 / (P2_31 * SC2RAD))
        s(150, 16, e.cuc / P2_29)
        u2(166, 8, 180, 24, e.e / P2_33)
        s(210, 16, e.cus / P2_29)
        u2(226, 8, 240, 24, np.sqrt(e.A) / P2_19)
        u(270, 16, e.toes / 16.0)
        u(286, 1, e.fit)
    elif sfid == 3:
        s(60, 16, e.cic / P2_29)
        s2(76, 8, 90, 24, e.OMG0 / (P2_31 * SC2RAD))
        s(120, 16, e.cis / P2_29)
        s2(136, 8, 150, 24, e.i0 / (P2_31 * SC2RAD))
        s(180, 16, e.crc / P2_5)
        s2(196, 8, 210, 24, e.omg / (P2_31 * SC2RAD))
        s(240, 24, e.OMGd / (P2_43 * SC2RAD))
        u(270, 8, e.iode)
        s(278, 14, e.idot / (P2_43 * SC2RAD))
    else:
        for w in range(2, 10):
            u(30 * w, 24, rng.integers(0, 1 << 24))

    # build transmitted words with parity
    src_bits = np.unpackbits(np.frombuffer(bytes(sf), np.uint8))[:300]
    out = []
    for w in range(10):
        d24 = [int(b) for b in src_bits[30 * w:30 * w + 24]]
        if w == 1:
            word = _solve_how_tail(d24[:22], b29, b30)
            b29, b30 = word[28], word[29]
        else:
            word, b29, b30 = _word(d24, b29, b30)
        out.extend(word)
    bits01 = np.asarray(out, dtype=np.int64)
    return (1 - 2 * bits01).astype(np.int64)
