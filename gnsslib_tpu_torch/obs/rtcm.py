"""RTCM 3 message encoder: 1019/1020 ephemerides + MSM7 observables.

Implements the message set the reference streams over TCP
(src/sdrout.c:295-366: types 1019, 1044, 1020 and MSM7 1077/1087/1097/
1117/1127), with field layouts per RTCM 10403 as realized by RTKLIB's
rtcm3e.c (cited per encoder).  Single-signal (L1 C/A, signal id 2) MSM7.
"""
from __future__ import annotations

import math

import numpy as np

from ..constants import (CLIGHT, FREQ1, FREQ1_CMP, FREQ1_GLO, DFRQ1_GLO,
                         SYS_GPS, SYS_GLO, SYS_GAL, SYS_QZS, SYS_SBS,
                         SYS_CMP)
from ..gtime import gpst2utc, time2epoch, time2gpst, timeadd, timediff, \
    epoch2time
from ..nav.bits import crc24q, setbitu, setbits
from ..nav.eph import Eph, Geph

RANGE_MS = CLIGHT * 1e-3
P2 = lambda n: 2.0 ** -n


def _round(x):
    return int(math.floor(x + 0.5)) if x >= 0 else -int(
        math.floor(-x + 0.5))


def setbitg(buff, pos, length, value):
    """Sign-magnitude bitfield (GLONASS; RTKLIB setbitg)."""
    setbitu(buff, pos, 1, 1 if value < 0 else 0)
    setbitu(buff, pos + 1, length - 1, abs(int(value)))


def frame_rtcm3(payload: bytearray, nbits: int) -> bytes:
    """0xD3 framing + CRC-24Q (RTCM 10403 transport layer)."""
    nbyte = (nbits + 7) // 8
    msg = bytearray(3 + nbyte)
    msg[0] = 0xD3
    setbitu(msg, 14, 10, nbyte)
    msg[3:3 + nbyte] = payload[:nbyte]
    crc = crc24q(msg, 3 + nbyte)
    return bytes(msg) + crc.to_bytes(3, "big")


# --- type 1019: GPS ephemeris (rtcm3e.c:746-814) -----------------------------

def encode_1019(prn: int, eph: Eph) -> bytes:
    b = bytearray(64)
    i = 0

    def u(n, v):
        nonlocal i
        setbitu(b, i, n, int(v) & ((1 << n) - 1))
        i += n

    def s(n, v):
        nonlocal i
        setbits(b, i, n, int(v))
        i += n

    toc_tow, _ = time2gpst(eph.toc)
    u(12, 1019)
    u(6, prn)
    u(10, eph.week % 1024)
    u(4, eph.sva)
    u(2, eph.code)
    s(14, _round(eph.idot / P2(43) / math.pi))
    u(8, eph.iode)
    u(16, _round(toc_tow / 16.0))
    s(8, _round(eph.f2 / P2(55)))
    s(16, _round(eph.f1 / P2(43)))
    s(22, _round(eph.f0 / P2(31)))
    u(10, eph.iodc)
    s(16, _round(eph.crs / P2(5)))
    s(16, _round(eph.deln / P2(43) / math.pi))
    s(32, _round(eph.M0 / P2(31) / math.pi))
    s(16, _round(eph.cuc / P2(29)))
    u(32, _round(eph.e / P2(33)))
    s(16, _round(eph.cus / P2(29)))
    u(32, _round(math.sqrt(eph.A) / P2(19)))
    u(16, _round(eph.toes / 16.0))
    s(16, _round(eph.cic / P2(29)))
    s(32, _round(eph.OMG0 / P2(31) / math.pi))
    s(16, _round(eph.cis / P2(29)))
    s(32, _round(eph.i0 / P2(31) / math.pi))
    s(16, _round(eph.crc / P2(5)))
    s(32, _round(eph.omg / P2(31) / math.pi))
    s(24, _round(eph.OMGd / P2(43) / math.pi))
    s(8, _round(eph.tgd[0] / P2(31)))
    u(6, eph.svh)
    u(1, eph.flag)
    u(1, 0 if eph.fit > 0.0 else 1)
    return frame_rtcm3(b, i)


# --- type 1044: QZSS ephemeris (rtcm3e.c:942-1004) ----------------------------

def encode_1044(prn: int, eph: Eph) -> bytes:
    """QZSS LNAV ephemeris (prn 193-202)."""
    b = bytearray(64)
    i = 0

    def u(n, v):
        nonlocal i
        setbitu(b, i, n, int(v) & ((1 << n) - 1))
        i += n

    def s(n, v):
        nonlocal i
        setbits(b, i, n, int(v))
        i += n

    toc_tow, _ = time2gpst(eph.toc)
    u(12, 1044)
    u(4, prn - 192)
    u(16, _round(toc_tow / 16.0))
    s(8, _round(eph.f2 / P2(55)))
    s(16, _round(eph.f1 / P2(43)))
    s(22, _round(eph.f0 / P2(31)))
    u(8, eph.iode)
    s(16, _round(eph.crs / P2(5)))
    s(16, _round(eph.deln / P2(43) / math.pi))
    s(32, _round(eph.M0 / P2(31) / math.pi))
    s(16, _round(eph.cuc / P2(29)))
    u(32, _round(eph.e / P2(33)))
    s(16, _round(eph.cus / P2(29)))
    u(32, _round(math.sqrt(eph.A) / P2(19)))
    u(16, _round(eph.toes / 16.0))
    s(16, _round(eph.cic / P2(29)))
    s(32, _round(eph.OMG0 / P2(31) / math.pi))
    s(16, _round(eph.cis / P2(29)))
    s(32, _round(eph.i0 / P2(31) / math.pi))
    s(16, _round(eph.crc / P2(5)))
    s(32, _round(eph.omg / P2(31) / math.pi))
    s(24, _round(eph.OMGd / P2(43) / math.pi))
    s(14, _round(eph.idot / P2(43) / math.pi))
    u(2, eph.code)
    u(10, eph.week % 1024)
    u(4, eph.sva)
    u(6, eph.svh)
    s(8, _round(eph.tgd[0] / P2(31)))
    u(10, eph.iodc)
    u(1, 0 if eph.fit == 2.0 else 1)
    return frame_rtcm3(b, i)


# --- type 1020: GLONASS ephemeris (rtcm3e.c:816-895) --------------------------

def encode_1020(prn: int, geph: Geph) -> bytes:
    b = bytearray(64)
    i = 0

    def u(n, v):
        nonlocal i
        setbitu(b, i, n, int(v) & ((1 << n) - 1))
        i += n

    def g(n, v):
        nonlocal i
        setbitg(b, i, n, int(v))
        i += n

    fcn = geph.frq + 7
    t = timeadd(gpst2utc(geph.tof), 10800.0)
    ep = time2epoch(t)
    tk_h, tk_m = int(ep[3]), int(ep[4])
    tk_s = _round(ep[5] / 30.0)
    ep0 = [math.floor(ep[0] / 4.0) * 4.0, 1, 1, 0, 0, 0]
    NT = int(math.floor(timediff(t, epoch2time(ep0)) / 86400.0 + 1.0))
    t2 = timeadd(gpst2utc(geph.toe), 10800.0)
    ep2 = time2epoch(t2)
    tb = _round((ep2[3] * 3600.0 + ep2[4] * 60.0 + ep2[5]) / 900.0)

    u(12, 1020)
    u(6, prn)
    u(5, fcn)
    u(4, 0)
    u(5, tk_h)
    u(6, tk_m)
    u(1, tk_s)
    u(1, geph.svh)
    u(1, 0)
    u(7, tb)
    for j in range(3):
        g(24, _round(geph.vel[j] / P2(20) / 1e3))
        g(27, _round(geph.pos[j] / P2(11) / 1e3))
        g(5, _round(geph.acc[j] / P2(30) / 1e3))
    u(1, 0)
    g(11, _round(geph.gamn / P2(40)))
    u(3, 0)
    g(22, _round(geph.taun / P2(30)))
    u(5, _round(geph.dtaun / P2(30)))
    u(5, geph.age)
    u(1, 0)
    u(4, 0)
    u(11, NT)
    u(2, 0)
    u(1, 0)
    u(11, 0)
    u(32, 0)
    u(5, 0)
    u(22, 0)
    u(1, 0)
    u(7, 0)
    return frame_rtcm3(b, i)


# --- MSM7 (rtcm3e.c:1817-2310; single L1 C/A signal) --------------------------

_MSM_TYPE = {SYS_GPS: 1077, SYS_GLO: 1087, SYS_GAL: 1097, SYS_QZS: 1117,
             SYS_SBS: 1107, SYS_CMP: 1127}
# signal id 2 = "1C" for GPS/GLO/GAL/SBAS/QZS, "1I" (B1) for BeiDou —
# all at index 1 of their msm signal tables (reference
# lib/RTKLIB/src/rtcm3.c:58-99)
_SIG_ID = 2


def _wavelength(sys: int, fcn: int) -> float:
    """L1-band wavelength; for GLONASS ``fcn`` is the FDMA frequency
    channel number (-7..+6) — NOT the slot number (RTKLIB satwavelen uses
    nav->geph[].frq the same way, rtkcmn.c:3162-3189); BeiDou B1 sits at
    1561.098 MHz."""
    if sys == SYS_GLO:
        return CLIGHT / (FREQ1_GLO + fcn * DFRQ1_GLO)
    if sys == SYS_CMP:
        return CLIGHT / FREQ1_CMP
    return CLIGHT / FREQ1


def _msm_lock_ex(lock_s: float) -> int:
    """Extended lock-time indicator (RTKLIB to_msm_lock_ex, rtcm3e.c:134)."""
    ms = lock_s * 1000.0
    if ms < 64:
        return int(ms)
    for k in range(1, 21):
        lo = 64.0 * 2 ** (k - 1)
        if ms < lo * 2:
            return int((ms - lo) / 2 ** k + (64 + 32 * k))
    return 704


def encode_msm7(sys: int, obs_list, week: int, tow: float, staid: int = 0,
                lock_s: float = 100.0, sync: int = 0) -> bytes:
    """One MSM7 message for satellites of one system at one epoch.

    ``obs_list``: [(prn, P, L_cycles, D_hz, S_dbhz[, fcn]), ...] — the
    optional 6th element is the GLONASS frequency channel number used for
    the cycles<->metres conversion (defaults to 0, the center channel).
    """
    b = bytearray(300)
    i = 0

    def u(n, v):
        nonlocal i
        setbitu(b, i, n, int(v) & ((1 << n) - 1))
        i += n

    def s(n, v):
        nonlocal i
        setbits(b, i, n, int(v))
        i += n

    sats = sorted(obs_list, key=lambda o: o[0])
    nsat = len(sats)
    lam = {o[0]: _wavelength(sys, o[5] if len(o) > 5 else 0)
           for o in sats}
    # header (rtcm3e.c:1854-1877)
    u(12, _MSM_TYPE[sys])
    u(12, staid)
    if sys == SYS_GLO:
        # glonass msm epoch: dow + tod-ms of Moscow time (utc+3h), per
        # RTKLIB encode_msm_head (rtcm3e.c:1840-1845)
        from ..gtime import gpst2time, time2gpst
        gtow, _ = time2gpst(timeadd(gpst2utc(gpst2time(week, tow)),
                                    10800.0))
        dow = int(gtow // 86400.0)
        tod = _round((gtow % 86400.0) * 1000.0)
        u(30, (dow << 27) | (tod & 0x7FFFFFF))
    elif sys == SYS_CMP:
        # beidou msm epoch: BDT tow-ms (BDT = GPST - 14 s), per RTKLIB
        # encode_msm_head (rtcm3e.c:1846-1849)
        u(30, _round(((tow - 14.0) % 604800.0) * 1000.0))
    else:
        u(30, int(tow * 1000))
    u(1, sync)
    u(3, 0)
    u(7, 0)
    u(2, 0)
    u(2, 0)
    u(1, 0)
    u(3, 0)
    prn_base = {SYS_SBS: 119, SYS_QZS: 192}.get(sys, 0)
    ids = [o[0] - prn_base for o in sats]
    for j in range(1, 65):
        u(1, 1 if j in ids else 0)
    for j in range(1, 33):
        u(1, 1 if j == _SIG_ID else 0)
    for _ in range(nsat):          # cell mask: 1 signal per satellite
        u(1, 1)

    # satellite data (int ms, ext info, mod 1/1024 ms, rough rate)
    rr = [o[1] for o in sats]                       # rough range = P
    rrate = [-o[3] * lam[o[0]] for o in sats]       # m/s
    for r in rr:
        u(8, 255 if r == 0 else _round(r / RANGE_MS / P2(10)) >> 10)
    for o in sats:
        # extended satellite info: GLONASS carries fcn+7 (0..13) here —
        # the decoder derives the wavelength from it (rtcm3.c:1716-1720)
        u(4, (o[5] if len(o) > 5 else 0) + 7 if sys == SYS_GLO else 0)
    for r in rr:
        u(10, _round(r / RANGE_MS / P2(10)) & 0x3FF)
    for v in rrate:
        s(14, _round(v))

    # signal data: fine psr (20b/2^-29ms), fine phase (24b/2^-31ms),
    # lock ext (10b), half-amb (1b), cnr ext (10b/0.0625), rate (15b/1e-4)
    for o in sats:
        rough = _round(o[1] / RANGE_MS / P2(10)) * P2(10) * RANGE_MS
        s(20, _round((o[1] - rough) / RANGE_MS / P2(29)))
    for o in sats:
        rough = _round(o[1] / RANGE_MS / P2(10)) * P2(10) * RANGE_MS
        phr = o[2] * lam[o[0]] - rough
        s(24, -(1 << 23) if abs(phr) > 1171.0 else
          _round(phr / RANGE_MS / P2(31)))
    for _ in sats:
        u(10, _msm_lock_ex(lock_s))
    for _ in sats:
        u(1, 0)
    for o in sats:
        u(10, _round(o[4] / 0.0625))
    for o in sats:
        rough = _round(-o[3] * lam[o[0]])
        fine = -o[3] * lam[o[0]] - rough
        s(15, _round(fine / 0.0001))
    return frame_rtcm3(b, i)
