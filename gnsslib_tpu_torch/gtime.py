"""GNSS time systems — RTKLIB-compatible gtime arithmetic.

Equivalents of the RTKLIB time functions the reference links
(epoch2time/time2epoch/gpst2time/time2gpst/utc2gpst/adjgpsweek — used in
sdrnav_gps.c, sdrnav_glo.c, sdrout.c) plus the GLONASS day-number
conversion (reference: src/sdrnav_glo.c:118-151).

Times are (seconds, fractional-seconds) pairs anchored at the Unix epoch,
matching RTKLIB's gtime_t so RINEX output is numerically identical.
"""
from __future__ import annotations

import dataclasses
import math

GPST0 = (1980, 1, 6, 0, 0, 0)  # GPS time reference epoch

# leap seconds table: UTC epoch -> GPST-UTC (RTKLIB rtkcmn.c leaps[])
_LEAPS = (
    ((2017, 1, 1, 0, 0, 0), -18),
    ((2015, 7, 1, 0, 0, 0), -17),
    ((2012, 7, 1, 0, 0, 0), -16),
    ((2009, 1, 1, 0, 0, 0), -15),
    ((2006, 1, 1, 0, 0, 0), -14),
    ((1999, 1, 1, 0, 0, 0), -13),
    ((1997, 7, 1, 0, 0, 0), -12),
    ((1996, 1, 1, 0, 0, 0), -11),
    ((1994, 7, 1, 0, 0, 0), -10),
    ((1993, 7, 1, 0, 0, 0), -9),
    ((1992, 7, 1, 0, 0, 0), -8),
    ((1991, 1, 1, 0, 0, 0), -7),
    ((1990, 1, 1, 0, 0, 0), -6),
    ((1988, 1, 1, 0, 0, 0), -5),
    ((1985, 7, 1, 0, 0, 0), -4),
    ((1983, 7, 1, 0, 0, 0), -3),
    ((1982, 7, 1, 0, 0, 0), -2),
    ((1981, 7, 1, 0, 0, 0), -1),
)


@dataclasses.dataclass(frozen=True)
class GTime:
    """Time as integer seconds since Unix epoch + fraction (RTKLIB gtime_t)."""
    time: int = 0
    sec: float = 0.0

    def __add__(self, dt: float) -> "GTime":
        return timeadd(self, dt)

    def __sub__(self, other: "GTime") -> float:
        return timediff(self, other)


_DOY = (1, 32, 60, 91, 121, 152, 182, 213, 244, 274, 305, 335)


def epoch2time(ep) -> GTime:
    """Calendar epoch [y,m,d,h,m,s] -> GTime (RTKLIB epoch2time)."""
    year, mon, day = int(ep[0]), int(ep[1]), int(ep[2])
    if year < 1970 or year > 2099 or mon < 1 or mon > 12:
        return GTime(0, 0.0)
    days = (year - 1970) * 365 + (year - 1969) // 4 + _DOY[mon - 1] + day - 2
    if year % 4 == 0 and mon >= 3:
        days += 1
    sec = int(math.floor(ep[5]))
    t = days * 86400 + int(ep[3]) * 3600 + int(ep[4]) * 60 + sec
    return GTime(t, float(ep[5]) - sec)


def time2epoch(t: GTime):
    """GTime -> calendar epoch [y,m,d,h,m,s] (RTKLIB time2epoch)."""
    mday = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31,
            31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31,
            31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31,
            31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
    days = t.time // 86400
    sec = t.time - days * 86400
    day = days % 1461
    mon = 0
    for mon in range(48):
        if day >= mday[mon]:
            day -= mday[mon]
        else:
            break
    year = 1970 + (days // 1461) * 4 + mon // 12
    return [year, mon % 12 + 1, day + 1,
            sec // 3600, (sec % 3600) // 60, sec % 60 + t.sec]


def timeadd(t: GTime, sec: float) -> GTime:
    tt = t.sec + sec
    f = math.floor(tt)
    return GTime(t.time + int(f), tt - f)


def timediff(t1: GTime, t2: GTime) -> float:
    return (t1.time - t2.time) + (t1.sec - t2.sec)


def gpst2time(week: int, sec: float) -> GTime:
    """GPS week + tow -> GTime (RTKLIB gpst2time)."""
    t = epoch2time(GPST0)
    if sec < -1e9 or sec > 1e9:
        sec = 0.0
    t = GTime(t.time + 86400 * 7 * int(week), 0.0)
    return timeadd(t, sec)


def time2gpst(t: GTime) -> tuple[float, int]:
    """GTime -> (tow, week) (RTKLIB time2gpst)."""
    t0 = epoch2time(GPST0)
    sec = t.time - t0.time
    week = sec // (86400 * 7)
    tow = sec - week * 86400 * 7 + t.sec
    return tow, int(week)


def utc2gpst(t: GTime) -> GTime:
    """UTC -> GPST applying leap seconds (RTKLIB utc2gpst)."""
    for ep, leap in _LEAPS:
        if timediff(t, epoch2time(ep)) >= 0.0:
            return timeadd(t, -leap)
    return t


def gpst2utc(t: GTime) -> GTime:
    """GPST -> UTC applying leap seconds (RTKLIB gpst2utc)."""
    for ep, leap in _LEAPS:
        tu = timeadd(t, leap)
        if timediff(tu, epoch2time(ep)) >= 0.0:
            return tu
    return t


def adjgpsweek(week: int, ref_week: int = 2200) -> int:
    """Adjust 10-bit GPS week to full week number (RTKLIB adjgpsweek).

    RTKLIB resolves against the current date; for deterministic
    post-processing we resolve against ``ref_week`` (default mid-2022,
    override from decoded data or config when replaying old captures).
    """
    return week + (ref_week - week + 512) // 1024 * 1024


def glot2time(nt: int, n4: int, h: int, m: int, s: int) -> GTime:
    """GLONASS day-number/4-year-interval + Moscow time -> GPST.

    Reference algorithm: src/sdrnav_glo.c:118-151 (GLONASS ICD A.3.1.3).
    """
    doys = (1, 32, 60, 91, 121, 152, 182, 213, 244, 274, 305, 335)
    doysl = (1, 32, 61, 92, 122, 153, 183, 214, 245, 275, 306, 336)
    j, doy = 0, 0
    if nt <= 366:
        j, doy = 1, nt
    elif nt <= 731:
        j, doy = 2, nt - 366 + 1
    elif nt <= 1096:
        j, doy = 3, nt - 731 + 1
    elif nt <= 1461:
        j, doy = 4, nt - 1096 + 1
    year = 1996 + 4 * (n4 - 1) + (j - 1)
    table = doysl if j == 1 else doys
    day = 0
    for mon in range(1, 12):
        if doy < table[mon]:
            day = doy - table[mon - 1]
            break
    else:
        mon = 12
        day = doy - table[11]
    return utc2gpst(epoch2time([year, mon, day, h, m, s]))
