"""RINEX 3.02 observation and navigation writers.

Byte-format compatible with the reference's RTKLIB-produced output
(golden headers: the reference output/sdr_*.obs/.nav; body format:
RTKLIB rinex.c outrnxobsh/obsb/navh/navb/gnavb as configured by
createrinexopt, reference src/sdrout.c:33-208): RINEX 3.02, L1-only
C1C/L1C/D1C/S1C for G/R/E/J/S/C.
"""
from __future__ import annotations

import math

from ..constants import SYS_GPS, SYS_GLO, SYS_GAL, SYS_QZS, SYS_SBS, SYS_CMP
from ..gtime import GTime, gpst2time, gpst2utc, time2epoch, time2gpst
from ..nav.eph import Eph, Geph
from .epoch import SdrObs

PROG = "GNSSLIB-TPU v0.1"
_SYSCHARS = "GREJSC"

_URA_EPH = (2.4, 3.4, 4.85, 6.85, 9.65, 13.65, 24.0, 48.0, 96.0, 192.0,
            384.0, 768.0, 1536.0, 3072.0, 6144.0)


def _ura_value(sva: int) -> float:
    return _URA_EPH[sva] if 0 <= sva < 15 else 32767.0


def _satid(sys: int, prn: int) -> str:
    """3-char RINEX satellite id (RTKLIB sat2code)."""
    if sys == SYS_GPS:
        return f"G{prn:02d}"
    if sys == SYS_GLO:
        return f"R{prn:02d}"
    if sys == SYS_GAL:
        return f"E{prn:02d}"
    if sys == SYS_QZS:
        return f"J{prn - 192:02d}"
    if sys == SYS_SBS:
        return f"S{prn - 100:02d}"
    if sys == SYS_CMP:
        return f"C{prn:02d}"
    return "   "


def _navf(v: float) -> str:
    """RTKLIB outnavf: ' %s.%012.0fE%+03.0f' (19-char field)."""
    e = 0.0 if abs(v) < 1e-99 else math.floor(math.log10(abs(v)) + 1.0)
    mant = abs(v) / (10.0 ** (e - 12.0))
    return f" {'-' if v < 0 else ' '}.{mant:012.0f}E{e:+03.0f}"


def _hline(content: str, label: str) -> str:
    return f"{content:<60.60s}{label:<20s}\n"


def _obsf(v: float) -> str:
    """RTKLIB outrnxobsf with lli<=0: F14.3 + 2 blanks, zero -> blanks."""
    if v == 0.0 or v <= -1e9 or v >= 1e9:
        return " " * 14 + "  "
    return f"{v:14.3f}  "


class RinexObsWriter:
    """RINEX 3.02 observation file (header on open, one record per epoch)."""

    def __init__(self, path: str, date_utc=None, prog: str = PROG):
        self.path = path
        ts = ("" if date_utc is None else
              f"{date_utc[0]:04d}{date_utc[1]:02d}{date_utc[2]:02d} "
              f"{date_utc[3]:02d}{date_utc[4]:02d}{date_utc[5]:02d} UTC")
        with open(path, "w") as f:
            f.write(_hline("     3.02           OBSERVATION DATA    "
                           "M: Mixed", "RINEX VERSION / TYPE"))
            f.write(_hline(f"{prog:<40.40s}{ts}", "PGM / RUN BY / DATE"))
            for lbl in ("MARKER NAME", "MARKER NUMBER", "MARKER TYPE",
                        "OBSERVER / AGENCY"):
                f.write(_hline("", lbl))
            f.write(_hline(f"{'GNSSLIB-TPU':<20s}{'GNSSLIB-TPU':<20s}"
                           f"{'0.1':<20s}", "REC # / TYPE / VERS"))
            f.write(_hline("", "ANT # / TYPE"))
            f.write(_hline(f"{0.0:14.4f}{0.0:14.4f}{0.0:14.4f}",
                           "APPROX POSITION XYZ"))
            f.write(_hline(f"{0.0:14.4f}{0.0:14.4f}{0.0:14.4f}",
                           "ANTENNA: DELTA H/E/N"))
            for s in _SYSCHARS:
                f.write(_hline(f"{s}    4 C1C L1C D1C S1C",
                               "SYS / # / OBS TYPES"))
            f.write(_hline(f"{1970:6d}{1:6d}{1:6d}{0:6d}{0:6d}{0.0:13.7f}"
                           f"     {'GPS':<3s}", "TIME OF FIRST OBS"))
            f.write(_hline(f"{1970:6d}{1:6d}{1:6d}{0:6d}{0:6d}{0.0:13.7f}"
                           f"     {'GPS':<3s}", "TIME OF LAST OBS"))
            for s in _SYSCHARS:
                f.write(_hline(s, "SYS / PHASE SHIFT"))
            f.write(_hline(f"{0:3d}", "GLONASS SLOT / FRQ #"))
            f.write(_hline(" C1C    0.000 C1P    0.000 C2C    0.000 "
                           "C2P    0.000", "GLONASS COD/PHS/BIS"))
            f.write(_hline("", "END OF HEADER"))

    def write_epoch(self, obs: list[SdrObs]) -> None:
        """One '> ...' epoch record + per-satellite lines (RTKLIB
        outrnxobsb ver.3 path with SNR quantized to 0.25 dB like
        sdrobs2obsd, reference src/sdrout.c:63-86 + rinex.c:2034-2071)."""
        if not obs:
            return
        t = gpst2time(obs[0].week, obs[0].tow)
        ep = time2epoch(t)
        with open(self.path, "a") as f:
            f.write(f"> {ep[0]:4.0f} {ep[1]:2.0f} {ep[2]:2.0f} {ep[3]:2.0f} "
                    f"{ep[4]:2.0f}{ep[5]:11.7f}  {0:d}{len(obs):3d}"
                    f"{'':21s}\n")
            for o in obs:
                snr_q = int(o.S * 4.0 + 0.5) * 0.25
                line = (f"{_satid(o.sys, o.prn):<3s}" + _obsf(o.P)
                        + _obsf(o.L) + _obsf(o.D) + _obsf(snr_q))
                f.write(line.rstrip() + "\n")


class RinexNavWriter:
    """RINEX 3.02 mixed navigation file."""

    def __init__(self, path: str, date_utc=None, prog: str = PROG):
        self.path = path
        ts = ("" if date_utc is None else
              f"{date_utc[0]:04d}{date_utc[1]:02d}{date_utc[2]:02d} "
              f"{date_utc[3]:02d}{date_utc[4]:02d}{date_utc[5]:02d} UTC")
        with open(path, "w") as f:
            f.write(_hline("     3.02           N: GNSS NAV DATA    "
                           "M: Mixed", "RINEX VERSION / TYPE"))
            f.write(_hline(f"{prog:<40.40s}{ts}", "PGM / RUN BY / DATE"))
            f.write(_hline("", "END OF HEADER"))

    def write_eph(self, sys: int, prn: int, eph: Eph) -> None:
        """GPS/QZS LNAV record (RTKLIB outrnxnavb ver.3)."""
        ep = time2epoch(eph.toc)
        sep = "    "
        ttr_tow, ttr_week = time2gpst(eph.ttr)
        rows = [
            (eph.f0, eph.f1, eph.f2),
            (eph.iode, eph.crs, eph.deln, eph.M0),
            (eph.cuc, eph.e, eph.cus, math.sqrt(eph.A)),
            (eph.toes, eph.cic, eph.OMG0, eph.cis),
            (eph.i0, eph.crc, eph.omg, eph.OMGd),
            (eph.idot, eph.code, eph.week, eph.flag),
            (_ura_value(eph.sva), eph.svh, eph.tgd[0], eph.iodc),
            (ttr_tow + (ttr_week - eph.week) * 604800.0, eph.fit),
        ]
        with open(self.path, "a") as f:
            f.write(f"{_satid(sys, prn):<3s} {ep[0]:04.0f} {ep[1]:2.0f} "
                    f"{ep[2]:2.0f} {ep[3]:2.0f} {ep[4]:2.0f} {ep[5]:2.0f}")
            for vals in rows:
                f.write("".join(_navf(float(v)) for v in vals))
                if vals is not rows[-1]:
                    f.write(f"\n{sep}")
            f.write("\n")

    def write_geph(self, prn: int, geph: Geph) -> None:
        """GLONASS record (RTKLIB outrnxgnavb ver.3: toe/tof in UTC)."""
        tof, _ = time2gpst(gpst2utc(geph.tof))
        toe = gpst2utc(geph.toe)
        ep = time2epoch(toe)
        sep = "    "
        rows = [
            (-geph.taun, geph.gamn, tof),
            (geph.pos[0] / 1e3, geph.vel[0] / 1e3, geph.acc[0] / 1e3,
             geph.svh),
            (geph.pos[1] / 1e3, geph.vel[1] / 1e3, geph.acc[1] / 1e3,
             geph.frq),
            (geph.pos[2] / 1e3, geph.vel[2] / 1e3, geph.acc[2] / 1e3,
             geph.age),
        ]
        with open(self.path, "a") as f:
            f.write(f"{_satid(SYS_GLO, prn):<3s} {ep[0]:04.0f} {ep[1]:2.0f} "
                    f"{ep[2]:2.0f} {ep[3]:2.0f} {ep[4]:2.0f} {ep[5]:2.0f}")
            for vals in rows:
                f.write("".join(_navf(float(v)) for v in vals))
                if vals is not rows[-1]:
                    f.write(f"\n{sep}")
            f.write("\n")
