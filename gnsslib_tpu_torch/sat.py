"""Satellite numbering — RTKLIB-compatible satno/satsys/satid conversion.

The reference links RTKLIB's rtkcmn.c for these (used at sdrinit.c:593,609
and throughout nav/obs).  Same uniform numbering: GPS, GLONASS, Galileo,
QZSS, BeiDou, SBAS concatenated into one 1-based satellite index space.
"""
from __future__ import annotations

from . import constants as C

_ORDER = (
    (C.SYS_GPS, C.MINPRNGPS, C.NSATGPS),
    (C.SYS_GLO, C.MINPRNGLO, C.NSATGLO),
    (C.SYS_GAL, C.MINPRNGAL, C.NSATGAL),
    (C.SYS_QZS, C.MINPRNQZS, C.NSATQZS),
    (C.SYS_CMP, C.MINPRNCMP, C.NSATCMP),
    (C.SYS_SBS, C.MINPRNSBS, C.NSATSBS),
)

_SYS_CHAR = {
    C.SYS_GPS: "G",
    C.SYS_GLO: "R",
    C.SYS_GAL: "E",
    C.SYS_QZS: "J",
    C.SYS_CMP: "C",
    C.SYS_SBS: "S",
}
_CHAR_SYS = {v: k for k, v in _SYS_CHAR.items()}


def satno(sys: int, prn: int) -> int:
    """System + PRN -> uniform satellite number (0 on error)."""
    base = 0
    for s, minprn, nsat in _ORDER:
        if s == sys:
            if not (minprn <= prn < minprn + nsat):
                return 0
            return base + prn - minprn + 1
        base += nsat
    return 0


def satsys(sat: int) -> tuple[int, int]:
    """Uniform satellite number -> (system, prn); (SYS_NONE, 0) on error."""
    base = 0
    for s, minprn, nsat in _ORDER:
        if base < sat <= base + nsat:
            return s, sat - base - 1 + minprn
        base += nsat
    return C.SYS_NONE, 0


def satno2id(sat: int) -> str:
    """Uniform satellite number -> id string like 'G05', 'R12', 'S33'.

    RTKLIB prints QZSS as J+(prn-192) and SBAS as PRN-100.
    """
    sys, prn = satsys(sat)
    if sys == C.SYS_NONE:
        return ""
    if sys == C.SYS_QZS:
        prn -= 192
    elif sys == C.SYS_SBS:
        prn -= 100
    return f"{_SYS_CHAR[sys]}{prn:02d}"


def satid2no(sid: str) -> int:
    """Id string -> uniform satellite number (0 on error)."""
    sid = sid.strip()
    if len(sid) < 2 or sid[0] not in _CHAR_SYS:
        return 0
    try:
        prn = int(sid[1:])
    except ValueError:
        return 0
    sys = _CHAR_SYS[sid[0]]
    if sys == C.SYS_QZS:
        prn += 192
    elif sys == C.SYS_SBS:
        prn += 100
    return satno(sys, prn)
