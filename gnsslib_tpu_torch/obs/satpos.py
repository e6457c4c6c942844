"""Broadcast-ephemeris satellite position / clock.

Beyond-reference extension: the reference receiver stops at RINEX/RTCM
output and leaves positioning to an external tool (README.md:23-44).
These are the textbook broadcast models so the framework can close the
loop to coordinates (obs/spp.py):

* GPS/QZSS: IS-GPS-200 Keplerian elements + harmonic corrections.
* GLONASS: ICD L1/L2 state-vector integration (RK4, PZ-90 -> inertial
  terms folded into the standard ECEF-with-Coriolis form).
"""
from __future__ import annotations

import math

import numpy as np

from ..gtime import GTime, timediff

MU_GPS = 3.9860050e14       # WGS-84 GM used by IS-GPS-200 (m^3/s^2)
MU_GLO = 398600.44e9        # PZ-90 GM (m^3/s^2)
OMGE = 7.2921151467e-5      # WGS-84 earth rotation rate (rad/s)
OMGE_GLO = 7.292115e-5      # PZ-90 earth rotation rate (rad/s)
RE_GLO = 6378136.0          # PZ-90 earth radius (m)
J2_GLO = 1.0826257e-3       # PZ-90 second zonal harmonic


def eph2clk(eph, t: GTime) -> float:
    """SV clock bias (s) at GPST ``t`` (IS-GPS-200 20.3.3.3.3.1;
    relativistic term handled in eph2pos)."""
    dt = timediff(t, eph.toc)
    for _ in range(2):
        dt = timediff(t, eph.toc) - (eph.f0 + eph.f1 * dt + eph.f2 * dt * dt)
    return eph.f0 + eph.f1 * dt + eph.f2 * dt * dt


def eph2pos(eph, t: GTime):
    """GPS/QZS satellite ECEF position (m) and clock bias (s) at GPST
    ``t`` (signal transmission time).

    Returns (rs[3] ndarray, dts).
    """
    tk = timediff(t, eph.toe)
    A = eph.A
    n = math.sqrt(MU_GPS / A ** 3) + eph.deln
    M = eph.M0 + n * tk
    # Kepler's equation, Newton iteration
    E = M
    for _ in range(30):
        dE = (E - eph.e * math.sin(E) - M) / (1.0 - eph.e * math.cos(E))
        E -= dE
        if abs(dE) < 1e-13:
            break
    sinE, cosE = math.sin(E), math.cos(E)
    nu = math.atan2(math.sqrt(1.0 - eph.e ** 2) * sinE, cosE - eph.e)
    phi = nu + eph.omg
    s2p, c2p = math.sin(2.0 * phi), math.cos(2.0 * phi)
    du = eph.cus * s2p + eph.cuc * c2p
    dr = eph.crs * s2p + eph.crc * c2p
    di = eph.cis * s2p + eph.cic * c2p
    u = phi + du
    r = A * (1.0 - eph.e * cosE) + dr
    i = eph.i0 + di + eph.idot * tk
    OMG = (eph.OMG0 + (eph.OMGd - OMGE) * tk - OMGE * eph.toes)
    x, y = r * math.cos(u), r * math.sin(u)
    cosO, sinO = math.cos(OMG), math.sin(OMG)
    cosi = math.cos(i)
    rs = np.array([x * cosO - y * cosi * sinO,
                   x * sinO + y * cosi * cosO,
                   y * math.sin(i)])
    # clock: polynomial + relativistic correction
    dts = eph2clk(eph, t) - 2.0 * math.sqrt(MU_GPS * A) * eph.e * sinE \
        / (299792458.0 ** 2)
    return rs, dts


def _glo_deriv(x: np.ndarray, acc) -> np.ndarray:
    """GLONASS ICD equations of motion in ECEF (PZ-90)."""
    r2 = x[0] ** 2 + x[1] ** 2 + x[2] ** 2
    r3 = r2 * math.sqrt(r2)
    omg2 = OMGE_GLO ** 2
    a = 1.5 * J2_GLO * MU_GLO * RE_GLO ** 2 / r2 / r3
    b = 5.0 * x[2] ** 2 / r2
    c = -MU_GLO / r3 - a * (1.0 - b)
    return np.array([
        x[3], x[4], x[5],
        (c + omg2) * x[0] + 2.0 * OMGE_GLO * x[4] + acc[0],
        (c + omg2) * x[1] - 2.0 * OMGE_GLO * x[3] + acc[1],
        (c - 2.0 * a) * x[2] + acc[2]])


def satpos_any(e, t: GTime):
    """Dispatch on ephemeris kind: GPS/QZS Eph (has Keplerian ``A``) vs
    GLONASS Geph (has a ``pos`` state vector)."""
    if hasattr(e, "A"):
        return eph2pos(e, t)
    return geph2pos(e, t)


def geph2pos(geph, t: GTime, step: float = 60.0):
    """GLONASS satellite ECEF position (m) and clock bias (s) at ``t``
    (GPST): RK4 integration of the broadcast state vector from toe."""
    tk = timediff(t, geph.toe)
    x = np.array(list(geph.pos) + list(geph.vel), float)
    acc = np.asarray(geph.acc, float)
    tt = -step if tk < 0.0 else step
    while abs(tk) > 1e-9:
        h = tk if abs(tk) < abs(tt) else tt
        k1 = _glo_deriv(x, acc)
        k2 = _glo_deriv(x + k1 * h / 2.0, acc)
        k3 = _glo_deriv(x + k2 * h / 2.0, acc)
        k4 = _glo_deriv(x + k3 * h, acc)
        x = x + (k1 + 2.0 * k2 + 2.0 * k3 + k4) * h / 6.0
        tk -= h
    dts = -geph.taun + geph.gamn * timediff(t, geph.toe)
    return x[:3].copy(), dts
