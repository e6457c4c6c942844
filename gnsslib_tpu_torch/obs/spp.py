"""Single-point positioning from pseudoranges.

Beyond-reference extension (the reference emits RINEX/RTCM for external
processing): iterative least squares on one epoch's pseudoranges with
light-time iteration, Sagnac (earth-rotation) correction, and SV clock
correction.  No iono/tropo models — intended for the framework's
synthesized-constellation validation and as the base for a full PVT.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..constants import CLIGHT, FREQ1, SYS_GLO
from ..gtime import gpst2time, GTime, timeadd
from .satpos import OMGE, eph2pos, geph2pos


@dataclasses.dataclass
class SppSolution:
    ok: bool
    pos: np.ndarray           # receiver ECEF (m)
    clk: float                # receiver clock bias (m)
    resid: np.ndarray         # post-fit residuals (m)
    nsat: int
    iters: int
    vel: np.ndarray = None    # receiver ECEF velocity (m/s), Doppler LS
    clk_drift: float = 0.0    # receiver clock drift (m/s)
    dop: dict = None          # {"gdop","pdop","hdop","vdop","tdop"}
    clk_sys: dict = None      # per-system receiver clock (m): {sys: clk}


def _sat_pos_at_tx(obs, eph, t_rx: GTime):
    """Satellite ECEF position/clock at transmission, with light-time
    iteration seeded by the pseudorange."""
    tau = obs.P / CLIGHT
    for _ in range(3):
        t_tx = timeadd(t_rx, -tau)
        if obs.sys == SYS_GLO:
            rs, dts = geph2pos(eph, t_tx)
        else:
            rs, dts = eph2pos(eph, t_tx)
        tau = obs.P / CLIGHT + dts
    return rs, dts, tau


def _sagnac(rs: np.ndarray, tau: float) -> np.ndarray:
    """Rotate the satellite position into the receive-time ECEF frame
    (earth rotated by OMGE*tau during flight)."""
    a = OMGE * tau
    c, s = math.cos(a), math.sin(a)
    return np.array([c * rs[0] + s * rs[1],
                     -s * rs[0] + c * rs[1], rs[2]])


def spp_solve(obs_list, ephs: dict, x0=None, max_iter: int = 10,
              raim_thresh: float = 0.0) -> SppSolution:
    """LS position from one epoch.

    ``obs_list``: SdrObs of one epoch.  ``ephs``: {(sys, prn): Eph|Geph}.
    ``x0``: optional (3,) ECEF seed (default: earth center + first
    iteration recovers; supply a rough position for faster convergence).
    ``raim_thresh``: when > 0 and redundancy allows (nsat >= 5), a
    post-fit residual above this many metres triggers single-satellite
    exclusion: re-solve without the worst satellite while it helps.
    """
    sol = _spp_once(obs_list, ephs, x0, max_iter)
    if raim_thresh <= 0.0 or not sol.ok:
        return sol
    obs_list = [o for o in obs_list if (o.sys, o.prn) in ephs]
    # exclusion requires the SURVIVING subset to keep redundancy (one
    # more than the 3+nclk unknowns): at zero redundancy every subset
    # fits exactly (zero residuals), so the "most consistent" pick is
    # arbitrary and often keeps the fault
    nclk = len(sol.clk_sys) if sol.clk_sys else 1
    while sol.nsat >= 5 + nclk and \
            float(np.max(np.abs(sol.resid))) > raim_thresh:
        # a biased measurement leaks into every post-fit residual, so the
        # largest residual does not reliably mark the faulty satellite:
        # try each single exclusion and keep the most consistent subset
        best, best_kept, best_rms = None, None, np.inf
        for skip in range(len(obs_list)):
            kept = obs_list[:skip] + obs_list[skip + 1:]
            trial = _spp_once(kept, ephs, sol.pos, max_iter)
            if trial.ok:
                rms = float(np.sqrt(np.mean(trial.resid ** 2)))
                if rms < best_rms:
                    best, best_kept, best_rms = trial, kept, rms
        if best is None or best_rms >= float(
                np.sqrt(np.mean(sol.resid ** 2))):
            break
        obs_list, sol = best_kept, best
    return sol


def _spp_once(obs_list, ephs: dict, x0, max_iter: int) -> SppSolution:
    use = [(o, ephs[(o.sys, o.prn)]) for o in obs_list
           if (o.sys, o.prn) in ephs]
    # one receiver-clock parameter PER SYSTEM: GPS-GLONASS pseudoranges
    # carry an inter-system bias (hardware/FDMA delays in real receivers;
    # in this framework also the half-chip nearest-neighbour convention,
    # whose time value differs per chip rate: 0.5/1.023M vs 0.5/0.511M s
    # = 146.8 m).  Standard practice (RTKLIB estimates GLONASS ICB too).
    syss = sorted({o.sys for o, _ in use})
    nclk = len(syss)
    sysi = {s: 3 + j for j, s in enumerate(syss)}
    if len(use) < 3 + nclk:
        return SppSolution(False, np.zeros(3), 0.0, np.zeros(0),
                           len(use), 0)
    t_rx = gpst2time(use[0][0].week, use[0][0].tow)
    x = np.zeros(3 + nclk)
    if x0 is not None:
        x[:3] = x0
    sats = []
    for o, e in use:
        rs, dts, tau = _sat_pos_at_tx(o, e, t_rx)
        rs = _sagnac(rs, tau)
        sats.append((rs, dts, o.P, sysi[o.sys]))
    it = 0
    for it in range(1, max_iter + 1):
        H = np.zeros((len(sats), 3 + nclk))
        v = np.zeros(len(sats))
        for k, (rs, dts, P, j) in enumerate(sats):
            d = x[:3] - rs
            r = float(np.linalg.norm(d))
            H[k, :3] = d / r
            H[k, j] = 1.0
            v[k] = P + CLIGHT * dts - (r + x[j])
        dx, *_ = np.linalg.lstsq(H, v, rcond=None)
        x += dx
        if float(np.linalg.norm(dx)) < 1e-4:
            break
    resid = np.array([P + CLIGHT * dts
                      - (float(np.linalg.norm(x[:3] - rs)) + x[j])
                      for rs, dts, P, j in sats])
    sol = SppSolution(True, x[:3].copy(), float(x[3]), resid,
                      len(sats), it)
    sol.clk_sys = {s: float(x[sysi[s]]) for s in syss}
    sol.dop = _dops(H, x[:3])
    sol.vel, sol.clk_drift = _vel_solve(
        use, [s[:3] for s in sats], x[:3], t_rx)
    return sol


def _dops(H: np.ndarray, pos: np.ndarray) -> dict:
    """Dilution-of-precision factors from the geometry matrix (ENU-rotated
    for the horizontal/vertical split)."""
    lat, lon, _ = ecef2llh(pos)
    sl, cl = math.sin(lat), math.cos(lat)
    so, co = math.sin(lon), math.cos(lon)
    R = np.array([[-so, co, 0.0],
                  [-sl * co, -sl * so, cl],
                  [cl * co, cl * so, sl]])       # ECEF -> ENU
    try:
        Q = np.linalg.inv(H.T @ H)
    except np.linalg.LinAlgError:
        return None
    Qp = R @ Q[:3, :3] @ R.T
    return dict(gdop=math.sqrt(max(np.trace(Q), 0.0)),
                pdop=math.sqrt(max(np.trace(Q[:3, :3]), 0.0)),
                hdop=math.sqrt(max(Qp[0, 0] + Qp[1, 1], 0.0)),
                vdop=math.sqrt(max(Qp[2, 2], 0.0)),
                tdop=math.sqrt(max(Q[3, 3], 0.0)))


def _carrier_freq(obs) -> float:
    if obs.sys == SYS_GLO:
        from ..constants import FREQ1_GLO, DFRQ1_GLO
        return FREQ1_GLO + obs.fcn * DFRQ1_GLO
    return FREQ1


def _vel_solve(use, sats, pos: np.ndarray, t_rx: GTime):
    """Receiver velocity + clock drift from Doppler least squares.

    This framework's Doppler convention (matching the reference's
    D = -(carrfreq - f_if - foffset), src/sdrtrk.c:177): positive D means
    the pseudorange INCREASES at c*D/f_carrier, so the measured range
    rate is rdot = c*D/f_cf.  Satellite velocity by central difference of
    the broadcast model."""
    rows = []
    z = []
    for (o, e), (rs, dts, P) in zip(use, sats):
        if o.D == 0.0:
            continue
        dt = 0.5
        tau = P / CLIGHT
        rp, _ = (geph2pos(e, timeadd(t_rx, dt - tau)) if o.sys == SYS_GLO
                 else eph2pos(e, timeadd(t_rx, dt - tau)))
        rm, _ = (geph2pos(e, timeadd(t_rx, -dt - tau)) if o.sys == SYS_GLO
                 else eph2pos(e, timeadd(t_rx, -dt - tau)))
        vs = (_sagnac(rp, tau) - _sagnac(rm, tau)) / (2.0 * dt)
        d = pos - rs
        e_los = d / np.linalg.norm(d)
        rdot_meas = CLIGHT * o.D / _carrier_freq(o)
        rows.append(np.concatenate([e_los, [1.0]]))
        z.append(rdot_meas + float(vs @ e_los))
    if len(rows) < 4:
        return None, 0.0
    A = np.asarray(rows)
    y = np.asarray(z)
    v, *_ = np.linalg.lstsq(A, y, rcond=None)
    return v[:3].copy(), float(v[3])


def predict_range(e, pos: np.ndarray, t_rx: GTime):
    """Predicted measured delay (s) and delay rate (s/s) for a receiver
    at ECEF ``pos`` receiving satellite ``e`` at GPST ``t_rx`` — the
    forward model of the solver (light-time, Sagnac, SV clock), used for
    position-aided hot starts."""
    from .satpos import satpos_any

    def tau_at(dt: float) -> float:
        tau_f = 0.075
        for _ in range(4):
            rs, dts = satpos_any(e, timeadd(t_rx, dt - tau_f))
            rs_r = _sagnac(rs, tau_f)
            tau_f = float(np.linalg.norm(rs_r - pos)) / CLIGHT
        return tau_f - dts

    tau0 = tau_at(0.0)
    rate = tau_at(0.5) - tau_at(-0.5)
    return tau0, rate


def ecef2llh(pos: np.ndarray):
    """WGS-84 ECEF -> geodetic (lat rad, lon rad, height m)."""
    a, f = 6378137.0, 1.0 / 298.257223563
    e2 = f * (2.0 - f)
    x, y, z = float(pos[0]), float(pos[1]), float(pos[2])
    r2 = x * x + y * y
    zz, zk = z, 0.0
    while abs(zz - zk) >= 1e-4:
        zk = zz
        sinp = zz / math.sqrt(r2 + zz * zz)
        v = a / math.sqrt(1.0 - e2 * sinp * sinp)
        zz = z + v * e2 * sinp
    lat = math.atan2(zz, math.sqrt(r2)) if r2 > 1e-12 else \
        (math.pi / 2.0 if z > 0.0 else -math.pi / 2.0)
    lon = math.atan2(y, x) if r2 > 1e-12 else 0.0
    h = math.sqrt(r2 + zz * zz) - (a / math.sqrt(
        1.0 - e2 * math.sin(lat) ** 2))
    return lat, lon, h
