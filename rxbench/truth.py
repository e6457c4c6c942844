"""The plain reference that decides ``correct``: what the receiver should
answer about each capture, worked out from the signal generator's own
parameters (:mod:`rxbench.sky`) in float64 numpy, and the comparison of
the receiver's answers with it.  It imports nothing of the receiver.

Answers judged, per job (one capture through one receiver):

* acquisition decisions: a decision names a PRN present in the capture
  and its code boundary within one chip of the truth (``acq_bad`` counts
  the others); ``acq_dop_err_hz`` is the largest distance of a decision's
  Doppler from the truth (the search picks a 200 Hz bin, and noise makes
  it the second or third nearest now and then); every present PRN is
  acquired once the job has run ``ACQ_DUE_S`` of signal (``acq_miss``);
* navigation data: each decoded LNAV subframe's ID and time of week, each
  RINEX ephemeris record, each SBAS frame on the TCP stream match the
  transmitted data (``nav_bad``); every present GPS PRN decodes each
  subframe that ended ``LATENCY_S`` before the job's end from the second
  on, writes its ephemeris once subframes 1-3 are in, and every SBAS
  message whose successor's preamble (the frame sync) is in by then
  reaches the stream (``nav_miss``);
* observables: epochs on the OUTMS grid without gaps, each with every
  present GPS PRN once the first epoch with a GPS satellite is
  ``OBS_SETTLE_S`` old (``obs_miss``); the pseudoranges, after a
  least-squares fit of the receiver's clock at each epoch and of the
  job's first epoch's stream time (the only unknowns), within
  ``pr_err_m`` of the truth.
"""
from __future__ import annotations

import datetime as _dt
import math
import re

import numpy as np

from . import sky as _sky

CLIGHT = 299792458.0
LATENCY_S = 1.5          # pipeline and framer latency before an answer is due
OBS_SETTLE_S = 2.0       # every present satellite is in the epochs by then
ACQ_DUE_S = 4.0          # two searches (ACQSLEEP 2 s) and their pipeline
EPOCH_DUE_S = 16.0       # subframe 1 (the week) ends at 12 s, then history
SBAS_DUE_S = 16.0        # the week, borrowed from a GPS channel, by ~12 s


# ------------------------------------------------------------ the truth
def doppler(sig: _sky.Signal, t, dtype=np.float64):
    """The Doppler (Hz) of ``sig`` at stream time ``t`` (s)."""
    return dtype(sig.doppler) + dtype(sig.rate) * np.asarray(t, dtype)


def chips(sig: _sky.Signal, t, dtype=np.float64):
    """The code chips of ``sig`` transmitted by stream time ``t`` (s),
    counted from TOW0 - LEAD (the generator's phase law), in ``dtype``."""
    t = np.asarray(t, dtype)
    dphi = dtype(sig.doppler) * t + dtype(0.5) * dtype(sig.rate) * t * t
    return dtype(sig.code_phase) + dtype(_sky.CRATE) * (
        t - dphi / dtype(_sky.F_CF))


def code_boundary(sig: _sky.Signal, at: int, f_sf: float,
                  dtype=np.float64) -> float:
    """Samples from stream sample ``at`` to the next code period start."""
    t = dtype(at) / dtype(f_sf)
    c = chips(sig, t, dtype)
    rate = dtype(_sky.CRATE) * (dtype(1.0) - doppler(sig, t, dtype)
                                / dtype(_sky.F_CF))
    return float(np.mod(-c, dtype(_sky.CLEN)) / rate * dtype(f_sf))


# ------------------------------------------------------------ parsing
def _tow(fields) -> float:
    y, mo, d, h, mi = (int(float(v)) for v in fields[:5])
    sec = float(fields[5])
    days = (_dt.date(y, mo, d) - _dt.date(1980, 1, 6)).days
    return (days % 7) * 86400.0 + h * 3600.0 + mi * 60.0 + sec


def parse_rinex_obs(text: str) -> list:
    """RINEX 3 observations -> [(tow, {(sys letter, prn): (P, L, D, S)})]
    in file order."""
    epochs, cur = [], None
    for ln in text.splitlines():
        if ln.startswith(">"):
            cur = {}
            epochs.append((round(_tow(ln[1:].split()), 4), cur))
        elif cur is not None and re.match(r"[GRSJ][ \d]\d", ln):
            vals = []
            for k in range(4):
                s = ln[3 + 16 * k:3 + 16 * k + 14].strip()
                vals.append(float(s) if s else math.nan)
            cur[(ln[0], int(ln[1:3]))] = tuple(vals)
    return epochs


_NAVF = re.compile(r"[ -]\.\d{12}E[+-]\d{2}")


def parse_rinex_nav(text: str) -> list:
    """GPS LNAV records of a RINEX 3 nav file -> [(prn, values)], values
    the record's broadcast orbit fields in file order."""
    recs = []
    lines = text.splitlines()
    i = next((k + 1 for k, ln in enumerate(lines)
              if "END OF HEADER" in ln), len(lines))
    while i < len(lines):
        ln = lines[i]
        if ln[:1] == "G":
            body = ln[23:] + "".join(lines[i + 1:i + 8])
            vals = [float(v.replace("E", "e")) for v in _NAVF.findall(body)]
            recs.append((int(ln[1:3]), vals))
            i += 8
        else:
            i += 1
    return recs


# RINEX 3 GPS record field order (after the clock terms): index of each
# compared field in :func:`parse_rinex_nav`'s values
NAV_FIELDS = dict(iode=3, M0=6, e=8, sqrtA=10, toes=11, OMG0=13, i0=15,
                  omg=17, week=21)


def parse_novatel_sbas(data: bytes) -> list:
    """NovAtel RAWSBASFRAME (id 973) stream -> [(payload 29 bytes, message
    type, tow)]."""
    out, i = [], 0
    while True:
        j = data.find(b"\xaa\x44\x12", i)
        if j < 0 or j + 80 > len(data):
            break
        frame = data[j:j + 80]
        if frame[4] | (frame[5] << 8) != 973:
            i = j + 1
            continue
        out.append((bytes(frame[40:69]), frame[36],
                    int.from_bytes(frame[16:20], "little") / 1000.0))
        i = j + 80
    return out


# ------------------------------------------------------------ judging
def judge_acq(job: dict, sky: _sky.Sky, f_sf: float
              ) -> tuple[int, int, float]:
    """(acq_bad, acq_miss, acq_dop_err_hz) of one job.  ``job["acq"]``
    holds the applied decisions: (prn, kind, code boundary in samples
    after ``at``, Doppler Hz, ``at``)."""
    bad = 0
    dop_err = 0.0
    got = set()
    for prn, kind, codei, dcarr, at in job["acq"]:
        sig = sky.by_prn(kind, prn)
        if sig is None:
            bad += 1
            continue
        got.add((kind, prn))
        dop = float(doppler(sig, at / f_sf))
        period = _sky.CLEN / (_sky.CRATE * (1.0 - dop / _sky.F_CF)) * f_sf
        err = (codei - code_boundary(sig, at, f_sf)) % period
        err = min(err, period - err)
        if err > f_sf / _sky.CRATE:
            bad += 1
        dop_err = max(dop_err, abs(-dcarr - dop))
    miss = 0
    if job["seconds"] >= ACQ_DUE_S:
        miss = sum((s.kind, s.prn) not in got for s in sky.signals)
    return bad, miss, dop_err


def judge_nav(job: dict, sky: _sky.Sky) -> tuple[int, int]:
    """(nav_bad, nav_miss) of one job."""
    bad = miss = 0
    end = job["seconds"] - LATENCY_S
    decoded = {}
    for ev in job["events"]:
        if ev[0] != "nav:decode" or ev[2] >= _sky.SBAS_FIRST:
            continue
        prn, sfid, tow = ev[2], int(ev[3]), float(ev[4])
        start = tow - 6.0 - _sky.TOW0
        if sky.by_prn("gps", prn) is None or _sky.lnav_sfid(
                tow - 6.0) != sfid or not _sky.LNAV_PAD - 1e-6 <= start \
                <= sky.seconds:
            bad += 1
            continue
        decoded.setdefault(prn, set()).add(round(start))
    for sig in sky.signals:
        if sig.kind != "gps":
            continue
        # subframes from the second on (start 12 s) that ended by ``end``
        last = int((min(end, sky.seconds) - _sky.LNAV_PAD) // 6.0)
        miss += sum(6 + 6 * j not in decoded.get(sig.prn, ())
                    for j in range(1, last))
    recs = parse_rinex_nav(job["rinex_nav"])
    for prn, vals in recs:
        if sky.by_prn("gps", prn) is None or len(vals) < 22:
            bad += 1
            continue
        eph = _sky.eph_rinex(prn)
        for name, idx in NAV_FIELDS.items():
            want = eph[name]
            if abs(vals[idx] - want) > 1e-10 * max(abs(want), 1e-30):
                bad += 1
                break
    if end >= _sky.LNAV_PAD + 18.0 + 6.0:
        have = {p for p, _ in recs}
        miss += sum(p not in have for p in sky.present("gps"))
    # SBAS: each frame carries a transmitted message of a present SBAS
    # PRN (two PRNs may send the same bits: their MT12 is the same), and
    # each message due arrives
    frames = parse_novatel_sbas(job["sbas_bytes"])
    sent, due = set(), {}
    for sig in sky.signals:
        if sig.kind != "sbas":
            continue
        for k, m in enumerate(sig.messages, -int(_sky.LEAD)):
            key = bytes(np.packbits(m[:232].astype(np.uint8)))
            sent.add(key)
            if SBAS_DUE_S <= k + 2 <= min(end, sky.seconds):
                due[key] = due.get(key, 0) + 1
    got = {}
    for payload, _, _ in frames:
        if payload not in sent:
            bad += 1
        got[payload] = got.get(payload, 0) + 1
    miss += sum(max(n - got.get(key, 0), 0) for key, n in due.items())
    return bad, miss


def judge_obs(job: dict, sky: _sky.Sky) -> tuple[int, float]:
    """(obs_miss, pr_err_m) of one job."""
    epochs = parse_rinex_obs(job["rinex_obs"])
    outs = job["outms"] / 1000.0
    miss = 0
    if not epochs:
        return int(job["seconds"] >= EPOCH_DUE_S), 0.0
    tows = np.array([t for t, _ in epochs])
    steps = np.round(np.diff(tows) / outs)
    miss += int(np.sum(np.maximum(steps - 1, 0)))
    gps = sky.present("gps")
    first = next((t for t, obs in epochs if any(s == "G" for s, _ in obs)),
                 None)
    if first is None:
        miss += int(job["seconds"] >= EPOCH_DUE_S) * len(gps)
    rows = []
    for k, (tow, obs) in enumerate(epochs):
        if first is not None and tow - first >= OBS_SETTLE_S:
            miss += sum(("G", p) not in obs for p in gps)
        rows += [(k, tow, sky.by_prn("gps", p), v[0])
                 for (s, p), v in obs.items()
                 if s == "G" and sky.by_prn("gps", p) is not None
                 and np.isfinite(v[0])]
    return miss, _pr_residual(rows)


def _pr_residual(rows) -> float:
    """Largest pseudorange residual (m) over a job's epochs.  Each GPS
    observation (epoch k at time of week tow_k, satellite i) obeys
    P / c + code_phase_i / CRATE = a_k + dphi_i(t_k) / F_CF, with a_k
    the receiver's clock at epoch k (free), dphi_i the integral of the
    satellite's Doppler and t_k the epoch's stream time, t_k = t_0 +
    (tow_k - tow_0) (one unknown t_0 per job, fitted by Gauss-Newton: the
    sample clock and the epoch grid differ by parts per million,
    centimetres here)."""
    if not rows:
        return 0.0
    k = np.array([r[0] for r in rows])
    tow = np.array([r[1] for r in rows], np.float64)
    d = np.array([s.doppler for _, _, s, _ in rows], np.float64)
    r = np.array([s.rate for _, _, s, _ in rows], np.float64)
    y = np.array([p / CLIGHT + s.code_phase / _sky.CRATE
                  for _, _, s, p in rows], np.float64)
    ds = tow - tow.min()
    n = np.bincount(k)
    keep = n[k] >= 2
    if not keep.any():
        return 0.0

    def demean(v):
        return v - (np.bincount(k, weights=v) / np.maximum(n, 1))[k]

    def resid(t0):
        t = t0 + ds
        return demean(y - (d * t + 0.5 * r * t * t) / _sky.F_CF)
    t0 = 0.0
    for _ in range(8):
        xd = demean((d + r * (t0 + ds)) / _sky.F_CF)
        t0 += float(np.sum(xd[keep] * resid(t0)[keep])
                    / np.sum(xd[keep] ** 2))
    return float(np.max(np.abs(resid(t0)[keep])) * CLIGHT)


def control_observables(job: dict, sky: _sky.Sky, dtype) -> str:
    """The reference put in the receiver's place: the job's epochs with
    every present GPS PRN's pseudorange worked out from the truth in
    ``dtype``: the time since TOW0 - LEAD at the epoch less the chips
    sent by then over CRATE (the stream time taken as the epoch's less
    75 ms of flight),
    written as RINEX text for :func:`judge_obs`."""
    lines = []
    for tow, obs in parse_rinex_obs(job["rinex_obs"]):
        since = tow - _sky.TOW0 + _sky.LEAD    # exact in float64
        t_e = since - _sky.LEAD - 0.075
        lines.append(_epoch_line(tow, len(sky.present("gps"))))
        for p in sky.present("gps"):
            sig = sky.by_prn("gps", p)
            flight = dtype(since) - chips(sig, dtype(t_e), dtype) \
                / dtype(_sky.CRATE)
            pr = float(flight * dtype(CLIGHT))
            lines.append(f"G{p:02d}{pr:14.3f}  ")
    return "\n".join(lines) + "\n"


def _epoch_line(tow: float, n: int) -> str:
    day, sod = divmod(tow, 86400.0)
    d = _dt.date(1980, 1, 6) + _dt.timedelta(days=_sky.WEEK * 7 + day)
    h, rem = divmod(sod, 3600.0)
    m, s = divmod(rem, 60.0)
    return (f"> {d.year:4d} {d.month:2d} {d.day:2d} {int(h):2d} "
            f"{int(m):2d}{s:11.7f}  0{n:3d}")


def judge(job: dict, sky: _sky.Sky, f_sf: float) -> dict:
    """Every number of one job."""
    acq_bad, acq_miss, dop_err = judge_acq(job, sky, f_sf)
    nav_bad, nav_miss = judge_nav(job, sky)
    obs_miss, pr_err = judge_obs(job, sky)
    return dict(acq_bad=acq_bad, acq_miss=acq_miss, acq_dop_err_hz=dop_err,
                nav_bad=nav_bad,
                nav_miss=nav_miss, obs_miss=obs_miss, pr_err_m=pr_err)
