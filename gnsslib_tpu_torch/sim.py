"""GNSS IF-signal synthesizer — the framework's test oracle.

The reference verifies itself against >100 MB real captures
(test/testdata_download_link.txt); this module replaces those fixtures with
deterministic synthesized IF streams whose ground truth (code phase,
Doppler, C/N0, nav bits) is known exactly, enabling closed-loop unit tests
the reference never had (SURVEY.md §4).

Sign conventions follow the reference receiver so recovered values compare
directly (see ops.carrier.mix_carrier): a satellite simulated with Doppler
``D`` is acquired at carrier frequency ``f_if + foffset - D`` and reported
by the tracker as Doppler ``D`` (src/sdrtrk.c:177).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import codes
from .constants import DType, CodeType


@dataclasses.dataclass
class SimChannel:
    """One simulated satellite signal."""
    prn: int
    ctype: int = CodeType.L1CA
    doppler: float = 0.0          # receiver-convention Doppler D (Hz)
    doppler_rate: float = 0.0     # Doppler rate dD/dt (Hz/s; dynamics)
    code_phase: float = 0.0       # code phase at t=0 (chips, [0, clen))
    carr_phase: float = 0.0       # carrier phase at t=0 (cycles)
    amplitude: float = 1.0
    nav_bits: np.ndarray | None = None   # ±1 bits at nav_ms boundaries
    nav_ms: float = 20.0          # nav bit length (ms)
    f_cf: float = 1.57542e9       # carrier frequency for code-Doppler aiding
    foffset: float = 0.0          # FDMA / clock offset (Hz)


def synthesize(channels, f_sf: float, f_if: float, dtype: int,
               nsamples: int, noise_std: float = 0.0, seed: int = 0,
               t0: float = 0.0) -> np.ndarray:
    """Synthesize an IF sample stream.

    Returns float64 samples: shape (nsamples,) for real sampling (DTYPEI)
    or (nsamples, 2) I/Q for complex sampling (DTYPEIQ).  Quantize with
    :func:`quantize_int8` to produce file-format bytes.
    """
    rng = np.random.default_rng(seed)
    t = (t0 + np.arange(nsamples, dtype=np.float64)) / f_sf
    if dtype == DType.IQ:
        out = np.zeros((nsamples, 2), dtype=np.float64)
    else:
        out = np.zeros(nsamples, dtype=np.float64)

    for ch in channels:
        code, crate = codes.gencode(ch.prn, ch.ctype)
        clen = len(code)
        # code Doppler consistent with carrier aiding:
        # received code rate = crate * (1 - D(t) / f_cf) with
        # D(t) = doppler + doppler_rate * t; chips = integral of the rate
        dphi = ch.doppler * t + 0.5 * ch.doppler_rate * t * t
        chips = ch.code_phase + crate * (t - dphi / ch.f_cf)
        chip_idx = np.floor(chips).astype(np.int64)
        c = code[np.mod(chip_idx, clen)].astype(np.float64)
        if ch.nav_bits is not None:
            bit_period_chips = crate * ch.nav_ms * 1e-3
            bit_idx = np.floor(chips / bit_period_chips).astype(np.int64)
            c = c * np.asarray(ch.nav_bits, dtype=np.float64)[
                np.mod(bit_idx, len(ch.nav_bits))]
        # receiver acquires at carrfreq = f_if + foffset - D; the phase
        # integrates the instantaneous Doppler (ramp term for dynamics)
        phase = 2.0 * np.pi * ((f_if + ch.foffset) * t - dphi
                               + ch.carr_phase)
        if dtype == DType.IQ:
            # receiver mixes by e^{+j 2π f̂ t}; signal must be e^{-jφ}
            out[:, 0] += ch.amplitude * c * np.cos(phase)
            out[:, 1] += ch.amplitude * c * (-np.sin(phase))
        else:
            out += ch.amplitude * c * np.cos(phase)

    if noise_std > 0.0:
        out += rng.normal(0.0, noise_std, out.shape)
    return out


def noise_std_for_cn0(amplitude: float, cn0_dbhz: float, f_sf: float,
                      dtype: int) -> float:
    """Per-sample noise sigma giving the requested C/N0.

    Real sampling: C/N0 = A²·f_sf / (2σ²); I/Q: C/N0 = A²·f_sf / (2σ²)
    with σ per I/Q component (signal power A²/2 per component).
    """
    cn0 = 10.0 ** (cn0_dbhz / 10.0)
    return amplitude * np.sqrt(f_sf / (2.0 * cn0))


def quantize_rtlsdr(x: np.ndarray, scale: float = 16.0) -> np.ndarray:
    """(n, 2) float I/Q -> interleaved RTL-SDR u8 bytes.

    Encoded so the stream decode — ``(char)(u8 - 127.5)`` truncation
    toward zero (reference rtlsdr.c:136-143, io/formats.unpack_rtlsdr) —
    recovers ``clip(round(x*scale), -127, 127)`` exactly.
    """
    q = np.clip(np.round(np.asarray(x, np.float64) * scale),
                -127, 127).astype(np.int32)
    u8 = np.where(q >= 0, q + 128, q + 127).astype(np.uint8)
    return u8.reshape(-1)


def quantize_int8(x: np.ndarray, scale: float = 16.0) -> np.ndarray:
    """Scale and clip to int8 (the plain-IF file byte format, DTYPE I/IQ)."""
    q = np.clip(np.round(x * scale), -128, 127).astype(np.int8)
    return q


def write_if_file(path: str, x: np.ndarray, scale: float = 16.0) -> None:
    """Write samples as the reference's FEND_FILE int8 byte stream.

    Real sampling: one int8 per sample; I/Q: interleaved int8 pairs
    (reference file front-end, src/sdrrcv.c:194-226,505-531).
    """
    quantize_int8(x, scale).ravel().tofile(path)


def pack_stereo(fe1: np.ndarray, fe2: np.ndarray, scale1: float = 1.0,
                scale2: float = 1.0) -> np.ndarray:
    """Pack sample-synchronous FE1 (real) + FE2 (I/Q) streams into NSL
    STEREO bytes — the inverse of io.formats.unpack_stereo_fe1/fe2
    (capture packing, rcv/stereo/stereo.c:184-205): FE1 2-bit sign/mag in
    bits 7-6 (levels -3,-1,1,3), FE2 two 3-bit I/Q fields in bits 5-0
    (levels ±1..±7).  Returns a uint8 array, one byte per sample."""
    fe1 = np.asarray(fe1, np.float64) * scale1
    fe2 = np.asarray(fe2, np.float64) * scale2
    if fe1.shape[0] != fe2.shape[0]:
        raise ValueError("FE1/FE2 sample counts differ (shared clock)")
    c1 = np.clip(np.floor((fe1 + 4.0) / 2.0), 0, 3).astype(np.uint8)

    def _code3(v):
        lev = np.clip(2.0 * np.floor(v / 2.0) + 1.0, -7, 7).astype(np.int64)
        return np.where(lev > 0, (lev - 1) // 2,
                        (lev + 7) // 2 + 4).astype(np.uint8)

    ci = _code3(fe2[:, 0])
    cq = _code3(fe2[:, 1])
    return ((c1 << 6) | (ci << 3) | cq).astype(np.uint8)


def example_eph(prn: int = 1, week: int = 2200, toe_tow: float = 352800.0,
                m0: float = 0.12, omg0: float = -0.27, omg: float = 0.45,
                i0: float = 0.31):
    """A plausible GPS ephemeris for round-trip tests (values on LNAV scale
    grids so encode->decode is exact).  ``m0``/``omg0``/``omg``/``i0`` are
    in semicircles — vary them to spread a constellation for geometry
    tests (sim.geometry_scenario)."""
    from .gtime import gpst2time
    from .nav.eph import SdrEph
    from .nav.lnav import (P2_5, P2_19, P2_29, P2_31, P2_33, P2_43, P2_55,
                           SC2RAD)
    e = SdrEph(prn=prn)
    ep = e.eph
    ep.week, ep.iode, ep.iodc = week, 77, 77
    ep.sva, ep.svh, ep.code, ep.flag = 1, 0, 1, 0
    ep.toes = toe_tow
    ep.toe = gpst2time(week, toe_tow)
    ep.toc = gpst2time(week, toe_tow)
    ep.A = (5153.625 // P2_19 * P2_19) ** 2
    ep.e = round(0.012 / P2_33) * P2_33
    ep.i0 = round(i0 / P2_31) * P2_31 * SC2RAD
    ep.OMG0 = round(omg0 / P2_31) * P2_31 * SC2RAD
    ep.omg = round(omg / P2_31) * P2_31 * SC2RAD
    ep.M0 = round(m0 / P2_31) * P2_31 * SC2RAD
    ep.deln = round(1.4e-9 / P2_43) * P2_43 * SC2RAD
    ep.OMGd = round(-2.5e-9 / P2_43) * P2_43 * SC2RAD
    ep.idot = round(2.0e-10 / P2_43) * P2_43 * SC2RAD
    ep.crc = round(221.0 / P2_5) * P2_5
    ep.crs = round(-93.0 / P2_5) * P2_5
    ep.cuc = round(-4.5e-6 / P2_29) * P2_29
    ep.cus = round(7.8e-6 / P2_29) * P2_29
    ep.cic = round(-1.1e-7 / P2_29) * P2_29
    ep.cis = round(9.0e-8 / P2_29) * P2_29
    ep.f0 = round(2.3e-4 / P2_31) * P2_31
    ep.f1 = round(1.1e-11 / P2_43) * P2_43
    ep.f2 = 0.0
    ep.tgd = (round(-1.0e-8 / P2_31) * P2_31, 0.0, 0.0, 0.0)
    ep.fit = 0
    return e


def geometry_scenario(ephs, rcv_ecef, tow_obs: float, tow0: float,
                      min_elev_deg: float = 10.0):
    """Physics-consistent constellation geometry for SPP validation.

    For each GPS ephemeris in ``ephs`` (list of SdrEph/Eph carriers as
    returned by :func:`example_eph`), compute the true signal delay at
    receive epoch ``tow_obs`` for a receiver at ECEF ``rcv_ecef`` —
    light-time iterated, Sagnac-rotated, SV-clock-shifted — and the
    delay rate, i.e. exactly what obs/spp.py inverts.  Stream time maps
    tow(t) = tow0 + t; the linear delay model is anchored at tow_obs so
    the synthesized signal is exact there (orbit curvature over a short
    run stays below the DLL jitter).

    Returns a list of dicts per VISIBLE satellite (elevation above
    ``min_elev_deg``): prn, code_phase (chips at t=0), doppler (sim
    convention: d(delay)/dt * f_cf), tau (s at tow_obs), rs (ECEF).
    """
    import math

    from .constants import CLIGHT, FREQ1
    from .gtime import gpst2time
    from .obs.satpos import OMGE, satpos_any

    rcv = np.asarray(rcv_ecef, float)
    up = rcv / np.linalg.norm(rcv)
    out = []

    def delay_at(eph, week, tow):
        # tau_f: true flight time (transmission at tow - tau_f); the
        # MEASURED code delay is tau_f - dts (a fast SV clock transmits
        # early, shortening the pseudorange) — the inverse of the
        # solver's t_tx = t_rx - P/c - dts convention
        tau_f = 0.075
        for _ in range(4):
            rs, dts = satpos_any(eph, gpst2time(week, tow - tau_f))
            a = OMGE * tau_f
            rs_r = np.array([math.cos(a) * rs[0] + math.sin(a) * rs[1],
                             -math.sin(a) * rs[0] + math.cos(a) * rs[1],
                             rs[2]])
            tau_f = float(np.linalg.norm(rs_r - rcv)) / CLIGHT
        return tau_f - dts, rs_r

    for e in ephs:
        ep = getattr(e, "eph", e)
        gp = getattr(e, "geph", None)
        if not hasattr(ep, "A") or ep.A == 0.0:
            # GLONASS entry (SdrEph with a filled geph, or a bare Geph)
            ep = gp if gp is not None and any(gp.pos) else ep
        prn = getattr(e, "prn", getattr(ep, "sat", 0))
        week = getattr(ep, "week", None)
        if week is None:
            from .gtime import time2gpst
            _, week = time2gpst(ep.toe)
        tau, rs = delay_at(ep, week, tow_obs)
        los = (rs - rcv) / np.linalg.norm(rs - rcv)
        elev = math.degrees(math.asin(float(np.dot(los, up))))
        if elev < min_elev_deg:
            continue
        taum, _ = delay_at(ep, week, tow_obs - 0.5)
        taup, _ = delay_at(ep, week, tow_obs + 0.5)
        rate = taup - taum                        # s/s
        t_obs = tow_obs - tow0                    # stream time of the epoch
        delay0 = tau - rate * t_obs               # linear anchor at tow_obs
        # chip rate by constellation (GLONASS G1: 511 kcps)
        crate = 0.511e6 if not hasattr(ep, "A") else 1.023e6
        out.append(dict(prn=prn, tau=tau, rs=rs, elev=elev, rate=rate,
                        doppler=rate * FREQ1,
                        code_phase=-delay0 * crate))
    return out


def lnav_bit_stream(eph, tow_start: float, nframes: int = 2,
                    seed: int = 7) -> np.ndarray:
    """Continuous ±1 LNAV bit stream of ``nframes`` x subframes 1..5
    starting at subframe boundary tow_start (s).  Word-parity chaining is
    carried across subframes exactly as broadcast."""
    from .nav.lnav import encode_frame_l1ca
    bits = []
    b29 = b30 = 0
    tow6 = int(tow_start / 6.0)
    for _ in range(nframes * 5):
        sfid = (tow6 - int(tow_start / 6.0)) % 5 + 1
        sf = encode_frame_l1ca(eph, sfid, tow6 + 1, b29, b30, seed)
        # chain parity: last word's D29,D30 (±1 -> 0/1)
        b29 = int(sf[298] == -1)
        b30 = int(sf[299] == -1)
        bits.append(sf)
        tow6 += 1
    return np.concatenate(bits).astype(np.int8)


def glonass_time_fields(t_gpst):
    """Inverse of nav.glonass timing: GPST -> (tk_h, tk_m, tk_s30, nt, n4).

    For building string 1/4/5 fields so that glot2time/merge_g1 recover
    the same epoch (GLONASS ICD A.3.1.3; reference src/sdrnav_glo.c).
    """
    from .gtime import gpst2utc, time2epoch, timeadd, epoch2time, timediff
    msk = timeadd(gpst2utc(t_gpst), 10800.0)      # Moscow time
    ep = time2epoch(msk)
    year = int(ep[0])
    n4 = (year - 1996) // 4 + 1
    j = year - (1996 + 4 * (n4 - 1))              # 0..3
    y0 = epoch2time([1996 + 4 * (n4 - 1) + j, 1, 1, 0, 0, 0])
    doy = int(timediff(msk, y0) // 86400) + 1
    nt = doy + (0, 366, 731, 1096)[j]
    return int(ep[3]), int(ep[4]), int(ep[5]) // 30 * 30, nt, n4


def g1_string_bits(sid: int, fields) -> np.ndarray:
    """85 logical bits (0/1) for one G1 string: idle 0 + 4-bit id +
    (pos, len, value) payload fields."""
    from .nav.bits import setbitu
    buf = bytearray(11)
    setbitu(buf, 1, 4, sid)
    for pos, length, val in fields:
        setbitu(buf, pos, length, int(val))
    return np.unpackbits(np.frombuffer(bytes(buf), np.uint8))[:85].astype(
        np.int64)


def _g1_signmag(v: float, scale: float, nbits: int) -> int:
    """GLONASS ICD sign-magnitude field: MSB = sign, rest = magnitude
    (inverse of nav.bits.getbits_glo)."""
    mag = int(round(abs(v) / scale))
    mag = min(mag, (1 << (nbits - 1)) - 1)
    return ((1 << (nbits - 1)) | mag) if v < 0 else mag


def g1_symbol_stream(t0_gpst, nframes: int = 3, iode: int = 44,
                     slot: int = 13, geph=None) -> np.ndarray:
    """GLONASS G1 line-symbol stream (±1 at 100 sps): real 15-string /
    30-second frames with tk advancing per frame, so merge_g1 recovers
    ``t0_gpst + 30*k`` as frame-k start (GLONASS ICD superframe layout;
    strings 6-15 are almanac filler the decoder skips).  Feed as nav_bits
    with nav_ms=10.

    ``geph``: optional Geph whose state vector (pos/vel/acc, m), taun,
    gamn are encoded into strings 1-4 on the ICD grids — quantize the
    source with :func:`quantize_geph` first so decode == truth."""
    from .gtime import timeadd
    from .nav.glonass import (P2_11, P2_20, P2_30, P2_40, TIMEMARK_G1,
                              encode_string_g1)
    out = []
    sv = [[], [], [], []]
    if geph is not None:
        for ax in range(3):
            sv[ax] = [
                (21, 24, _g1_signmag(geph.vel[ax] / 1000.0, P2_20, 24)),
                (45, 5, _g1_signmag(geph.acc[ax] / 1000.0, P2_30, 5)),
                (50, 27, _g1_signmag(geph.pos[ax] / 1000.0, P2_11, 27))]
        sv[3] = [(5, 22, _g1_signmag(geph.taun, P2_30, 22)),
                 (27, 5, _g1_signmag(geph.dtaun, P2_30, 5))]
    for fr in range(nframes):
        h, m, s30, nt, n4 = glonass_time_fields(
            timeadd(t0_gpst, 30.0 * fr))
        strings = [
            # field carries the Moscow-time hour; the decoder subtracts
            # the 3 h bias (src/sdrnav_glo.c:30)
            g1_string_bits(1, [(9, 5, h), (14, 6, m),
                               (20, 1, s30 // 30)] + sv[0]),
            g1_string_bits(2, [(9, 7, iode)] + sv[1]),
            g1_string_bits(3, [(6, 11, _g1_signmag(
                geph.gamn, P2_40, 11)) if geph is not None
                else (6, 11, 0)] + sv[2]),
            g1_string_bits(4, [(59, 11, nt), (70, 5, slot)] + sv[3]),
            g1_string_bits(5, [(49, 5, n4)]),
        ] + [g1_string_bits(6 + k, []) for k in range(10)]
        for st in strings:
            out.append(encode_string_g1(st))
            out.append(TIMEMARK_G1)
    return np.concatenate(out).astype(np.int8)


def quantize_geph(geph) -> None:
    """Snap a Geph's broadcast fields to the GLONASS ICD grids IN PLACE
    (what a real broadcast would carry; makes sim->decode exact)."""
    from .nav.glonass import P2_11, P2_20, P2_30, P2_40
    for ax in range(3):
        geph.pos[ax] = round(geph.pos[ax] / 1000.0 / P2_11) * P2_11 * 1000
        geph.vel[ax] = round(geph.vel[ax] / 1000.0 / P2_20) * P2_20 * 1000
        geph.acc[ax] = round(geph.acc[ax] / 1000.0 / P2_30) * P2_30 * 1000
    geph.taun = round(geph.taun / P2_30) * P2_30
    geph.gamn = round(geph.gamn / P2_40) * P2_40
    geph.dtaun = round(geph.dtaun / P2_30) * P2_30
