"""The port's multi-GNSS receiver against the JAX receiver: GLONASS G1 and
SBAS channels, channel groups by RF path and loop cadence
(``build_receiver``, ``MultiReceiver``), on the constructions of the JAX
package's receiver tests, built here:

* ``glo``: GPS L1CA + GLONASS G1 on one real front end (one group,
  test_receiver_glo.py);
* ``sbas``: GPS L1CA + SBAS with MT12 messages and the NovAtel stream (two
  cadence groups sharing the path's device cache, test_receiver_sbas.py);
* ``dual``: a packed STEREO capture, GPS on FE1 (2-bit real) and G1 on FE2
  (3-bit I/Q), one group per path (test_receiver_dual.py);
* ``hot``: five GPS satellites and one GLONASS satellite on a consistent
  geometry, G1's acquisition suppressed and its ephemeris given as
  slot-keyed assistance, so that it starts by the GLONASS hot start
  (test_receiver_spp_glo.py).

The satellites, delays, Dopplers, C/N0, rates and quantization are those
tests'.  To keep the captures short, ``glo`` and ``dual`` start 24 s into
a GLONASS frame (the G1 stream of the frame before, its first 12 strings
left out), so that string 1 arrives 6 s in and G1 decodes within 16 s
instead of 32 s; their time of week moves 6 s to keep GLONASS string 1's
time fields exact.  Each capture runs through both packages from the same
configuration; events and epochs must be the same, pseudoranges within
the bound ``tests/test_torch_relock.py`` states (each epoch within 10 m,
the median within 0.5 m: the two DLLs answer each other's last-bit
differences with steps of 1/256 sample that come and go, 0.29 m at
4.092 Msps; on ``hot``, at 4.096 Msps, they reach 3.5 steps, 1.0 m), nav
records and SBAS bytes identical.  A MultiReceiver's checkpoint resumes
to the uninterrupted run."""
import copy
import dataclasses
import math
import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from gnsslib_tpu import sim
from gnsslib_tpu.constants import (CLIGHT, DFRQ1_GLO, FREQ1, FREQ1_GLO,
                                   PTIMING, SYS_GLO, SYS_GPS, SYS_SBS,
                                   CodeType,
                                   DType, FrontendType)
from gnsslib_tpu.gtime import epoch2time, gpst2time, time2gpst
from gnsslib_tpu.io.frontend import FileFrontend as JaxFileFrontend
from gnsslib_tpu.io.frontend import FrontendSpec as JaxFrontendSpec
from gnsslib_tpu.nav.bits import crc32_rtk
from gnsslib_tpu.nav.eph import Geph as JaxGeph
from gnsslib_tpu.nav.sbas import encode_sbas_message
from gnsslib_tpu.nav.viterbi import conv27_encode
from gnsslib_tpu.runtime import config as jax_config
from gnsslib_tpu.runtime.receiver import build_receiver as jax_build
from gnsslib_tpu.track import TrackConfig as JaxTrackConfig
from gnsslib_tpu_torch import gtime as torch_gtime
from gnsslib_tpu_torch.io.frontend import FileFrontend, FrontendSpec
from gnsslib_tpu_torch.nav.eph import Geph
from gnsslib_tpu_torch.runtime import config as torch_config
from gnsslib_tpu_torch.runtime.cli import main as torch_cli
from gnsslib_tpu_torch.runtime.receiver import (DualReceiver, MultiReceiver,
                                                Receiver, build_receiver)
from gnsslib_tpu_torch.track import TrackConfig
from torch_reference_loop import reference_carrier_loop  # noqa: F401

# the carrier loop's pull-in as the reference and the JAX package run it
# (tests/torch_reference_loop.py): the port's FLL pulls in alone first
pytestmark = pytest.mark.usefixtures("reference_carrier_loop")
torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

F_SF = 4.092e6
F_IF = 1.023e6
PAD = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
# glo and dual: (TOW_G - 24 - 18) % 30 == 0, so a GLONASS frame starts
# 24 s before the capture and the next one 6 s into it
TOW_G = 352812.0
GPS_PRN, GPS_DELAY, GPS_DOPP = 5, 400, 600.0
GLO_FCN, GLO_SLOT, GLO_DELAY, GLO_DOPP = 1, 13, 900, -1400.0
G_SECONDS = 26.0
CKPT_SECONDS = 8.0          # dual's checkpoint, before G1 decodes
# sbas (test_receiver_sbas.py)
TOW_S = 352818.0
SBAS_PRN, SBAS_DELAY, SBAS_GPS, SBAS_GPS_DELAY = 129, 700, 7, 200
S_SECONDS = 16.0
# hot (test_receiver_spp_glo.py): (TOW_H - 18) % 30 == 0, 4.096 Msps
H_SF = 4.096e6
TOW_H = 352818.0
H_T_OBS = 38.0
H_SECONDS = 32.0
H_FCN, H_SLOT, H_IODE = 2, 11, 20
RCV = np.array([-3954844.0, 3354936.0, 3700264.0])


# --------------------------------------------------------------------- #
def _glo_channels():
    """The GPS and G1 SimChannels of ``glo`` and ``dual``."""
    eph = sim.example_eph(prn=GPS_PRN, week=2200, toe_tow=TOW_G)
    gps = sim.SimChannel(
        prn=GPS_PRN, doppler=GPS_DOPP,
        code_phase=-GPS_DELAY * 1.023e6 / F_SF, carr_phase=0.2,
        nav_bits=np.concatenate(
            [PAD, sim.lnav_bit_stream(eph, TOW_G + 6.0, nframes=2)]))
    symbols = sim.g1_symbol_stream(gpst2time(2200, TOW_G - 24.0), nframes=2,
                                   iode=44, slot=GLO_SLOT)[2400:]
    glo = sim.SimChannel(
        prn=GLO_FCN, ctype=CodeType.G1, doppler=GLO_DOPP,
        code_phase=-GLO_DELAY * 0.511e6 / F_SF, carr_phase=0.7,
        nav_bits=symbols, nav_ms=10.0,
        f_cf=FREQ1_GLO + GLO_FCN * DFRQ1_GLO, foffset=GLO_FCN * DFRQ1_GLO)
    return gps, glo


def _sbas_symbols(nmsgs: int):
    """test_receiver_sbas.py's line symbols: 250-bit messages (1 s each),
    MT12 every 3rd, preambles cycling 53/9A/C6, rate-1/2 encoded."""
    preambles = [0x53, 0x9A, 0xC6]
    rng = np.random.default_rng(12)
    msgs = []
    for k in range(nmsgs):
        if k % 3 == 0:
            payload = np.zeros(212, np.int64)
            tow_field = int(TOW_S) + k + 2
            for i in range(20):
                payload[107 - 14 + i] = (tow_field >> (19 - i)) & 1
            wk = (2200 - 1024) & 0x3FF
            for i in range(10):
                payload[127 - 14 + i] = (wk >> (9 - i)) & 1
            msgs.append(encode_sbas_message(12, payload, preambles[k % 3]))
        else:
            msgs.append(encode_sbas_message(63, rng.integers(0, 2, 212),
                                            preambles[k % 3]))
    bits01 = ((1 - np.concatenate(msgs)) // 2).astype(np.int64)
    return np.where(conv27_encode(bits01) == 0, 1, -1).astype(np.int8)


def _sbas_channels():
    eph = sim.example_eph(prn=SBAS_GPS, week=2200, toe_tow=TOW_S)
    gps = sim.SimChannel(
        prn=SBAS_GPS, doppler=700.0,
        code_phase=-SBAS_GPS_DELAY * 1.023e6 / F_SF, carr_phase=0.4,
        nav_bits=np.concatenate(
            [PAD, sim.lnav_bit_stream(eph, TOW_S + 6.0, nframes=4)]))
    sbas = sim.SimChannel(
        prn=SBAS_PRN, ctype=CodeType.L1SBAS, doppler=-900.0,
        code_phase=-SBAS_DELAY * 1.023e6 / F_SF, carr_phase=0.9, nav_ms=2.0,
        nav_bits=_sbas_symbols(int(S_SECONDS) + 2))
    return [gps, sbas]


def _hot_geometry():
    """test_receiver_spp_glo.py's constellation: (five visible GPS geometry
    dicts, the GLONASS one, the quantized GLONASS Geph, GPS ephemerides by
    PRN)."""
    cands, k = [], 0
    for omg0 in (-0.9, -0.55, -0.2, 0.15, 0.5, 0.85):
        for m0 in (-0.6, 0.0, 0.6):
            k += 1
            cands.append(sim.example_eph(prn=k, week=2200, toe_tow=352800.0,
                                         m0=m0, omg0=omg0))
    up = RCV / np.linalg.norm(RCV)
    tang = np.cross([0.0, 0.0, 1.0], up)
    tang /= np.linalg.norm(tang)
    v0 = math.sqrt(398600.44e9 / 25508000.0)
    glo = JaxGeph(pos=list(up * 25508000.0), vel=list(tang * v0),
                  acc=[0.0, 0.0, 0.0], taun=-3.1e-5, gamn=0.0, dtaun=0.0,
                  frq=H_FCN, iode=H_IODE, toe=gpst2time(2200, TOW_H))
    sim.quantize_geph(glo)
    geo = sim.geometry_scenario(cands + [glo], RCV, TOW_H + H_T_OBS, TOW_H,
                                min_elev_deg=15.0)
    return geo[:-1][:5], geo[-1], glo, {e.prn: e for e in cands}


def _hot_channels():
    gps_geo, g_glo, glo, ephs = _hot_geometry()
    chans = [sim.SimChannel(
        prn=g["prn"], doppler=g["doppler"], code_phase=g["code_phase"],
        carr_phase=0.13 * g["prn"], nav_bits=np.concatenate(
            [PAD, sim.lnav_bit_stream(ephs[g["prn"]], TOW_H + 6.0,
                                      nframes=2)]))
        for g in gps_geo]
    f_cf = FREQ1_GLO + H_FCN * DFRQ1_GLO
    chans.append(sim.SimChannel(
        prn=H_FCN, ctype=CodeType.G1, doppler=g_glo["rate"] * f_cf,
        code_phase=g_glo["code_phase"], carr_phase=0.77,
        nav_bits=sim.g1_symbol_stream(gpst2time(2200, TOW_H), nframes=2,
                                      iode=H_IODE, slot=H_SLOT, geph=glo),
        nav_ms=10.0, f_cf=f_cf, foffset=H_FCN * DFRQ1_GLO))
    return chans


def _chunk(kind: str, t0: int, m: int) -> bytes:
    """Samples [t0, t0 + m) of capture ``kind`` as file bytes."""
    if kind == "glo":
        n = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.REAL)
        x = sim.synthesize(list(_glo_channels()), F_SF, F_IF, DType.REAL, m,
                           noise_std=n, seed=4000 + t0, t0=t0)
        return sim.quantize_int8(x, 16.0).tobytes()
    if kind == "sbas":
        n = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.REAL)
        x = sim.synthesize(_sbas_channels(), F_SF, F_IF, DType.REAL, m,
                           noise_std=n, seed=7000 + t0, t0=t0)
        return sim.quantize_int8(x, 16.0).tobytes()
    if kind == "dual":
        gps, glo = _glo_channels()
        n1 = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.REAL)
        n2 = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.IQ)
        fe1 = sim.synthesize([gps], F_SF, F_IF, DType.REAL, m, noise_std=n1,
                             seed=5000 + t0, t0=t0)
        fe2 = sim.synthesize([glo], F_SF, 0.0, DType.IQ, m, noise_std=n2,
                             seed=6000 + t0, t0=t0)
        return sim.pack_stereo(fe1, fe2, scale1=1.2 / n1,
                               scale2=2.5 / n2).tobytes()
    n = sim.noise_std_for_cn0(1.0, 46.0, H_SF, DType.REAL)
    x = sim.synthesize(_hot_channels(), H_SF, F_IF, DType.REAL, m,
                       noise_std=n, seed=900 + t0, t0=t0)
    return sim.quantize_int8(x, 16.0).tobytes()


CAPTURES = {"glo": (F_SF, G_SECONDS), "sbas": (F_SF, S_SECONDS),
            "dual": (F_SF, G_SECONDS), "hot": (H_SF, H_SECONDS)}


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """{kind: path}: the four captures in 1 s chunks, synthesized on
    threads (numpy releases the interpreter lock in the synthesis)."""
    tmp = tmp_path_factory.mktemp("multi")
    jobs = []
    for kind, (f_sf, seconds) in CAPTURES.items():
        step, n = int(f_sf), int(seconds * f_sf)
        jobs += [(kind, t0, min(step, n - t0)) for t0 in range(0, n, step)]
    paths = {k: tmp / f"{k}.bin" for k in CAPTURES}
    files = {k: open(p, "wb") for k, p in paths.items()}
    try:
        with ThreadPoolExecutor(4) as pool:
            for (kind, _, _), raw in zip(jobs, pool.map(
                    lambda j: _chunk(*j), jobs)):
                files[kind].write(raw)
    finally:
        for f in files.values():
            f.close()
    return tmp, {k: str(p) for k, p in paths.items()}


# --------------------------------------------------------------------- #
_FEND = {"glo": ("FILE", [(1575.42e6, F_IF, 1)]),
         "sbas": ("FILE", [(1575.42e6, F_IF, 1)]),
         "dual": ("FILESTEREO", [(1575.42e6, F_IF, 1), (1602.0e6, 0.0, 2)])}
_CHANNELS = {"glo": ([GPS_PRN, GLO_FCN], [1, 4], [1, 20], [1, 1]),
             "sbas": ([SBAS_GPS, SBAS_PRN], [1, 2], [1, 27], [1, 1]),
             "dual": ([GPS_PRN, GLO_FCN], [1, 4], [1, 20], [1, 2])}


def _ini(tmp, kind: str, path: str, name: str, extra: str = "",
         channels=None) -> str:
    """INI files of capture ``kind`` (test_receiver_*.py's), RINEX output
    under ``tmp/name``; ``extra``: more [OUTPUT] lines; ``channels``:
    (PRN, SYS, CTYPE, FTYPE) lists instead of the capture's."""
    fend_type, paths = _FEND[kind]
    fend = tmp / f"{name}_fend.ini"
    lines = [f"[FEND]\nTYPE     ={fend_type}"]
    for k, (cf, f_if, dtype) in enumerate(paths, 1):
        lines.append(f"CF{k}      ={cf}\nSF{k}      ={F_SF}\nIF{k}      ="
                     f"{f_if}\nDTYPE{k}   ={dtype}")
    lines.append(f"FILE1    ={path}\n[TRACK]\nCORRN    =4\nCORRD    =2\n"
                 "CORRP    =2\n")
    fend.write_text("\n".join(lines))
    channels = channels or _CHANNELS[kind]
    prn, sys_, ctype, ftype = (",".join(map(str, v)) for v in channels)
    ini = tmp / f"{name}.ini"
    ini.write_text(f"""[RCV]
FENDCONF ={fend}
[CHANNEL]
NCH      ={len(channels[0])}
PRN      ={prn}
SYS      ={sys_}
CTYPE    ={ctype}
FTYPE    ={ftype}
[OUTPUT]
OUTMS    =400
RINEX    =1
RINEXPATH={tmp}/{name}
SBASPORT =0
{extra}""")
    return str(ini)


def _frontends(pkg, cfg):
    """One file front end per RF path with channels, as both CLIs open
    them (a packed two-path capture: both paths read FILE1)."""
    fe_cls = JaxFileFrontend if pkg == "jax" else FileFrontend
    fts = sorted({c.ftype for c in cfg.channels})
    return {ft: fe_cls(cfg.files[ft - 1] or cfg.files[0], cfg.fends[ft - 1])
            for ft in fts}


def _build(pkg, cfg):
    if pkg == "jax":
        return jax_build(cfg, _frontends(pkg, cfg))
    return build_receiver(cfg, _frontends(pkg, cfg), device="cpu")


def _record(rx):
    """(epochs the hub emits, SBAS stream bytes it sends), filled as the
    receiver runs."""
    epochs, sbas = [], bytearray()
    emit = rx.hub.emit_epochs

    def record(inputs):
        out = emit(inputs)
        epochs.extend(out)
        return out
    rx.hub.emit_epochs = record
    if rx.hub.sbas_srv is not None:
        send = rx.hub.sbas_srv.send

        def keep(data):
            sbas.extend(data)
            send(data)
        rx.hub.sbas_srv.send = keep
    return epochs, sbas


def _nav_records(rx) -> list:
    """The RINEX nav file's lines after its header."""
    lines = open(rx.nav_writer.path).read().splitlines()
    return lines[next(i for i, ln in enumerate(lines)
                      if "END OF HEADER" in ln) + 1:]


def _run(pkg, ini, seconds=None):
    loader = jax_config.load_ini if pkg == "jax" else torch_config.load_ini
    cfg = loader(ini)
    rx = _build(pkg, cfg)
    epochs, sbas = _record(rx)
    rx.run_seconds(seconds)
    rx.close()
    return dict(rx=rx, epochs=epochs, sbas=bytes(sbas),
                nav=_nav_records(rx))


@pytest.fixture(scope="module")
def runs(captures):
    """{kind: {"jax": run, "torch": run}} of glo, sbas and dual: the JAX
    runs on a thread beside the port's (each package's arithmetic leaves
    the interpreter lock while it runs)."""
    tmp, paths = captures
    kinds = ("glo", "sbas", "dual")

    def run(kind, pkg):
        return _run(pkg, _ini(tmp, kind, paths[kind], f"{kind}_{pkg}",
                              "SBAS     =1\n" if kind == "sbas" else ""))
    with ThreadPoolExecutor(1) as pool:
        jax_runs = [pool.submit(run, kind, "jax") for kind in kinds]
        return {kind: {"torch": run(kind, "torch"), "jax": j.result()}
                for kind, j in zip(kinds, jax_runs)}


def _same_events(jrx, trx) -> None:
    """Acquisitions (PRN and time; C/N0 within 1e-3 dB, peak ratio within
    1e-4), hot starts (loc within a sample, Doppler within 0.5 Hz), losses
    of lock and nav events identical."""
    kinds = ("acq", "hot", "lol")
    ej = [e for e in jrx.events if e[0] in kinds]
    et = [e for e in trx.events if e[0] in kinds]
    assert [e[:3] for e in et] == [e[:3] for e in ej]
    for a, b in zip(ej, et):
        if a[0] == "acq":
            assert b[3] == pytest.approx(a[3], abs=1e-3)
            assert b[4] == pytest.approx(a[4], rel=1e-4)
        elif a[0] == "hot":
            assert b[3] == pytest.approx(a[3], abs=0.5)
            assert abs(b[4] - a[4]) <= 1
    nav_j = [e for e in jrx.events if e[0].startswith("nav:")]
    assert [e for e in trx.events if e[0].startswith("nav:")] == nav_j


def _same_epochs(jep, tep) -> int:
    """The same epoch TOWs and satellites (system, PRN); Doppler within
    0.5 Hz, 1 Hz for SBAS (its carrier loop updates every 2 ms on 2 ms
    sums, with five times the phase noise of a 10 ms update, and its
    Doppler answers the packages' last-bit differences by up to ~0.6 Hz);
    pseudoranges at the module docstring's bound.  Returns the number of
    epochs."""
    assert len(tep) == len(jep) > 0
    dP = []
    for oj, ot in zip(jep, tep):
        assert ot[0].tow == oj[0].tow
        assert [(o.sys, o.prn) for o in ot] == [(o.sys, o.prn) for o in oj]
        for a, b in zip(oj, ot):
            assert b.D == pytest.approx(
                a.D, abs=1.0 if a.sys == SYS_SBS else 0.5)
            assert b.fcn == a.fcn
            dP.append(abs(b.P - a.P))
    assert max(dP) <= 10.0 and float(np.median(dP)) <= 0.5, max(dP)
    return len(tep)


# --------------------------------------------------------------------- #
def test_build_receiver_groups(runs):
    """glo is one group (GPS and G1 share L = 10): a plain Receiver; sbas
    is two cadence groups on one path (SBAS L = 2 first, then GPS L = 10)
    sharing its device cache; dual is one group per path, with a cache
    each; every group captured its own block programs."""
    g = runs["glo"]["torch"]["rx"]
    assert type(g) is Receiver and g.fast.L == 10
    s = runs["sbas"]["torch"]["rx"]
    assert type(s) is MultiReceiver
    assert [r.fast.L for r in s.rx] == [2, 10]
    assert [[c.cfg.prn for c in r.channels] for r in s.rx] == \
        [[SBAS_PRN], [SBAS_GPS]]
    assert s.rx[0].cache is s.rx[1].cache
    assert all(r.hub is s.hub and not r.standalone for r in s.rx)
    d = runs["dual"]["torch"]["rx"]
    assert [r.spec.dtype for r in d.rx] == [DType.REAL, DType.IQ]
    assert d.rx[0].cache is not d.rx[1].cache
    for r in s.rx + d.rx:
        assert len(r.trk.programs) == 1 and len(r.fast.programs) == 1
        assert r.peer_channels == (s if r in s.rx else d).channels
    # the JAX package groups the same channels the same way
    js = runs["sbas"]["jax"]["rx"]
    assert [[c.cfg.prn for c in r.channels] for r in js.rx] == \
        [[c.cfg.prn for c in r.channels] for r in s.rx]


@pytest.mark.parametrize("kind", ["glo", "sbas", "dual"])
def test_multi_receiver_matches_jax(runs, kind):
    """Events, epochs (with G1's FDMA number for its wavelength) and RINEX
    nav records (a G and an R record on glo and dual) identical to the JAX
    receiver's; the SBAS stream's bytes equal."""
    j, t = runs[kind]["jax"], runs[kind]["torch"]
    _same_events(j["rx"], t["rx"])
    assert [c.locked for c in t["rx"].channels] == \
        [c.locked for c in j["rx"].channels] == [True, True]
    n = _same_epochs(j["epochs"], t["epochs"])
    assert n >= 8
    assert t["nav"] == j["nav"]
    assert t["sbas"] == j["sbas"]
    if kind == "sbas":     # 16 s: MT12 and NovAtel frames, no GPS record
        assert len(t["sbas"]) >= 80
    else:
        assert len(t["nav"]) >= 2


@pytest.mark.parametrize("kind", ["glo", "dual"])
def test_glonass_slot_and_cross_system_ranges(runs, kind):
    """The port's output against the synthesized truth (the JAX tests'
    checks): the G1 channel reports slot 13 from string 4 (``R13``), the
    last epoch holds G05 and R13 with their Dopplers within 2 Hz and their
    range difference the delays' plus the per-system Doppler drift within
    25 m, and the nav file has a G and an R record."""
    t = runs[kind]["torch"]
    lines = open(t["rx"].obs_writer.path).read().splitlines()
    last = max(i for i, ln in enumerate(lines) if ln.startswith(">"))
    P, D = {}, {}
    for ln in lines[last + 1:last + 3]:
        P[ln[:3]] = float(ln[3:17])
        D[ln[:3]] = float(ln[3 + 2 * 16:3 + 2 * 16 + 14])
    g, r = f"G{GPS_PRN:02d}", f"R{GLO_SLOT:02d}"
    assert sorted(P) == [g, r]
    assert D[g] == pytest.approx(GPS_DOPP, abs=2.0)
    assert D[r] == pytest.approx(GLO_DOPP, abs=2.0)
    tow, _ = time2gpst(epoch2time([float(x) for x in
                                   lines[last].split()[1:7]]))
    dt = tow - PTIMING / 1000.0 - TOW_G
    drift = CLIGHT * (GLO_DOPP / (FREQ1_GLO + GLO_FCN * DFRQ1_GLO)
                      - GPS_DOPP / FREQ1) * dt
    expect = CLIGHT / F_SF * (GLO_DELAY - GPS_DELAY) + drift
    assert P[r] - P[g] == pytest.approx(expect, abs=25.0)
    assert any(re.match(rf"R{GLO_SLOT:02d} \d{{4}} ", ln) for ln in t["nav"])
    assert any(re.match(rf"G{GPS_PRN:02d} \d{{4}} ", ln) for ln in t["nav"])


def test_sbas_stream_and_epochs(runs):
    """The SBAS satellite is in the last RINEX epoch beside the GPS one,
    and its NovAtel RAWSBASFRAME frames (sync AA 44 12, id 973) carry a
    valid CRC."""
    t = runs["sbas"]["torch"]
    last = t["epochs"][-1]
    assert {(o.sys, o.prn) for o in last} >= {(SYS_GPS, SBAS_GPS)}
    assert any(o.prn == SBAS_PRN for o in last)
    buf = t["sbas"]
    frames = [m.start() for m in re.finditer(b"\xaa\x44\x12", buf)]
    assert frames
    for i in frames:
        frame = buf[i:i + 80]
        assert frame[4] | (frame[5] << 8) == 973
        assert int.from_bytes(frame[76:80], "little") == \
            crc32_rtk(frame[:76])


def test_multi_receiver_checkpoint_resumes(runs, captures, tmp_path):
    """A MultiReceiver (dual: one group per RF path) stopped at 8 s with a
    checkpoint and resumed in a new one: the epochs after the checkpoint
    are the uninterrupted run's (TOWs, satellites, pseudoranges within
    1 m), G1's decode included, and so are the nav records."""
    _, paths = captures
    full = runs["dual"]["torch"]
    ini = {k: _ini(tmp_path, "dual", paths["dual"], k) for k in "ab"}
    a = _build("torch", torch_config.load_ini(ini["a"]))
    before, _ = _record(a)
    a.run_seconds(CKPT_SECONDS)
    ck = str(tmp_path / "multi.ckpt")
    a.save_checkpoint(ck)
    a.close()
    b = _build("torch", torch_config.load_ini(ini["b"]))
    b.load_checkpoint(ck)
    assert [r.base for r in b.rx] == [r.base for r in a.rx]
    assert b.epochs_written == a.epochs_written == len(before)
    after, _ = _record(b)
    b.run_seconds()
    b.close()
    assert any(o.sys == SYS_GLO for ep in after for o in ep)
    assert len(before) + len(after) == len(full["epochs"])
    for x, y in zip(full["epochs"][len(before):], after):
        assert y[0].tow == x[0].tow
        assert [o.prn for o in y] == [o.prn for o in x]
        for ox, oy in zip(x, y):
            assert oy.P == pytest.approx(ox.P, abs=1.0)
    assert _nav_records(a) + _nav_records(b) == full["nav"]


def test_cli_runs_two_rf_paths(captures, tmp_path, monkeypatch):
    """``python -m gnsslib_tpu_torch --device cpu`` on the packed two-path
    capture (FILESTEREO, FE2 I/Q) with GPS L1CA and SBAS channels on FE1
    and a G1 channel on FE2, SBAS output on: three groups (SBAS L = 2, GPS
    L = 10, G1 L = 10) run 3 s and RINEX files are written.
    ``DualReceiver`` makes one group per path, FE1's of mixed cadence on
    the per-period loop (no FastTracker)."""
    from gnsslib_tpu_torch.runtime import cli
    _, paths = captures
    chans = ([GPS_PRN, SBAS_PRN, GLO_FCN], [1, 2, 4], [1, 27, 20],
             [1, 1, 2])
    ini = _ini(tmp_path, "dual", paths["dual"], "cli", "SBAS     =1\n",
               chans)
    built = []
    make = cli.build_receiver
    monkeypatch.setattr(cli, "build_receiver", lambda *a, **kw: (
        built.append(make(*a, **kw)) or built[-1]))
    assert torch_cli([ini, "--device", "cpu", "--quiet", "--seconds",
                      "3"]) == 0
    assert sorted(p[-3:] for p in os.listdir(tmp_path / "cli")) == \
        ["nav", "obs"]
    assert [(r.spec.ftype, r.fast.L, [c.cfg.prn for c in r.channels])
            for r in built[0].rx] == [(1, 2, [SBAS_PRN]), (1, 10, [GPS_PRN]),
                                      (2, 10, [GLO_FCN])]
    cfg = torch_config.load_ini(ini)
    cfg.rinex, cfg.sbas = False, False
    fes = _frontends("torch", cfg)
    rx = DualReceiver(cfg, [fes[1], fes[2]], device="cpu")
    try:
        assert [(r.spec.ftype, [c.cfg.ctype for c in r.channels])
                for r in rx.rx] == [(1, [CodeType.L1CA, CodeType.L1SBAS]),
                                    (2, [CodeType.G1])]
        assert rx.rx[0].fast is None and rx.rx[1].fast.L == 10
    finally:
        rx.close()


# --------------------------------------------------------------------- #
def _hot_config(pkg, path):
    """test_receiver_spp_glo.py's configuration with HOTSTART on."""
    cfgm = jax_config if pkg == "jax" else torch_config
    spec_cls = JaxFrontendSpec if pkg == "jax" else FrontendSpec
    trk = (JaxTrackConfig if pkg == "jax" else TrackConfig)(
        corrn=4, corrd=2, corrp=2, interp_replica=True)
    gps_geo = _hot_geometry()[0]
    spec = spec_cls(fend=FrontendType.FILE, f_cf=1.57542e9, f_sf=H_SF,
                    f_if=F_IF, dtype=DType.REAL)
    return cfgm.ReceiverConfig(
        channels=[cfgm.ChannelConfig(prn=g["prn"]) for g in gps_geo]
        + [cfgm.ChannelConfig(prn=H_FCN, sys=SYS_GLO, ctype=CodeType.G1)],
        fends=[spec], files=[path], track=trk, outms=400, rinex=False,
        spp=True, hotstart=True)


def _assistance(pkg):
    """The GLONASS satellite's quantized Geph, keyed by slot with its FDMA
    number, as each package's own Geph."""
    glo = copy.deepcopy(_hot_geometry()[2])
    glo.frq = H_FCN
    if pkg == "jax":
        return glo
    d = {f.name: getattr(glo, f.name) for f in dataclasses.fields(glo)}
    d["toe"] = torch_gtime.GTime(glo.toe.time, glo.toe.sec)
    d["tof"] = torch_gtime.GTime(glo.tof.time, glo.tof.sec)
    return Geph(**d)


@pytest.fixture(scope="module")
def hot(captures):
    """{pkg: (receiver, epochs)} of the hot-start run in both packages."""
    _, paths = captures

    def run(pkg):
        rx = _build(pkg, _hot_config(pkg, paths["hot"]))
        glo_idx = len(rx.channels) - 1
        collect = rx.acq.search_dev_collect

        def suppress(handle):
            res = collect(handle)
            res.acquired[glo_idx] = False
            return res
        rx.acq.search_dev_collect = suppress
        rx.hub.ephs[(SYS_GLO, H_SLOT)] = _assistance(pkg)
        epochs, _ = _record(rx)
        rx.run_seconds()
        rx.close()
        return rx, epochs
    with ThreadPoolExecutor(1) as pool:         # JAX beside the port
        jax_run = pool.submit(run, "jax")
        return {"torch": run("torch"), "jax": jax_run.result()}


def test_glonass_hot_start_matches_jax(hot):
    """The G1 channel, never FFT-acquired, starts by the GLONASS hot start
    from the GPS fix and its slot-keyed assistance at the same time and
    code phase (within a sample) as in the JAX receiver, with the Doppler
    of its own carrier frequency; events, epochs and fixes are the JAX
    receiver's (positions within 2 m, as tests/test_torch_positioning.py
    holds them); the port's predicted Doppler and
    code boundary match the synthesized signal as the JAX test requires
    (within 80 Hz and 6 samples), and the channel pulls in to bit sync."""
    (jrx, jep), (trx, tep) = hot["jax"], hot["torch"]
    _same_events(jrx, trx)
    _same_epochs(jep, tep)
    assert len(trx.hub.positions) == len(jrx.hub.positions) >= 2
    for a, b in zip(jrx.hub.positions, trx.hub.positions):
        assert float(np.linalg.norm(a[2] - b[2])) <= 2.0
    hot_ev = [e for e in trx.events if e[0] == "hot"]
    assert len(hot_ev) == 1 and hot_ev[0][2] == H_FCN, trx.events
    _, t_hot, _, neg_d, loc = hot_ev[0]
    _, g_glo, _, _ = _hot_geometry()
    f_cf = FREQ1_GLO + H_FCN * DFRQ1_GLO
    d_sig = g_glo["rate"] * f_cf
    assert abs(-neg_d - d_sig) < 80.0, (neg_d, d_sig, t_hot)
    t0 = (round(t_hot * H_SF) + loc) / H_SF
    chips = (g_glo["code_phase"] + 0.511e6 * (1.0 - d_sig / f_cf) * t0) \
        % 511.0
    assert min(chips, 511.0 - chips) * H_SF / 0.511e6 < 6.0
    ch = trx.channels[-1]
    assert ch.locked and ch.nav.flagsync
