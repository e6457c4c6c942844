"""The port's own copies of the JAX package's host-side modules (constants,
codes, sim, nav, obs, io, the RTCM server, the track logger, the sample
histogram, the dashboards and the plots) against their
originals on the same inputs: the two copies must give identical arrays,
events, solutions and bytes, so they cannot drift apart unnoticed.  The
native host kernels are held three ways: the port's native library, its
pure-Python versions and the JAX package's native library must agree
(in a child process: ctypes calls made in the test process before the
JAX package's bladeRF binding test leave the stack words that binding's
undeclared size_t arguments pick up)."""
import dataclasses
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import gnsslib_tpu.codes as j_codes
import gnsslib_tpu.constants as j_const
import gnsslib_tpu.sim as j_sim
import gnsslib_tpu.native as j_native
import gnsslib_tpu_torch.codes as t_codes
import gnsslib_tpu_torch.constants as t_const
import gnsslib_tpu_torch.sim as t_sim
from gnsslib_tpu import gtime as j_gtime
from gnsslib_tpu.diag import htmlview as j_htmlview
from gnsslib_tpu.diag import plots as j_plots
from gnsslib_tpu.diag import spectrum as j_spectrum
from gnsslib_tpu.diag import tracklog as j_tracklog
from gnsslib_tpu.diag import watch as j_watch
from gnsslib_tpu.io import frontend as j_fe
from gnsslib_tpu.nav import NavChannel as JNav
from gnsslib_tpu.nav import eph as j_eph
from gnsslib_tpu.obs import epoch as j_epoch
from gnsslib_tpu.obs import rinex as j_rinex
from gnsslib_tpu.obs import rtcm as j_rtcm
from gnsslib_tpu.obs import smooth as j_smooth
from gnsslib_tpu.obs import spp as j_spp
from gnsslib_tpu.runtime import tcpout as j_tcpout
from gnsslib_tpu_torch import gtime as t_gtime
from gnsslib_tpu_torch import native as t_native
from gnsslib_tpu_torch.diag import htmlview as t_htmlview
from gnsslib_tpu_torch.diag import plots as t_plots
from gnsslib_tpu_torch.diag import spectrum as t_spectrum
from gnsslib_tpu_torch.diag import tracklog as t_tracklog
from gnsslib_tpu_torch.diag import watch as t_watch
from gnsslib_tpu_torch.io import formats as t_formats
from gnsslib_tpu_torch.io import frontend as t_fe
from gnsslib_tpu_torch.nav import NavChannel as TNav
from gnsslib_tpu_torch.nav import eph as t_eph
from gnsslib_tpu_torch.nav import bits as t_bits
from gnsslib_tpu_torch.nav import sbas as t_sbas
from gnsslib_tpu_torch.nav import viterbi as t_viterbi
from gnsslib_tpu_torch.obs import epoch as t_epoch
from gnsslib_tpu_torch.obs import rinex as t_rinex
from gnsslib_tpu_torch.obs import rtcm as t_rtcm
from gnsslib_tpu_torch.obs import smooth as t_smooth
from gnsslib_tpu_torch.obs import spp as t_spp
from gnsslib_tpu_torch.runtime import tcpout as t_tcpout
from gnsslib_tpu_torch.track.loop import TrackOutputs


def _constants(tmp_path):
    names = [n for n in dir(j_const) if n.isupper()]
    assert names
    for n in names:
        a, b = getattr(j_const, n), getattr(t_const, n)
        assert a == b, n
    for enum in ("CodeType", "DType", "FrontendType"):
        ja, ta = getattr(j_const, enum), getattr(t_const, enum)
        assert {m.name: int(m) for m in ja} == {m.name: int(m) for m in ta}


def _codes(tmp_path):
    prns = {"L1CA": (1, 7, 32), "L1CP": (1, 17), "L1CD": (1, 17),
            "L1CO": (1, 17), "G1": (0, 5), "L1SBAS": (120, 129),
            "NH10": (0,), "NH20": (0,)}
    for ct in j_const.CodeType:
        for prn in prns[ct.name]:
            cj, rj = j_codes.gencode(prn, ct)
            ctc, rt = t_codes.gencode(prn, t_const.CodeType(int(ct)))
            assert rj == rt and cj.dtype == ctc.dtype, (ct.name, prn)
            np.testing.assert_array_equal(cj, ctc)


def _sim(tmp_path):
    out = []
    for mod in (j_sim, t_sim):
        eph = mod.example_eph(prn=9, week=2200, toe_tow=352800.0)
        bits = mod.lnav_bit_stream(eph, 352806.0, nframes=1)
        chans = [mod.SimChannel(prn=9, doppler=1234.0, code_phase=-300.5,
                                carr_phase=0.2, nav_bits=bits),
                 mod.SimChannel(prn=3, doppler=-800.0, code_phase=-90.0)]
        for dt in (j_const.DType.REAL, j_const.DType.IQ):
            noise = mod.noise_std_for_cn0(1.0, 45.0, 4.092e6, dt)
            x = mod.synthesize(chans, 4.092e6, 1.023e6, dt, 40000,
                               noise_std=noise, seed=7, t0=12345)
            out.append((bits, x, mod.quantize_int8(x, 4.0)))
    half = len(out) // 2
    for a, b in zip(out[:half], out[half:]):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def _nav(tmp_path):
    eph = j_sim.example_eph(prn=9)
    bits = j_sim.lnav_bit_stream(eph, 352800.0, nframes=2)
    rng = np.random.default_rng(5)
    lead = np.concatenate([np.tile([1, -1], 80),
                           rng.integers(0, 2, 7) * 2 - 1])
    ip = np.repeat(np.concatenate([lead, bits]).astype(np.float64) * 1000.0,
                   20) + rng.normal(0, 150.0, (len(lead) + len(bits)) * 20)
    bl = np.arange(len(ip), dtype=np.int64) * 16368
    evs = []
    for cls in (JNav, TNav):
        nc = cls(int(j_const.CodeType.L1CA), prn=9, ref_week=2200)
        ev, pos = [], 0
        for chunk in (1500, 700, 3000, 2000, 50000):
            ev += [dataclasses.asdict(e) for e in
                   nc.update(ip[pos:pos + chunk], bl[pos:pos + chunk], pos)]
            pos += chunk
        evs.append((ev, dataclasses.asdict(nc.eph.eph), nc.firstsftow))
    assert any(e["kind"] == "decode" for e in evs[0][0])
    assert evs[0] == evs[1]


def _rinex(tmp_path):
    texts = []
    for tag, rx, ephm, ep, gt in (("j", j_rinex, j_eph, j_epoch, j_gtime),
                                  ("t", t_rinex, t_eph, t_epoch, t_gtime)):
        obs = tmp_path / f"{tag}.obs"
        nav = tmp_path / f"{tag}.nav"
        w = rx.RinexObsWriter(str(obs), [2026, 8, 16, 12, 0, 0])
        for k in range(3):
            w.write_epoch([ep.SdrObs(sys=j_const.SYS_GPS, prn=p, week=2200,
                                     tow=352800.0 + 0.4 * k,
                                     P=21234567.123 + 1000 * p + k,
                                     L=123456.789 - p, D=1234.5 + k, S=45.0)
                           for p in (5, 12)])
        n = rx.RinexNavWriter(str(nav), [2026, 8, 16, 12, 0, 0])
        e = ephm.Eph(week=2200, iode=44, iodc=44,
                     toe=gt.gpst2time(2200, 352800.0),
                     toc=gt.gpst2time(2200, 352800.0),
                     ttr=gt.gpst2time(2200, 352500.0), A=26559850.0, e=0.01,
                     toes=352800.0, f0=1.2e-4)
        n.write_eph(j_const.SYS_GPS, 7, e)
        n.write_geph(5, ephm.Geph(
            iode=30, frq=-2, toe=gt.gpst2time(2200, 352800.0),
            tof=gt.gpst2time(2200, 352700.0), pos=[1.2e7, -2.3e7, 5.6e6],
            vel=[100.0, -200.0, 300.0], acc=[1e-6, 2e-6, -3e-6],
            taun=1e-7, gamn=1e-12))
        texts.append((obs.read_bytes(), nav.read_bytes()))
    assert texts[0][0] and texts[0][1]
    assert texts[0] == texts[1]


def _frontend(tmp_path):
    raw = np.random.default_rng(3).integers(0, 256, 20000, dtype=np.uint8)
    path = tmp_path / "if.bin"
    path.write_bytes(raw.tobytes())
    FT, DT = j_const.FrontendType, j_const.DType
    specs = [(FT.FILE, DT.REAL), (FT.FILE, DT.IQ), (FT.FRTLSDR, DT.IQ),
             (FT.FGN3SV2, DT.IQ), (FT.FGN3SV3, DT.REAL),
             (FT.FGN3SV3, DT.IQ), (FT.FSTEREO, DT.REAL),
             (FT.FBLADERF, DT.IQ)]
    for fend, dt in specs:
        got = []
        for fe in (j_fe, t_fe):
            spec = fe.FrontendSpec(fend=int(fend), f_cf=1575.42e6,
                                   f_sf=4.092e6, f_if=1.023e6, dtype=int(dt))
            with fe.FileFrontend(str(path), spec) as f:
                got.append((spec.foffset, f.nsamples, f.read(100, 700),
                            f.read(f.nsamples - 50, 100),
                            f.read_narrow(10, 300)))
        for u, v in zip(*got):
            np.testing.assert_array_equal(u, v, err_msg=str((fend, dt)))


RCV = np.array([-3954844.0, 3354936.0, 3700264.0])


def _constellation(mods):
    """One epoch of ``mods``' observables for 7 satellites above 5
    degrees, from the forward model (``predict_range``) plus a 3 km
    receiver clock bias, with the ephemerides keyed for ``spp_solve``."""
    simm, sppm, ep, gt = mods
    cands, k = [], 0
    for omg0 in (-0.9, -0.55, -0.2, 0.15, 0.5, 0.85):
        for m0 in (-0.6, 0.0, 0.6):
            k += 1
            cands.append(simm.example_eph(prn=k, week=2200,
                                          toe_tow=352800.0, m0=m0,
                                          omg0=omg0))
    geo = simm.geometry_scenario(cands, RCV, 352825.0, 352800.0,
                                 min_elev_deg=5.0)[:7]
    ephs = {(j_const.SYS_GPS, c.prn): c.eph for c in cands}
    t_rx = gt.gpst2time(2200, 352825.0)
    obs = []
    for g in geo:
        tau, rate = sppm.predict_range(ephs[(j_const.SYS_GPS, g["prn"])],
                                       RCV, t_rx)
        obs.append(ep.SdrObs(sys=j_const.SYS_GPS, prn=g["prn"], week=2200,
                             tow=352825.0, P=tau * 299792458.0 + 3000.0,
                             L=1e5 * g["prn"], D=-rate * 1.57542e9,
                             S=45.0))
    return geo, ephs, obs


def _spp(tmp_path):
    res = []
    for mods in ((j_sim, j_spp, j_epoch, j_gtime),
                 (t_sim, t_spp, t_epoch, t_gtime)):
        geo, ephs, obs = _constellation(mods)
        sppm = mods[1]
        plain = sppm.spp_solve(obs, ephs)
        obs[2].P += 80.0                          # one faulty range
        raim = sppm.spp_solve(obs, ephs, raim_thresh=10.0)
        pred = sppm.predict_range(ephs[(j_const.SYS_GPS, geo[0]["prn"])],
                                  RCV + 5.0, mods[3].gpst2time(2200, 352826.0))
        res.append((plain, raim, pred, sppm.ecef2llh(plain.pos),
                    [g["prn"] for g in geo]))
    (pj, rj, qj, lj, gj), (pt, rt, qt, lt, gt_) = res
    assert gj == gt_ and len(gj) == 7
    assert float(np.linalg.norm(pj.pos - RCV)) < 1.0
    assert rj.nsat == 6 and float(np.linalg.norm(rj.pos - RCV)) < 1.0
    for a, b in ((pj, pt), (rj, rt)):
        for f in ("ok", "nsat", "iters", "clk", "clk_drift", "dop"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("pos", "resid", "vel"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert qj == qt and lj == lt


def _smooth(tmp_path):
    out = []
    for ep, sm in ((j_epoch, j_smooth), (t_epoch, t_smooth)):
        h = sm.HatchSmoother(window=5)
        r = np.random.default_rng(11)
        got = []
        for k in range(12):
            tow = 352800.0 + 0.4 * k + (3.0 if k >= 8 else 0.0)   # a gap
            obs = [ep.SdrObs(sys=j_const.SYS_GPS, prn=p, week=2200, tow=tow,
                             P=2.1e7 + 100.0 * k + float(r.normal(0, 3)),
                             L=100.0 * k / 0.190293672798365, D=0.0, S=45.0)
                   for p in (4, 9)]
            got.append([o.P for o in h.smooth(obs)])
        out.append(got)
    assert out[0] == out[1]


def _rtcm(tmp_path):
    msgs = []
    for simm, rt, ephm, gt in ((j_sim, j_rtcm, j_eph, j_gtime),
                               (t_sim, t_rtcm, t_eph, t_gtime)):
        eph = simm.example_eph(prn=9, week=2200, toe_tow=352800.0).eph
        eph.ttr = gt.gpst2time(2200, 352500.0)
        geph = ephm.Geph(iode=40, frq=-3, svh=0, age=1,
                         toe=gt.gpst2time(2200, 352800.0),
                         tof=gt.gpst2time(2200, 352700.0),
                         pos=[12e6, -15e6, 18e6],
                         vel=[1000.0, -2000.0, 500.0],
                         acc=[1e-6, -2e-6, 3e-6], taun=5e-7, gamn=1e-12,
                         dtaun=1e-9)
        gps = [(3, 21000000.123, 110e6 + 0.25, 1234.5, 45.0, 0),
               (17, 23000000.5, 120e6 - 0.75, -2345.5, 40.0, 0)]
        glo = [(5, 2.2e7, 1.1e8, -300.0, 42.0, -3)]
        msgs.append((rt.encode_1019(9, eph), rt.encode_1044(193, eph),
                     rt.encode_1020(5, geph),
                     rt.encode_msm7(j_const.SYS_GPS, gps, 2200, 352825.4),
                     rt.encode_msm7(j_const.SYS_GLO, glo, 2200, 352825.4)))
    assert all(m[0] == 0xD3 for m in msgs[0])
    assert msgs[0] == msgs[1]


def _tcpout(tmp_path):
    got = []
    for mod in (j_tcpout, t_tcpout):
        srv = mod.TcpServer(0, host="127.0.0.1")
        cli = socket.create_connection(("127.0.0.1", srv.port))
        for _ in range(500):
            if srv.nclients:
                break
            time.sleep(0.01)
        assert srv.nclients == 1
        for k in range(3):
            srv.send(bytes([0xD3, k]) * 50)
        srv.close()
        cli.settimeout(5.0)
        buf = b""
        while True:
            chunk = cli.recv(4096)
            if not chunk:
                break
            buf += chunk
        cli.close()
        got.append((buf, srv.nclients))
    assert got[0] == got[1] and len(got[0][0]) == 300


def _tracklog(tmp_path):
    rng = np.random.default_rng(2)
    steps, C, T = 30, 2, 9
    arr = {f.name: rng.normal(0, 100, (steps, C, T) if f.name in
                              ("sum_i", "sum_q") else (steps, C)
                              ).astype(np.float32)
           for f in dataclasses.fields(TrackOutputs)}
    arr["flagloopfilter"] = np.tile(np.arange(steps)[:, None] % 10 == 9,
                                    (1, C)).astype(np.int32) * 2
    out = TrackOutputs(**arr)
    texts = []
    for tag, mod, nav in (("j", j_tracklog, JNav), ("t", t_tracklog, TNav)):
        nc = nav(int(j_const.CodeType.L1CA), prn=9, ref_week=2200)
        nc.flagtow, nc.firstsftow, nc.firstsfcnt = True, 352806.0, 4
        lg = mod.TrackLogger(str(tmp_path / tag), "G09", 4, 2, 1.023e6,
                             1.023e6)
        lg.log_block(out, 1, nc, None, 120)
        lg.log_block(out, 0, nc, None, 150)
        lg.close()
        texts.append((tmp_path / tag / "logG09.csv").read_bytes())
    assert texts[0] and texts[0] == texts[1]


def _histogram(tmp_path):
    rng = np.random.default_rng(4)
    for x in (rng.integers(-128, 128, 20_000).astype(np.float32),
              rng.normal(0, 2.5, (5_000, 2)).round().astype(np.float32)):
        for nbit in (2, 3, 8):
            for a, b in zip(j_spectrum.sample_histogram(x, nbit),
                            t_spectrum.sample_histogram(x, nbit)):
                np.testing.assert_array_equal(b, a)


def _receiver_standin():
    """Host-side receiver state as the dashboards read it: two channel
    groups (a MultiReceiver's ``rx``) with locked, synced, decoded and
    idle GPS, GLONASS and SBAS channels, events, a fix, the spectrum
    monitor's latest frame, acquisition surfaces and tap shapes."""
    from types import SimpleNamespace as NS
    rng = np.random.default_rng(6)
    CT = j_const.CodeType

    def chan(prn, ctype, ftype, locked, synced, dec, tow):
        return NS(cfg=NS(prn=prn, ctype=int(ctype), ftype=ftype),
                  locked=locked, synced=synced, nav=NS(flagdec=dec),
                  hist=NS(nrec=1 if tow else 0, tow=np.array([tow or 0.0])),
                  cn0=float(rng.uniform(35, 50)),
                  dcarr_live=float(rng.uniform(-4000, 4000)),
                  prompt_live=float(rng.uniform(1e3, 9e3)))
    frame = NS(freq_hz=np.arange(512) * 8e3, pspec_db=rng.normal(40, 3, 512),
               hist_edges=np.arange(-4, 4), hist_counts=rng.integers(
                   0, 900, 8))
    g1 = NS(channels=[chan(3, CT.L1CA, 1, True, True, True, 352812.4),
                      chan(11, CT.L1CA, 1, True, True, False, None),
                      chan(19, CT.L1CA, 1, True, False, False, None),
                      chan(30, CT.L1CA, 1, False, False, False, None)],
            events=[("acq", 0.0, 3, 44.1, 9.8), ("nav:bitsync", 4.4, 3, 0,
                                                  0.0)],
            spec_monitor=NS(latest=frame),
            acq_views={3: dict(surface=rng.random((71, 409)),
                               dopp_hz=np.arange(-7000, 7001, 200.0),
                               codei=1500, grid_scale=4.0, cn0=44.1, t=0.0),
                       11: dict(surface=rng.random((71, 409)),
                                dopp_hz=np.arange(-7000, 7001, 200.0),
                                codei=6000, grid_scale=4.0, cn0=41.7,
                                t=2.0)},
            corr_views={p: dict(offsets=np.arange(-6, 7) * 3,
                                mag=rng.random(13), t=0.4 * p)
                        for p in (3, 11, 19)})
    g2 = NS(channels=[chan(-5, CT.G1, 2, True, True, True, 352810.0),
                      chan(129, CT.L1SBAS, 1, True, False, False, None)],
            events=[("nav:decode", 6.0, -5, 1, 352806.0)],
            spec_monitor=None, acq_views={}, corr_views={
                -5: dict(offsets=np.arange(-6, 7) * 3, mag=rng.random(13),
                         t=5.2)})
    hub = NS(positions=[(2200, 352812.0, np.array(
        [-3954844.0, 3354936.0, 3700264.0]), 1.5, 6)], ephs_written=7)
    return NS(rx=[g1, g2], hub=hub, epochs_written=12,
              events=sorted(g1.events + g2.events, key=lambda e: e[1]))


def _watch(tmp_path):
    import io
    rx = _receiver_standin()
    assert t_watch.channel_rows(rx.rx) == j_watch.channel_rows(rx.rx)
    for t in (0.0, 12.34, 1234.5):
        assert t_watch.render_text(rx, t) == j_watch.render_text(rx, t)
    outs = []
    for mod in (j_watch, t_watch):
        w = mod.Watch(rx, out=io.StringIO(), interval_s=0.2)
        for t in np.arange(0.0, 2.0, 0.1):
            w.tick(float(t))
        w.close()
        outs.append(w.out.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\x1b[J") == 10


def _htmlview(tmp_path):
    rx = _receiver_standin()
    for t in (0.0, 12.34):
        assert t_htmlview.render_html(rx, t, 0.2) == \
            j_htmlview.render_html(rx, t, 0.2)
    pages = []
    for tag, mod in (("j", j_htmlview), ("t", t_htmlview)):
        path = tmp_path / f"{tag}.html"
        view = mod.HtmlView(rx, str(path), interval_s=0.2)
        view.tick(3.0)
        view.close()
        pages.append(path.read_text())
    assert pages[0] == pages[1] and pages[0].count("<svg") >= 5


def _plots(tmp_path):
    """Both packages' plots (matplotlib is installed here): the same
    returned paths, each file written."""
    rng = np.random.default_rng(8)
    freq, pdb = np.arange(256) * 8e3, rng.normal(40, 3, 256)
    calls = (("plot_spectrum", (freq, pdb), {}),
             ("plot_histogram", (np.arange(-4, 4), rng.integers(0, 99, 8)),
              {}),
             ("plot_acq_surface", (rng.random((71, 128)),
                                   np.arange(-7000, 7001, 200.0)),
              dict(scale=4.0, codei=300)),
             ("plot_correlator", (np.arange(-6, 7) * 3, rng.random(13)),
              {}))
    for name, args, kw in calls:
        got = []
        for tag, mod in (("j", j_plots), ("t", t_plots)):
            (tmp_path / tag).mkdir(exist_ok=True)
            path = getattr(mod, name)(*args,
                                      str(tmp_path / tag / f"{name}.png"),
                                      **kw)
            assert os.path.getsize(path) > 0
            got.append(os.path.relpath(path, tmp_path / tag))
        assert got[0] == got[1] == f"{name}.png"


def _native_ready():
    """Both native libraries built, the port's under its build directory
    and not the JAX package's."""
    assert t_native.available() and j_native.available()
    assert t_native.library_path().parent.parts[-2:] == (
        "build", "gnsslib_tpu_torch")
    assert t_native._lib is not j_native._lib


def _three_viterbi(sym, nbits):
    """The port's native, its pure-Python and the JAX native decodes."""
    _native_ready()
    outs = [t_native.viterbi27_decode(sym, nbits),
            t_viterbi.viterbi27_decode(sym, nbits),
            j_native.viterbi27_decode(sym, nbits)]
    for o in outs[1:]:
        np.testing.assert_array_equal(np.asarray(o, np.uint8), outs[0])
    return outs[0]


def _native_viterbi_random_body():
    rng = np.random.default_rng(21)
    for nsym in (2, 64, 1000):
        _three_viterbi(rng.integers(0, 256, nsym).astype(np.uint8),
                       nsym // 2)
    # soft symbols of a coded stream through noise decode to its bits
    bits = rng.integers(0, 2, 400)
    sym = t_viterbi.conv27_encode(bits).astype(np.float64)
    noisy = np.clip(sym + rng.normal(0, 60, sym.shape), 0, 255)
    out = _three_viterbi(noisy.astype(np.uint8), 390)
    assert np.mean(out == bits[:390]) > 0.98


def _native_viterbi_sbas_body():
    """250-bit SBAS messages (MT12 and MT63, preambles 53/9A/C6), rate-1/2
    coded, as the framer sees them: hard symbols 0/255, a 1000-symbol
    buffer at every offset of a message."""
    rng = np.random.default_rng(12)
    msgs = [t_sbas.encode_sbas_message(12 if k % 3 == 0 else 63,
                                       rng.integers(0, 2, 212),
                                       (0x53, 0x9A, 0xC6)[k % 3])
            for k in range(6)]
    bits01 = ((1 - np.concatenate(msgs)) // 2).astype(np.int64)
    sym = np.where(t_viterbi.conv27_encode(bits01) == 0, 0, 255)
    sym = sym.astype(np.uint8)
    for off in range(0, 500, 37):
        out = _three_viterbi(sym[off:off + 1000], 500)
        if off % 2 == 0:       # symbol pairs aligned: the message's bits
            b = off // 2
            np.testing.assert_array_equal(out[8:480], bits01[b + 8:b + 480])


def _native_crc24q_body():
    _native_ready()
    rng = np.random.default_rng(1)
    for n in (0, 1, 3, 29, 300, 4096):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        c = t_native.crc24q_native(data)
        assert c == t_bits.crc24q(data) == j_native.crc24q_native(data)


def _native_unpackers_body():
    _native_ready()
    import ctypes
    rng = np.random.default_rng(2)
    raw = rng.integers(0, 256, 4096, dtype=np.uint8)
    for name, per in t_native.UNPACKERS.items():
        outs = []
        for lib in (t_native._lib, j_native._lib):
            out = np.empty(len(raw) * per, np.float32)
            getattr(lib, name)(
                raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            outs.append(out)
        plain = getattr(t_formats, name)(raw.tobytes())
        np.testing.assert_array_equal(outs[0], plain.ravel())
        np.testing.assert_array_equal(outs[0], outs[1])


NATIVE = ("_native_viterbi_random", "_native_viterbi_sbas",
          "_native_crc24q", "_native_unpackers")
_native_results = {}


def _native(name):
    """A case that runs ``<name>_body`` of this module in a child process
    (all four native bodies run in one child, once per test process)."""
    def case(tmp_path):
        if not _native_results:
            code = ("import sys, traceback; sys.path.insert(0, %r)\n"
                    "import test_torch_host_copies as m\n"
                    "for n in m.NATIVE:\n"
                    "    try:\n"
                    "        getattr(m, n + '_body')()\n"
                    "        print(n, 'OK')\n"
                    "    except Exception:\n"
                    "        traceback.print_exc()\n"
                    % os.path.dirname(os.path.abspath(__file__)))
            r = subprocess.run([sys.executable, "-c", code],
                               capture_output=True, text=True, timeout=600)
            _native_results.update(
                (n, f"{n} OK" in r.stdout.splitlines()) for n in NATIVE)
            _native_results["log"] = r.stdout + r.stderr[-3000:]
        assert _native_results[name], _native_results["log"]
    return case


CASES = {"constants": _constants, "codes": _codes, "sim": _sim,
         "nav": _nav, "rinex": _rinex, "frontend": _frontend, "spp": _spp,
         "smooth": _smooth, "rtcm": _rtcm, "tcpout": _tcpout,
         "tracklog": _tracklog, "histogram": _histogram, "watch": _watch,
         "htmlview": _htmlview, "plots": _plots}
CASES.update((n[1:], _native(n)) for n in NATIVE)


@pytest.mark.parametrize("case", list(CASES))
def test_host_copy_matches_original(case, tmp_path):
    CASES[case](tmp_path)
