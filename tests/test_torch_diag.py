"""The port's diagnostics against the JAX package's: the sample histogram
and the Welch spectrum, the live spectrum monitor, the acquisition surface
and the correlator tap shapes of a receiver run with SPEC, and the
terminal and HTML dashboards (the port counterparts of test_monitor.py
and test_watch.py, on their captures).

Tolerances: histograms, frame times and frequency axes exact; spectra
within 0.01 dB over the bins within 60 dB of the peak (complex64 FFT
round-off, ~1e-5 dB measured); acquisition surfaces with the same argmax
and within 1e-4 of their peak; tap magnitudes within 1e-5 of their
largest (the two trackers agree to ~1e-7 relative over these runs).  The
JAX receivers run on a thread beside the port's."""
import io
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gnsslib_tpu import sim
from gnsslib_tpu.acquire import Acquirer as JaxAcquirer
from gnsslib_tpu.constants import CodeType, DType, FrontendType, SPEC_MS
from gnsslib_tpu.diag import monitor as j_monitor
from gnsslib_tpu.diag import spectrum as j_spectrum
from gnsslib_tpu.diag.htmlview import render_html as j_render_html
from gnsslib_tpu.diag.watch import render_text as j_render_text
from gnsslib_tpu.io.frontend import FileFrontend as JaxFileFrontend
from gnsslib_tpu.io.frontend import FrontendSpec as JaxFrontendSpec
from gnsslib_tpu.runtime import config as j_config
from gnsslib_tpu.runtime.receiver import Receiver as JaxReceiver
from gnsslib_tpu.track.state import TrackConfig as JaxTrackConfig
from gnsslib_tpu_torch.acquire import Acquirer
from gnsslib_tpu_torch.diag import monitor as t_monitor
from gnsslib_tpu_torch.diag import spectrum as t_spectrum
from gnsslib_tpu_torch.diag.htmlview import HtmlView, render_html
from gnsslib_tpu_torch.diag.watch import Watch, channel_rows, render_text
from gnsslib_tpu_torch.io.frontend import FileFrontend, FrontendSpec
from gnsslib_tpu_torch.runtime import config as t_config
from gnsslib_tpu_torch.runtime.receiver import Receiver
from gnsslib_tpu_torch.track.state import TrackConfig
from torch_reference_loop import reference_carrier_loop  # noqa: F401

# the carrier loop's pull-in as the reference and the JAX package run it
# (tests/torch_reference_loop.py): the port's FLL pulls in alone first
pytestmark = pytest.mark.usefixtures("reference_carrier_loop")
torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

F_SF = 4.092e6
F_IF = 1.023e6
TOW0 = 352800.0


def _nav_channel():
    """test_watch.py's satellite: PRN 5 with an LNAV bit stream."""
    eph = sim.example_eph(prn=5, week=2200, toe_tow=TOW0)
    frames = sim.lnav_bit_stream(eph, TOW0 + 6.0, nframes=2)
    pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
    return sim.SimChannel(prn=5, doppler=900.0, code_phase=-80.0,
                          carr_phase=0.2,
                          nav_bits=np.concatenate([pad, frames]))


def _synth(args):
    path, kind, seconds = args
    if kind == "monitor":                 # test_monitor.py's capture
        x = sim.synthesize(
            [sim.SimChannel(prn=5, doppler=800.0, code_phase=100.0)],
            F_SF, F_IF, DType.REAL, int(seconds * F_SF), noise_std=1.0,
            seed=2)
    else:                                 # test_watch.py's captures
        noise = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.REAL)
        x = sim.synthesize([_nav_channel()], F_SF, F_IF, DType.REAL,
                           int(seconds * F_SF), noise_std=noise, seed=5)
    sim.quantize_int8(x, 16.0).tofile(path)
    return path


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_diag")
    jobs = [(str(tmp / f"{k}.bin"), k, s) for k, s in
            (("monitor", 2.0), ("watch", 8.0), ("html", 6.0))]
    with ThreadPoolExecutor(3) as pool:
        return dict(zip(("monitor", "watch", "html"),
                        pool.map(_synth, jobs)))


def _receiver(pkg: str, path: str, prns, spec: bool, nsteps: int = 400):
    """A JAX or port receiver on ``path`` (test_monitor.py/test_watch.py's
    configuration)."""
    if pkg == "jax":
        fs = JaxFrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9,
                             f_sf=F_SF, f_if=F_IF, dtype=DType.REAL)
        cfg = j_config.ReceiverConfig(
            channels=[j_config.ChannelConfig(prn=p) for p in prns],
            fends=[fs], files=[path],
            track=JaxTrackConfig(corrn=4, corrd=2, corrp=2),
            outms=400, rinex=False, spec=spec)
        return JaxReceiver(cfg, JaxFileFrontend(path, fs),
                           nsteps_per_block=nsteps)
    fs = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9, f_sf=F_SF,
                      f_if=F_IF, dtype=DType.REAL)
    cfg = t_config.ReceiverConfig(
        channels=[t_config.ChannelConfig(prn=p) for p in prns],
        fends=[fs], files=[path],
        track=TrackConfig(corrn=4, corrd=2, corrp=2),
        outms=400, rinex=False, spec=spec)
    return Receiver(cfg, FileFrontend(path, fs), device="cpu",
                    nsteps_per_block=nsteps)


@pytest.fixture(scope="module")
def monitor_runs(captures):
    """test_monitor.py's run (100-period blocks, SPEC) in both packages:
    (jax receiver, port receiver)."""
    def run(pkg):
        rx = _receiver(pkg, captures["monitor"], [5], True, nsteps=100)
        rx.run_seconds()
        return rx
    with ThreadPoolExecutor(1) as pool:
        j = pool.submit(run, "jax")
        trx = run("torch")
        return j.result(), trx


def _same_spectrum(fj, pj, ft, pt):
    np.testing.assert_array_equal(ft, fj)
    near = pj > pj.max() - 60.0
    assert near.mean() > 0.5
    assert np.abs(pt - pj)[near].max() <= 0.01


@pytest.mark.parametrize("nbit", [3, 8])
def test_sample_histogram_matches_jax(nbit):
    x = np.random.default_rng(nbit).integers(-128, 128, 50_000).astype(
        np.float32)
    (ej, cj), (et, ct) = (j_spectrum.sample_histogram(x, nbit),
                          t_spectrum.sample_histogram(x, nbit))
    np.testing.assert_array_equal(et, ej)
    np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("iq", [False, True], ids=["real", "iq"])
def test_welch_spectrum_matches_jax(iq):
    """Seven milliseconds of int8 samples at 4.092 Msps (a tone at the IF
    in noise; I/Q at 2.046 MHz offset), the monitor's span and window
    count."""
    rng = np.random.default_rng(7)
    n = int(0.007 * F_SF) * 4
    t = np.arange(n) / F_SF
    tone = 20.0 * np.exp(2j * np.pi * (F_IF if not iq else 0.5e6) * t)
    x = np.round(tone.real + rng.normal(0, 9, n)).astype(np.float32)
    if iq:
        x = np.stack([x, np.round(tone.imag + rng.normal(0, 9, n))],
                     axis=-1).astype(np.float32)
    fj, pj = j_spectrum.welch_spectrum(x, F_SF, iq=iq, seed=11)
    ft, pt = t_spectrum.welch_spectrum(x, F_SF, iq=iq, seed=11,
                                       device="cpu")
    _same_spectrum(fj, pj, ft, pt)
    assert pt.shape == ((16384,) if iq else (8192,))


def test_spectrum_monitor_matches_jax(monitor_runs):
    """The same frames on the same stream-time grid: times, histograms and
    axes exact, spectra at the spectrum tolerance."""
    jrx, trx = monitor_runs
    fj, ft = list(jrx.spec_monitor.frames), list(trx.spec_monitor.frames)
    assert [f.t_stream for f in ft] == [f.t_stream for f in fj]
    assert len(ft) >= 8
    for a, b in zip(fj, ft):
        np.testing.assert_array_equal(b.hist_edges, a.hist_edges)
        np.testing.assert_array_equal(b.hist_counts, a.hist_counts)
        _same_spectrum(a.freq_hz, a.pspec_db, b.freq_hz, b.pspec_db)
    assert trx.spec_monitor.nframes == len(ft)


def test_spectrum_monitor_cadence(monitor_runs):
    """test_monitor.py's checks on the port: one frame per SPEC_MS grid
    point, the histogram over 7 ms of samples, the spectrum's peak at the
    IF, the acquisition surface's peak at the acquired code phase, and the
    prompt tap dominating the tap shape."""
    _, rx = monitor_runs
    seconds = 2.0
    frames = list(rx.spec_monitor.frames)
    expect = int(seconds * 1000 / SPEC_MS)
    assert expect - 2 <= len(frames) <= expect + 1, len(frames)
    dt = np.diff([f.t_stream for f in frames])
    assert np.all(np.abs(dt - SPEC_MS / 1000.0) < 0.101), dt
    f0 = frames[-1]
    assert f0.hist_counts.sum() == int(0.007 * F_SF)
    pk = f0.freq_hz[np.argmax(f0.pspec_db)]
    assert abs(pk - F_IF) < 0.05e6, pk
    assert 5 in rx.acq_views
    v = rx.acq_views[5]
    assert v["surface"].shape == (rx.acq.nfreq, rx.acq.nsamp)
    f_pk, c_pk = np.unravel_index(np.argmax(v["surface"]),
                                  v["surface"].shape)
    assert abs(int(c_pk) - v["codei"]) <= 2
    assert 5 in rx.corr_views
    cv = rx.corr_views[5]
    assert cv["mag"].shape == cv["offsets"].shape
    assert np.argmax(cv["mag"]) == 0       # tap order [P, E1, L1, ...]


def test_receiver_views_match_jax(monitor_runs):
    """The receiver's acquisition view (surface argmax, within 1e-4 of
    its peak; code phase, Doppler axis, grid scale, C/N0, time) and
    correlator view (offsets exact, magnitudes within 1e-5 of the
    largest, time) against the JAX receiver's."""
    jrx, trx = monitor_runs
    assert sorted(trx.acq_views) == sorted(jrx.acq_views) == [5]
    a, b = jrx.acq_views[5], trx.acq_views[5]
    assert np.argmax(b["surface"]) == np.argmax(a["surface"])
    assert np.abs(b["surface"] - a["surface"]).max() <= \
        1e-4 * a["surface"].max()
    assert (b["codei"], b["grid_scale"], b["t"]) == \
        (a["codei"], a["grid_scale"], a["t"])
    np.testing.assert_array_equal(b["dopp_hz"], a["dopp_hz"])
    assert b["cn0"] == pytest.approx(a["cn0"], abs=1e-3)
    assert sorted(trx.corr_views) == sorted(jrx.corr_views) == [5]
    a, b = jrx.corr_views[5], trx.corr_views[5]
    np.testing.assert_array_equal(b["offsets"], a["offsets"])
    assert b["t"] == a["t"]
    assert np.abs(b["mag"] - a["mag"]).max() <= 1e-5 * a["mag"].max()


@pytest.mark.parametrize("f_sf,f_if", [(4.092e6, 1.023e6),
                                       (16.368e6, 4.092e6)])
def test_acq_surface_matches_jax(f_sf, f_if):
    """``search_dev(diag=True)``: the (C, F, nsamp_d) surface of every
    channel (the subset ``idx`` ignored), full-rate at 4.092 Msps and on
    the coarse grid at 16.368 Msps; argmax equal, within 1e-4 of the
    peak; the decisions equal the plain search's."""
    nsamp = int(f_sf / 1000)
    chans = [sim.SimChannel(prn=2, doppler=1400.0,
                            code_phase=-0.3 * nsamp * 1.023e6 / f_sf),
             sim.SimChannel(prn=9, doppler=-2200.0,
                            code_phase=-0.8 * nsamp * 1.023e6 / f_sf)]
    x = np.asarray(sim.synthesize(
        chans, f_sf, f_if, DType.REAL, 13 * nsamp,
        noise_std=sim.noise_std_for_cn0(1.0, 44.0, f_sf, DType.REAL),
        seed=3), np.float32)
    prns = [2, 5, 9]
    ja = JaxAcquirer(prns, [CodeType.L1CA] * 3, f_sf, f_if, DType.REAL)
    ta = Acquirer(prns, [CodeType.L1CA] * 3, f_sf, f_if, DType.REAL,
                  device="cpu")
    rj = ja.search_dev(jnp.asarray(x), diag=True)
    rt = ta.search_dev(torch.from_numpy(x), idx=[1], diag=True)
    Pj, Pt = np.asarray(rj.P), rt.P.numpy()
    assert Pt.shape == Pj.shape == (3, ta.nfreq, ta.nsamp_d)
    for c in range(3):
        assert np.argmax(Pt[c]) == np.argmax(Pj[c])
        assert np.abs(Pt[c] - Pj[c]).max() <= 1e-4 * Pj[c].max()
    np.testing.assert_array_equal(rt.acquired, [True, False, True])
    plain = ta.search_dev(torch.from_numpy(x))
    assert plain.P is None
    np.testing.assert_array_equal(rt.codei, plain.codei)
    np.testing.assert_array_equal(rt.freqi, plain.freqi)


def test_low_rate_spec_raises_in_both():
    """At 2.046 Msps (the RTL-SDR) SPEC_LEN = 7 ms is 14,322 samples, fewer
    than SPEC_NFFT = 16384: the monitor's first frame raises in both
    packages (a shared result, recorded in ROADMAP.md Queue 3)."""
    class Zeros:
        def read(self, start, n):
            return np.zeros((n, 2), np.float32)
    for mon in (j_monitor.SpectrumMonitor(Zeros(), 2.046e6, True),
                t_monitor.SpectrumMonitor(Zeros(), 2.046e6, True,
                                          device="cpu")):
        with pytest.raises(ValueError, match="nfft"):
            mon.maybe_update(0)


@pytest.fixture(scope="module")
def watch_run(captures):
    """test_watch.py's dashboard run on the port: PRN 5 present, 13
    absent, 8 s, a Watch ticking at 0.2 s into a string buffer."""
    rx = _receiver("torch", captures["watch"], [5, 13], False)
    frames_seen = []
    watch = Watch(rx, out=io.StringIO(), interval_s=0.2)
    orig_tick = watch.tick

    def tick(t):
        orig_tick(t)
        frames_seen.append(render_text(rx, t))
    watch.tick = tick
    rx.run_seconds(progress=watch.tick)
    rx.flush()
    return rx, watch, frames_seen


def test_dashboard_renders_live_state(watch_run):
    rx, watch, frames = watch_run
    assert len(frames) >= 10, "SPEC_MS cadence produced too few frames"
    final = render_text(rx, 8.0)
    assert "locked 1/2" in final
    assert "epochs" in final
    rows = channel_rows([rx])
    r5 = next(r for r in rows if r["prn"] == 5)
    r13 = next(r for r in rows if r["prn"] == 13)
    assert r5["state"] in ("track", "nav")
    assert r5["ctype"] == "L1CA"
    assert 35.0 < r5["cn0"] < 60.0
    assert abs(r5["dopp"] - (-900.0)) < 50.0 or \
        abs(r5["dopp"] - 900.0) < 50.0
    assert r5["prompt"] > 0.0
    assert r13["state"] == "idle"
    line13 = [ln for ln in final.splitlines() if ln.startswith("  13")][0]
    assert " - " in line13 or "-" in line13.split()[3]
    text = watch.out.getvalue()
    assert "\x1b[J" in text and "\x1b[" in text
    assert text.count("\x1b[J") == len(frames)


@pytest.fixture(scope="module")
def html_run(captures, tmp_path_factory):
    """test_watch.py's HTML view run on the port (6 s, SPEC on)."""
    tmp = tmp_path_factory.mktemp("torch_html")
    rx = _receiver("torch", captures["html"], [5, 13], True)
    out = tmp / "live.html"
    view = HtmlView(rx, str(out), interval_s=0.2)
    rx.run_seconds(progress=view.tick)
    rx.flush()
    view.close()
    return rx, out


def test_html_live_view(html_run):
    rx, out = html_run
    assert out.exists()
    assert not out.with_name("live.html.tmp").exists()   # atomic publish
    page = out.read_text()
    assert 'http-equiv="refresh"' in page
    assert page.count("<svg") >= 3
    assert "locked 1/2" in page
    assert "acquisition @" in page
    assert "taps @" in page
    assert "IF spectrum" in page
    final = render_html(rx, 6.0, 0.2)
    assert "L1CA" in final and ("track" in final or "nav" in final)


@pytest.mark.parametrize("view", ["text", "html"])
def test_render_matches_jax(watch_run, html_run, view):
    """Both packages' renderers on the same host-side state (the port's
    receivers after their runs) give identical strings."""
    if view == "text":
        rx = watch_run[0]
        assert render_text(rx, 8.0) == j_render_text(rx, 8.0)
    else:
        rx = html_run[0]
        assert render_html(rx, 6.0, 0.2) == j_render_html(rx, 6.0, 0.2)


def test_dashboard_never_touches_device_state(watch_run, html_run,
                                              monkeypatch):
    """Rendering reads host-side telemetry only: no tensor is copied to
    the host, read as a number or synchronized with."""
    def boom(*a, **k):
        raise AssertionError("dashboard read device state")
    for name in ("cpu", "item", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    assert "PRN" in render_text(watch_run[0], 4.0)
    assert "IF spectrum" in render_html(html_run[0], 6.0, 0.2)
