"""Correlator geometries past 25 taps (CORRN 13-32, T = 2 CORRN + 1 = 33,
41 and 65 taps) in the port against the JAX package on the CPU: the
steady-state FastTracker against the JAX one's backends for the geometry
(the Pallas band kernel in interpret mode up to CORRN*CORRD = 32, the
diag and xla backends), K2 and K3-K5's plain versions against their
Pallas functions in interpret mode, and the CLI at CORRN 16 against the
JAX receiver; the offset checks that still refuse.

Tolerances are the North star's: loc exact; ip/qp median error <
1e-3·scale with at most 3 outliers > 5e-3·scale; correlation > 0.999;
dcarr within 0.5 Hz.  The kernels' card tests at these tap counts are in
tests/test_torch_cuda.py."""
import functools
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from gnsslib_tpu import sim
from gnsslib_tpu.constants import CodeType, DType
from gnsslib_tpu.io.frontend import FileFrontend
from gnsslib_tpu.ops import pallas_corr
from gnsslib_tpu.runtime.config import load_ini as jax_load_ini
from gnsslib_tpu.runtime.receiver import Receiver as JaxReceiver
from gnsslib_tpu.track import FastTracker as JaxFastTracker
from gnsslib_tpu.track import TrackConfig as JaxTrackConfig
from gnsslib_tpu.track import Tracker as JaxTracker
from gnsslib_tpu.track.state import TrackState as JaxTrackState
from gnsslib_tpu_torch.ops import band_taps as bt
from gnsslib_tpu_torch.ops import gram_taps as gt
from gnsslib_tpu_torch.ops import kernels
from gnsslib_tpu_torch.ops import window_taps as wt
from gnsslib_tpu_torch.ops.correlator import tap_offsets
from gnsslib_tpu_torch.runtime import cli
from gnsslib_tpu_torch.tools import profile_band
from gnsslib_tpu_torch.track import (FastTracker, TrackConfig, Tracker,
                                     state_from_numpy, state_to_numpy)
from torch_reference_loop import reference_carrier_loop  # noqa: F401

# the carrier loop's pull-in as the reference and the JAX package run it
# (tests/torch_reference_loop.py): the port's FLL pulls in alone first
pytestmark = pytest.mark.usefixtures("reference_carrier_loop")
torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

F_SF, F_IF = 4.092e6, 1.023e6
CHANS = {7: (900.0, 800), 11: (-1400.0, 2300), 20: (2100.0, 3500)}
PULLIN, NSTEPS = 150, 60           # periods of pull-in, then steady steps


@functools.lru_cache(maxsize=None)
def _block() -> np.ndarray:
    """0.3 s of three L1CA satellites (no data bits) at 45 dB-Hz, as the
    int8 samples of a capture (scale 16): the JAX fetch rounds samples to
    bf16, which is exact for the 8-bit alphabet of every capture path
    only."""
    chans = [sim.SimChannel(prn=p, doppler=dop, code_phase=-d * 1.023e6
                            / F_SF, carr_phase=0.1 * p)
             for p, (dop, d) in CHANS.items()]
    noise = sim.noise_std_for_cn0(1.0, 45.0, F_SF, DType.REAL)
    x = sim.synthesize(chans, F_SF, F_IF, DType.REAL, int(0.3 * F_SF),
                       noise_std=noise, seed=29)
    return sim.quantize_int8(x, 16.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _locked(corrn: int, corrd: int):
    """The port's Tracker at (corrn, corrd, 2) after PULLIN periods from
    the true code delays and Dopplers, every channel bit-synced (the
    signal has no data bits): (Tracker, state as numpy)."""
    prns = list(CHANS)
    trk = Tracker(TrackConfig(corrn, corrd, 2), prns,
                  [CodeType.L1CA] * len(prns), F_SF, F_IF, DType.REAL,
                  device="cpu")
    st = trk.start_channels(trk.init_state(), list(range(len(prns))),
                            [d for _, d in CHANS.values()],
                            [-dop for dop, _ in CHANS.values()])
    st, _ = trk.run_block(st, torch.from_numpy(_block()), PULLIN)
    for c in range(len(prns)):
        st = trk.set_bit_sync(st, c, 0)
    return trk, state_to_numpy(st)


def _close(a, b, scale):
    d = np.abs(a - b)
    assert int(np.sum(d > 5e-3 * scale)) <= 3, float(d.max())
    assert np.median(d) < 1e-3 * scale


@pytest.mark.parametrize("corrn,corrd,corr", [
    (16, 2, "band-interpret"), (16, 2, "xla"),
    (20, 2, "diag"), (20, 2, "xla"),
    (32, 1, "xla")])
def test_fast_wide_matches_jax(corrn, corrd, corr):
    """NSTEPS steady steps of the port's FastTracker (band backend: the
    plain K1 on the CPU, one call per super-step) against the JAX
    FastTracker with ``corr`` from one locked state, at 33, 41 and 65
    taps.  Before this geometry was ported the port raised ValueError."""
    ttrk, snap = _locked(corrn, corrd)
    assert len(ttrk.offsets) == 2 * corrn + 1 > kernels.MAX_TAPS
    jtrk = JaxTracker(JaxTrackConfig(corrn, corrd, 2), list(CHANS),
                      [CodeType.L1CA] * len(CHANS), F_SF, F_IF, DType.REAL)
    jf = JaxFastTracker(jtrk, use_pallas=False)
    jf.corr = corr
    js = JaxTrackState(**{k: jnp.asarray(v) for k, v in snap.items()})
    _, jo = jf.run_block(js, jnp.asarray(_block()), NSTEPS)
    tf = FastTracker(ttrk)
    assert tf.corr == "band"
    bt.COUNTS.reset()
    _, to = tf.run_block(state_from_numpy(snap, "cpu"),
                         torch.from_numpy(_block()), NSTEPS)
    assert (bt.COUNTS.plain, bt.COUNTS.kernel) == (NSTEPS // tf.L, 0)
    np.testing.assert_array_equal(to.loc, jo.loc)
    scale = np.max(np.abs(jo.ip))
    for a, b in ((jo.ip, to.ip), (jo.qp, to.qp)):
        _close(b, a, scale)
    for c in range(len(CHANS)):
        assert np.corrcoef(jo.ip[:, c], to.ip[:, c])[0, 1] > 0.999
    np.testing.assert_allclose(to.dcarr, jo.dcarr, atol=0.5)
    np.testing.assert_array_equal(to.flagloopfilter, jo.flagloopfilter)


def _rand_windows(jtrk, B, seed):
    rng = np.random.default_rng(seed)
    win = rng.integers(-40, 41, (B, jtrk.nwin)).astype(np.float32)
    rc = rng.choice(np.asarray([-1, 1], np.int8), (B, jtrk.next))
    rem = rng.uniform(0, 1, B).astype(np.float32)
    ftot = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    n = rng.integers(jtrk.n_nom - 2, jtrk.nwin + 1, B).astype(np.int32)
    l1 = max(float(np.abs(win[b, :k]).sum()) for b, k in enumerate(n))
    return win, rc, rem, ftot, n, l1


@functools.lru_cache(maxsize=None)
def _jax_tracker33():
    return JaxTracker(JaxTrackConfig(16, 2, 2), [7, 8], [CodeType.L1CA] * 2,
                      F_SF, F_IF, DType.REAL)


@pytest.mark.parametrize("name", ["correlate_windows", "correlate_windows8",
                                  "correlate_windows16"])
def test_window_plain_wide_matches_pallas_interpret(name):
    """K5/K4/K3 at 33 taps: the wrapper's plain version on the CPU against
    its Pallas function in interpret mode (1e-5 of the window L1 norm)."""
    jtrk = _jax_tracker33()
    win, rc, rem, ftot, n, l1 = _rand_windows(jtrk, 16, 61)
    bf16 = name == "correlate_windows16"
    offsets = tuple(int(o) for o in jtrk.offsets)
    assert len(offsets) == 33
    jw = jnp.asarray(win).astype(jnp.bfloat16 if bf16 else jnp.float32)
    jrc = jnp.asarray(rc if bf16 else rc.astype(np.float32))
    args = (jw, jrc, jnp.asarray(rem), jnp.asarray(ftot), jnp.asarray(n))
    if name == "correlate_windows":
        zj = pallas_corr.correlate_windows(*args, offsets=offsets,
                                           smax=jtrk.smax, interpret=True)
    else:
        zj = getattr(pallas_corr, f"{name}_impl")(
            *args, offsets, jtrk.smax, interpret=True)
    tw = torch.from_numpy(win)
    trc = torch.from_numpy(rc)
    tw, trc = (tw.to(torch.bfloat16), trc) if bf16 else \
        (tw, trc.to(torch.float32))
    zt = getattr(wt, name)(tw, trc, torch.from_numpy(rem),
                           torch.from_numpy(ftot), torch.from_numpy(n),
                           offsets, jtrk.smax)
    assert zt.shape == (16, 66)
    assert float(np.abs(zt.numpy() - np.asarray(zj)).max()) <= 1e-5 * l1


def test_gram_plain_wide_matches_taps_fused():
    """K2 at 33 taps: the plain version against the JAX fused backend's
    ``gram_usum_impl`` in interpret mode (the JAX side rounds each Gram
    entry to bf16: test_fast.py's inter-backend bound)."""
    jtrk = _jax_tracker33()
    jf = JaxFastTracker(jtrk, use_pallas=False)
    K = jf._fetch_nr - 1
    rng = np.random.default_rng(67)
    B = 8
    n = rng.integers(jtrk.n_nom - 2, jtrk.n_nom + 3, B)
    keep = np.arange(K * 128).reshape(K, 128)[None] < n[:, None, None]
    wi = rng.integers(-40, 41, (B, K, 128)).astype(np.float32) * keep
    rc = rng.choice(np.asarray([-1, 1], np.int8), (B, jtrk.next))
    rem = rng.uniform(0, 1, B).astype(np.float32)
    ftot = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    zj = np.asarray(jf._taps_fused(jnp.asarray(wi, jnp.bfloat16),
                                   jnp.asarray(rc), jnp.asarray(rem),
                                   jnp.asarray(ftot), interpret=True))
    gt.COUNTS.reset()
    zt = gt.gram_taps(torch.from_numpy(wi).to(torch.bfloat16), None,
                      torch.from_numpy(rc), torch.from_numpy(rem),
                      torch.from_numpy(ftot), jtrk.offsets, jtrk.smax)
    assert gt.COUNTS.plain == 1 and zt.shape == zj.shape == (B, 66)
    zt = zt.numpy()
    _close(zt, zj, np.max(np.abs(zj)))
    assert np.corrcoef(zt.ravel(), zj.ravel())[0, 1] > 0.999


def test_offset_checks_and_tap_plan():
    """check_offsets takes any odd count within smax and still refuses an
    even count and |offset| > smax; K2-K5's tap plan covers every tap
    once, in groups of at most 25 about their centres."""
    offsets = tuple(int(o) for o in tap_offsets(32, 1))
    assert kernels.check_offsets("op", offsets, 32) == offsets
    with pytest.raises(ValueError, match="odd tap count"):
        kernels.check_offsets("op", offsets[:-1], 32)
    with pytest.raises(ValueError, match="smax=31"):
        kernels.check_offsets("op", offsets, 31)
    for T in range(1, 132, 2):
        sizes = kernels.tap_groups(T)
        assert sum(sizes) == T and len(sizes) % 2 == 1
        assert all(g % 2 == 1 and g <= kernels.MAX_TAPS for g in sizes)
    for corrn, d in ((16, 2), (20, 2), (32, 1), (6, 3)):
        offs = tuple(int(o) for o in tap_offsets(corrn, d))
        for prog in (d, None):
            plan = kernels.tap_plan(offs, prog)
            cols = [c for _, _, cs in plan for c in cs]
            assert sorted(cols) == list(range(len(offs)))
            for g, shift, cs in plan:
                assert [offs[c] for c in cs] == [shift + o for o in g]
                assert prog is None or \
                    g == tuple(int(o) for o in tap_offsets(len(g) // 2, d))
                assert all(abs(shift + o) <= corrn * d for o in g)


def test_wide_design_sources():
    """profile_band's --wide designs: the kernel as it is and the one
    that recomputes the carrier in every tap group at every window (the
    source's path where staging does not fit), each finding its line
    once."""
    src = profile_band.variant_source("recompute")
    assert "const bool staged = false;" in src
    assert src != profile_band.variant_source("kernel")
    assert tuple(profile_band.WIDE_VARIANTS) == ("kernel", "recompute")
    assert [2 * c + 1 for c, _, _ in profile_band.WIDE] == [33, 41, 65]


# --- the CLI at CORRN 16 against the JAX receiver ---------------------- #
TOW0 = 352800.0
DELAYS = {3: 300, 21: 1300}          # visible PRN -> delay (samples)
PAD = 4.2             # s of alternating bits before the first subframe
SECONDS = 11.8


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """11.8 s of two GPS satellites, an INI at CORRN/CORRD/CORRP 16/2/2 (33
    taps).  The nav decoder votes for bit sync from 2000 tracked periods on
    (50 bit edges of the alternating pad bits; the receivers declare it
    3.6 s in) and decodes a subframe once all of it has arrived after the
    sync, so the first subframe starts at PAD, is decoded 6 s later, and
    the capture carries a few epochs after it.  Samples from
    chip_smoke's synthesis on the CPU (sim's signal model, torch's noise;
    tests/test_torch_smoke_synth.py), 1 s at a time."""
    tmp = tmp_path_factory.mktemp("wide_rx")
    nbits = int(PAD * 50)
    pad = np.concatenate([np.tile([1, -1], nbits // 2 - 1), [1, 1]]
                         ).astype(np.int8)
    chans = []
    for prn, d in DELAYS.items():
        eph = sim.example_eph(prn=prn, week=2200, toe_tow=TOW0)
        chans.append(sim.SimChannel(
            prn=prn, doppler=500.0 + 100.0 * prn,
            code_phase=-d * 1.023e6 / F_SF, carr_phase=0.1 * prn,
            nav_bits=np.concatenate([pad, sim.lnav_bit_stream(
                eph, TOW0 + 6.0, nframes=1)])))
    noise = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.REAL)
    path = tmp / "wide_l1ca.bin"
    n, step = int(SECONDS * F_SF), int(F_SF)
    with open(path, "wb") as f:
        for t0 in range(0, n, step):
            x = chip_smoke._synthesize(torch.device("cpu"), chans, F_SF,
                                       F_IF, False, min(step, n - t0),
                                       noise, 71 + t0, t0)
            f.write(chip_smoke._quantize(x, "int8", 16.0))
    (tmp / "fend.ini").write_text(f"""[FEND]
TYPE     =FILE
CF1      =1575.42e6
SF1      ={F_SF}
IF1      ={F_IF}
DTYPE1   =1
FILE1    ={path}
[TRACK]
CORRN    =16
CORRD    =2
CORRP    =2
""")
    ini = tmp / "rx.ini"
    ini.write_text(f"""[RCV]
FENDCONF ={tmp / "fend.ini"}
[CHANNEL]
NCH      =2
PRN      =3,21
SYS      =1,1
CTYPE    =1,1
FTYPE    =1,1
[OUTPUT]
OUTMS    =400
RINEX    =1
RINEXPATH={tmp}/out
""")
    return ini


def _epochs(rx) -> list:
    """The list that ``rx``'s hub appends its emitted epochs to."""
    out, emit = [], rx.hub.emit_epochs

    def record(inputs):
        eps = emit(inputs)
        out.extend(eps)
        return eps
    rx.hub.emit_epochs = record
    return out


def test_cli_wide_matches_jax(capture, monkeypatch):
    """``python -m gnsslib_tpu_torch rx.ini --device cpu`` at 33 taps
    against the JAX receiver on the same INI: the same locks, nav events
    (bit sync, preambles, decoded subframes) and epochs; Doppler within
    0.5 Hz, pseudoranges within the relock bound (each epoch within 10 m,
    the median within 0.5 m: tests/test_torch_relock.py).  The JAX
    receiver runs on a thread beside the CLI."""
    jcfg = jax_load_ini(str(capture))
    jcfg.rinex = False
    jrx = JaxReceiver(jcfg, FileFrontend(jcfg.files[0], jcfg.fends[0]))
    jep, jerr = _epochs(jrx), []

    def run_jax():
        try:
            jrx.run_seconds()
        except BaseException as e:          # re-raised below
            jerr.append(e)
    made, build = {}, cli.build_receiver

    def keep(*a, **kw):
        rx = made["rx"] = build(*a, **kw)
        made["epochs"] = _epochs(rx)
        return rx
    monkeypatch.setattr(cli, "build_receiver", keep)
    th = threading.Thread(target=run_jax)
    th.start()
    try:
        assert cli.main([str(capture), "--device", "cpu", "--quiet"]) == 0
    finally:
        th.join()
    jrx.close()
    if jerr:
        raise jerr[0]
    trx, tep = made["rx"], made["epochs"]
    assert trx.fast.offsets.shape[0] == 33 and trx.fast.corr == "band"
    assert [c.locked for c in trx.channels] == \
        [c.locked for c in jrx.channels] == [True, True]
    nav = [e for e in trx.events if e[0].startswith("nav:")]
    assert nav == [e for e in jrx.events if e[0].startswith("nav:")]
    assert any(e[0] == "nav:decode" for e in nav)
    assert [c.nav.flagdec for c in trx.channels] == \
        [c.nav.flagdec for c in jrx.channels]
    assert len(tep) == len(jep) > 0
    dP = []
    for oj, ot in zip(jep, tep):
        assert ot[0].tow == oj[0].tow
        assert [o.prn for o in ot] == [o.prn for o in oj]
        for a, b in zip(oj, ot):
            assert b.D == pytest.approx(a.D, abs=0.5)
            dP.append(abs(b.P - a.P))
    assert max(dP) <= 10.0 and float(np.median(dP)) <= 0.5, max(dP)
    assert sorted(os.listdir(capture.parent / "out"))
