"""Loss of lock and reacquisition (RELOCK=1, ACQCONFIRM=1) in the port
against the JAX receiver: ``test_relock.py``'s fading capture (PRN 21 dark
in [14, 17) s of 34 s) and ``test_pullin_watchdog.py``'s false lock on a
pure-noise capture (PULLINTMO = 2 s).  Both packages must reset, retry and
reacquire at the same blocks."""
import numpy as np
import pytest
import torch

import jax

from gnsslib_tpu import sim
from gnsslib_tpu.constants import DType, FrontendType
from gnsslib_tpu.io.frontend import FileFrontend as JFileFrontend
from gnsslib_tpu.io.frontend import FrontendSpec as JFrontendSpec
from gnsslib_tpu.runtime.config import ChannelConfig as JChannelConfig
from gnsslib_tpu.runtime.config import ReceiverConfig as JReceiverConfig
from gnsslib_tpu.runtime.receiver import Receiver as JReceiver
from gnsslib_tpu.track.state import TrackConfig as JTrackConfig
from gnsslib_tpu_torch.io.frontend import FileFrontend, FrontendSpec
from gnsslib_tpu_torch.runtime.config import ChannelConfig, ReceiverConfig
from gnsslib_tpu_torch.runtime.receiver import Receiver
from gnsslib_tpu_torch.track.state import TrackConfig

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

F_SF = 4.092e6
F_IF = 1.023e6
TOW0 = 352800.0
SECONDS = 34.0
FADE_ON, FADE_OFF = 14.0, 17.0
PACKAGES = {
    "jax": (JReceiverConfig, JChannelConfig, JTrackConfig, JFrontendSpec,
            JFileFrontend, JReceiver, {}),
    "torch": (ReceiverConfig, ChannelConfig, TrackConfig, FrontendSpec,
              FileFrontend, Receiver, {"device": "cpu"}),
}


def _receiver(tag, path, prns, **opts):
    RC, CC, TC, FS, FF, RX, kw = PACKAGES[tag]
    spec = FS(fend=FrontendType.FILE, f_cf=1.57542e9, f_sf=F_SF, f_if=F_IF,
              dtype=DType.REAL)
    cfg = RC(channels=[CC(prn=p) for p in prns], fends=[spec],
             files=[path], track=TC(corrn=4, corrd=2, corrp=2), outms=400,
             rinex=False, relock=True, acqconfirm=True, **opts)
    return RX(cfg, FF(path, spec), **kw)


def _kinds(rx, kinds):
    return [e for e in rx.events if e[0] in kinds]


@pytest.fixture(scope="module")
def fading(tmp_path_factory):
    """test_relock.py's capture, both receivers run over all of it."""
    tmp = tmp_path_factory.mktemp("torch_relock")
    chans = {}
    for prn, d in ((3, 300), (21, 1300)):
        eph = sim.example_eph(prn=prn, week=2200, toe_tow=TOW0)
        frames = sim.lnav_bit_stream(eph, TOW0 + 6.0, nframes=6)
        pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
        chans[prn] = sim.SimChannel(
            prn=prn, doppler=500.0 + 100.0 * prn,
            code_phase=-d * 1.023e6 / F_SF, carr_phase=0.1 * prn,
            nav_bits=np.concatenate([pad, frames]))
    noise = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.REAL)
    n = int(SECONDS * F_SF)
    path = str(tmp / "fading.bin")
    with open(path, "wb") as f:
        for t0 in range(0, n, int(F_SF)):
            t_s = t0 / F_SF
            act = [chans[3]] + ([chans[21]]
                                if not FADE_ON <= t_s < FADE_OFF else [])
            x = sim.synthesize(act, F_SF, F_IF, DType.REAL,
                               min(int(F_SF), n - t0), noise_std=noise,
                               seed=1000 + t0, t0=t0)
            sim.quantize_int8(x, 16.0).tofile(f)
    out = {}
    for tag in PACKAGES:
        rx = _receiver(tag, path, [3, 21])
        epochs = []
        emit = rx.hub.emit_epochs

        def record(inputs, emit=emit, epochs=epochs):
            got = emit(inputs)
            epochs.extend(got)
            return got
        rx.hub.emit_epochs = record
        rx.run_seconds()
        out[tag] = (rx, epochs)
    return out


def test_relock_events_match_jax(fading):
    """lol, acq and nav events at the same blocks (stream times) as the
    JAX receiver's, and the cycle the JAX test demands: one lol of PRN 21
    inside the fade, reacquisition after it, PRN 3 untouched."""
    (jrx, _), (trx, _) = fading["jax"], fading["torch"]
    kinds = ("lol", "acq", "hot")
    assert [e[:3] for e in _kinds(trx, kinds)] == \
        [e[:3] for e in _kinds(jrx, kinds)]
    nav_j = [e for e in jrx.events if e[0].startswith("nav:")]
    assert [e for e in trx.events if e[0].startswith("nav:")] == nav_j
    lol = _kinds(trx, ("lol",))
    assert [e[2] for e in lol] == [21]
    assert FADE_ON <= lol[0][1] <= FADE_OFF + 1.5
    assert any(e[2] == 21 and e[1] >= FADE_OFF - 0.5
               for e in _kinds(trx, ("acq",)))


def test_observables_reconverge(fading):
    """PRN 21 is locked again, re-decoded, its observable history refilled
    (test_relock.py's end state), and the port's epochs are the JAX
    receiver's: the same TOWs and satellites, Doppler within 0.5 Hz.
    Pseudoranges: this capture is chip-commensurate (4.092 Msps, taps at
    exact half chips), where the DLL of either package answers the other's
    last-bit differences (the JAX steady-state correlator rounds to bf16)
    with steps of 1/256 sample (0.29 m) that come and go; each epoch
    within 10 m (a seventh of a sample), the median within 0.5 m."""
    (jrx, jep), (trx, tep) = fading["jax"], fading["torch"]
    ch21 = next(ch for ch in trx.channels if ch.cfg.prn == 21)
    assert ch21.locked and ch21.nav.flagdec and ch21.hist.full
    assert any(21 in [o.prn for o in ep] for ep in tep)
    assert len(tep) == len(jep) > 0
    dP = []
    for oj, ot in zip(jep, tep):
        assert ot[0].tow == oj[0].tow
        assert [o.prn for o in ot] == [o.prn for o in oj]
        for a, b in zip(oj, ot):
            assert b.D == pytest.approx(a.D, abs=0.5)
            dP.append(abs(b.P - a.P))
    assert max(dP) <= 10.0 and float(np.median(dP)) <= 0.5, max(dP)


def test_false_lock_watchdog_matches_jax(tmp_path):
    """A forced false lock on pure noise is reset by the pull-in watchdog
    (PULLINTMO = 2 s) at the same block in both packages, and never
    re-locks."""
    rng = np.random.default_rng(7)
    path = str(tmp_path / "noise.bin")
    rng.integers(-8, 8, int(9.0 * F_SF), endpoint=True).astype(
        np.int8).tofile(path)
    events = {}
    for tag in PACKAGES:
        rx = _receiver(tag, path, [5], pullin_timeout=2.0)
        orig = rx.acq.postprocess
        forced = []

        def fake(*a, orig=orig, forced=forced):
            res = orig(*a)
            if not forced:
                forced.append(True)
                res.acquired = np.ones_like(res.acquired)
                res.codei = np.full_like(res.codei, 1234)
            else:
                res.acquired = np.zeros_like(res.acquired)
            return res
        rx.acq.postprocess = fake
        rx.run_seconds()
        events[tag] = [e[:3] for e in
                       _kinds(rx, ("acq", "lol", "nav:bitsync"))]
        assert not rx.channels[0].locked
    assert events["torch"] == events["jax"]
    kinds = [e[0] for e in events["torch"]]
    assert kinds == ["acq", "lol"], events["torch"]
