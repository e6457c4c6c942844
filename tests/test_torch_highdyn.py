"""High-dynamics tracking of the port against simulation truth and the JAX
package: the counterpart of test_highdyn.py, on its capture unchanged
(PRNs 3 and 21, a 30 Hz/s Doppler ramp from 800 and 2600 Hz, 45 dB-Hz,
26 s at 4.092 Msps, int8 scale 4).

- the port's receiver on the CPU tracks the full ramp: every epoch
  clean, the reported Doppler on the ramp (slope within 0.6 Hz/s,
  residual about the fit under 3 Hz), the between-satellite pseudorange
  rate equal to lambda x the Doppler difference within 3 m/s, both
  channels locked and decoded, no ``lol``;
- the RINEX convention phase 16 of chip_smoke.py holds its runs to: D is
  the simulation's ``doppler + doppler_rate * (t - tau)`` (t the epoch's
  GPS time of day less the capture's start, tau a lag under 0.2 s that
  both packages share), a positive slope for a positive ramp;
- the port's RINEX against the JAX receiver's on the same capture
  through the port tool's ``compare`` at the ``highdyn`` scenario's
  envelope (clock-free pseudorange RMS under 6 m, Doppler RMS under
  0.6 Hz, at least 20 common observations).  The JAX receiver runs on
  a thread beside the port's."""
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from gnsslib_tpu import sim
from gnsslib_tpu.constants import CLIGHT, DType, FrontendType
from gnsslib_tpu.io.frontend import FileFrontend as JaxFileFrontend
from gnsslib_tpu.io.frontend import FrontendSpec as JaxFrontendSpec
from gnsslib_tpu.runtime import config as j_config
from gnsslib_tpu.runtime.receiver import Receiver as JaxReceiver
from gnsslib_tpu.track.state import TrackConfig as JaxTrackConfig
from gnsslib_tpu_torch.io.frontend import FileFrontend, FrontendSpec
from gnsslib_tpu_torch.runtime import config as t_config
from gnsslib_tpu_torch.runtime.receiver import Receiver
from gnsslib_tpu_torch.tools import parity_vs_reference as pvr

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

F_SF = 4.092e6
F_IF = 1.023e6
TOW0 = 352800.0
RATE = 30.0                    # Hz/s Doppler ramp
D0 = {3: 800.0, 21: 2600.0}    # Doppler at t=0
SECONDS = 26.0


def _chunk(args):
    """test_highdyn.py's capture, samples [t0, t0 + n)."""
    t0, n = args
    chans = []
    for prn, d in ((3, 300), (21, 1300)):
        eph = sim.example_eph(prn=prn, week=2200, toe_tow=TOW0)
        frames = sim.lnav_bit_stream(eph, TOW0 + 6.0, nframes=5)
        pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
        chans.append(sim.SimChannel(
            prn=prn, doppler=D0[prn], doppler_rate=RATE,
            code_phase=-d * 1.023e6 / F_SF, carr_phase=0.1 * prn,
            nav_bits=np.concatenate([pad, frames])))
    noise = sim.noise_std_for_cn0(1.0, 45.0, F_SF, DType.REAL)
    x = sim.synthesize(chans, F_SF, F_IF, DType.REAL, n, noise_std=noise,
                       seed=1000 + t0, t0=t0)
    return sim.quantize_int8(x, 4.0).tobytes()


def _run(pkg: str, path: str, out: str):
    """test_highdyn.py's receiver (CORR 4/2/2, OUTMS 400, RINEX into
    ``out``) of package ``pkg`` over the whole capture."""
    if pkg == "jax":
        fs = JaxFrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9,
                             f_sf=F_SF, f_if=F_IF, dtype=DType.REAL)
        cfg = j_config.ReceiverConfig(
            channels=[j_config.ChannelConfig(prn=3),
                      j_config.ChannelConfig(prn=21)],
            fends=[fs], files=[path],
            track=JaxTrackConfig(corrn=4, corrd=2, corrp=2),
            outms=400, rinex=True, rinexpath=out)
        rx = JaxReceiver(cfg, JaxFileFrontend(path, fs))
    else:
        fs = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9, f_sf=F_SF,
                          f_if=F_IF, dtype=DType.REAL)
        cfg = t_config.ReceiverConfig(
            channels=[t_config.ChannelConfig(prn=3),
                      t_config.ChannelConfig(prn=21)],
            fends=[fs], files=[path],
            track=t_config.TrackConfig(corrn=4, corrd=2, corrp=2),
            outms=400, rinex=True, rinexpath=out)
        rx = Receiver(cfg, FileFrontend(path, fs), device="cpu")
    rx.run_seconds()
    obs = [p for p in os.listdir(out) if p.endswith(".obs")][0]
    return rx, os.path.join(out, obs)


@pytest.fixture(scope="module")
def ramp_runs(tmp_path_factory):
    """{pkg: (receiver, RINEX obs path)} of both packages on the ramp."""
    tmp = tmp_path_factory.mktemp("torch_highdyn")
    path = tmp / "ramp.bin"
    n, step = int(SECONDS * F_SF), int(F_SF)
    with ThreadPoolExecutor(4) as pool:
        path.write_bytes(b"".join(pool.map(
            _chunk, [(t0, min(step, n - t0)) for t0 in range(0, n, step)])))
    with ThreadPoolExecutor(1) as pool:
        theirs = pool.submit(_run, "jax", str(path), str(tmp / "jax"))
        mine = _run("torch", str(path), str(tmp / "torch"))
        return {"torch": mine, "jax": theirs.result()}


def _epochs(obs_path) -> dict:
    """PRN -> rows (t from the capture's start, P, L, D, S)."""
    rows = {}
    for (tod, (_, prn)), v in sorted(pvr.parse_obs(obs_path).items()):
        rows.setdefault(prn, []).append((tod - TOW0 % 86400.0, *v))
    return {prn: np.asarray(r) for prn, r in rows.items()}


def test_ramp_tracked_to_truth(ramp_runs):
    """test_highdyn.py's checks on the port's RINEX: every epoch clean,
    Doppler on the ramp, the clock-free pseudorange rate."""
    rec = _epochs(ramp_runs["torch"][1])
    assert set(rec) == {3, 21}
    for prn, rows in rec.items():
        assert len(rows) >= 20, f"PRN {prn}: only {len(rows)} epochs"
        assert np.isfinite(rows).all(), f"PRN {prn}: blank fields"
        t, D = rows[:, 0] - rows[0, 0], rows[:, 3]
        fit = np.polyfit(t, D, 1)
        assert abs(fit[0] - RATE) < 0.6, f"PRN {prn}: dD/dt {fit[0]}"
        resid = D - np.polyval(fit, t)
        assert np.abs(resid).max() < 3.0, f"PRN {prn}: Doppler resid"
    lam = CLIGHT / 1.57542e9
    r3 = {r[0]: r for r in rec[3]}
    r21 = {r[0]: r for r in rec[21]}
    common = sorted(set(r3) & set(r21))
    assert len(common) >= 20
    t = np.asarray(common)
    dP = np.array([r3[k][1] - r21[k][1] for k in common])
    dD = np.array([r3[k][3] - r21[k][3] for k in common])
    slope = np.polyfit(t - t[0], dP, 1)[0]
    assert abs(slope - lam * dD.mean()) < 3.0, (slope, lam * dD.mean())


def test_ramp_lock_and_decode(ramp_runs):
    rx, _ = ramp_runs["torch"]
    for ch in rx.channels:
        assert ch.locked and ch.nav.flagdec, ch.cfg.prn
    assert not [e for e in rx.events if e[0] == "lol"]


def test_doppler_convention(ramp_runs):
    """RINEX D is the simulation's Doppler, sign included, a fixed lag
    behind the epoch's time: D = D0 + RATE * (t - tau), with t the
    epoch's GPS time of day less the capture's start, tau the same in
    both packages and under 0.2 s, and D within 3 Hz of that line at every
    epoch.  Phase 16 of chip_smoke.py holds its runs to this convention:
    positive slopes for positive ramps, no offset on a constant Doppler."""
    lags = {}
    for pkg in ("torch", "jax"):
        for prn, rows in _epochs(ramp_runs[pkg][1]).items():
            off = rows[:, 3] - (D0[prn] + RATE * rows[:, 0])
            tau = -float(np.median(off)) / RATE
            lags[pkg, prn] = tau
            assert 0.0 < tau < 0.2, (pkg, prn, tau)
            assert np.abs(off + RATE * tau).max() < 3.0, (pkg, prn, off)
    for prn in D0:
        assert abs(lags["torch", prn] - lags["jax", prn]) < 0.01, lags


def test_port_rinex_against_jax_receiver(ramp_runs):
    """The port's observables against the JAX receiver's on the same
    capture, through the port tool's ``compare`` at the ``highdyn``
    scenario's envelope (p_rms 6 m, d_rms 0.6 Hz, n_common 20)."""
    theirs = pvr.parse_obs(ramp_runs["jax"][1])
    mine = pvr.parse_obs(ramp_runs["torch"][1])
    stats = pvr.compare(theirs, mine, "highdyn")
    assert stats["ok"], stats
    assert stats["n_common"] >= 20 and stats["nan_pairs"] == 0, stats
