"""The port's pipeline options against their meaning in the JAX package:
the counterparts of test_receiver.py's test_pipelined_matches_sequential,
test_pullin_pipeline_equivalent, test_acq_pipeline_matches_sequential and
test_acq_pipeline_depth_auto, on that file's construction (PRNs 3 and 21
at 4.092 Msps, 47 dB-Hz, LNAV frames after 6 s of padding bits; 26 s of
it, every run 26 s long), and the lock-generation guard of a synchronous
search.  The JAX receivers run on a thread beside the port's: the port's
sequential and pipelined-acquisition runs give the JAX runs' events (C/N0
within 1e-3 dB, peak ratio within 1e-4), epoch counts and nav records."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from gnsslib_tpu import sim
from gnsslib_tpu.constants import DType, FrontendType
from gnsslib_tpu.io.frontend import FileFrontend as JaxFileFrontend
from gnsslib_tpu.io.frontend import FrontendSpec as JaxFrontendSpec
from gnsslib_tpu.runtime import config as j_config
from gnsslib_tpu.runtime.receiver import Receiver as JaxReceiver
from gnsslib_tpu.track.state import TrackConfig as JaxTrackConfig
from gnsslib_tpu_torch.io.frontend import FileFrontend, FrontendSpec
from gnsslib_tpu_torch.nav import NavChannel
from gnsslib_tpu_torch.runtime import config as t_config
from gnsslib_tpu_torch.ops.nco import NSPAN
from gnsslib_tpu_torch.runtime.receiver import Receiver

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

F_SF = 4.092e6
F_IF = 1.023e6
TOW0 = 352800.0
DELAYS = {3: 300, 21: 1300}          # PRN -> signal delay (samples)
SECONDS = 26.0

# the runs' pipeline options (test_receiver.py's receivers)
MODES = {
    "seq": dict(pipeline=False, pipeline_acq=False, pipeline_pullin=False),
    "pipe": dict(pipeline=True, pipeline_acq=False, pipeline_pullin=False),
    "pullin": dict(pipeline_acq=False, pipeline_pullin=True),
    "acq": dict(pipeline_acq=True),
}


def _chunk(args):
    path, t0, n = args
    chans = []
    for prn, d in DELAYS.items():
        eph = sim.example_eph(prn=prn, week=2200, toe_tow=TOW0)
        frames = sim.lnav_bit_stream(eph, TOW0 + 6.0, nframes=5)
        pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
        chans.append(sim.SimChannel(
            prn=prn, doppler=500.0 + 100.0 * prn,
            code_phase=-d * 1.023e6 / F_SF, carr_phase=0.1 * prn,
            nav_bits=np.concatenate([pad, frames])))
    noise = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.REAL)
    x = sim.synthesize(chans, F_SF, F_IF, DType.REAL, n, noise_std=noise,
                       seed=1000 + t0, t0=t0)
    return sim.quantize_int8(x, 16.0).tobytes()


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """test_receiver.py's capture, 1 s chunks synthesized on threads."""
    path = tmp_path_factory.mktemp("torch_pipe") / "sim_l1ca.bin"
    n, step = int(SECONDS * F_SF), int(F_SF)
    jobs = [(path, t0, min(step, n - t0)) for t0 in range(0, n, step)]
    with ThreadPoolExecutor(4) as pool:
        path.write_bytes(b"".join(pool.map(_chunk, jobs)))
    return str(path)


def _receiver(pkg: str, path: str, prns=(3, 21), nsteps: int = 400,
              relock: bool = False, pullin_timeout: float = 8.0, **kw):
    if pkg == "jax":
        fs = JaxFrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9,
                             f_sf=F_SF, f_if=F_IF, dtype=DType.REAL)
        cfg = j_config.ReceiverConfig(
            channels=[j_config.ChannelConfig(prn=p) for p in prns],
            fends=[fs], files=[path],
            track=JaxTrackConfig(corrn=4, corrd=2, corrp=2), outms=400,
            rinex=False, relock=relock, pullin_timeout=pullin_timeout)
        return JaxReceiver(cfg, JaxFileFrontend(path, fs),
                           nsteps_per_block=nsteps, **kw)
    fs = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9, f_sf=F_SF,
                      f_if=F_IF, dtype=DType.REAL)
    cfg = t_config.ReceiverConfig(
        channels=[t_config.ChannelConfig(prn=p) for p in prns],
        fends=[fs], files=[path],
        track=t_config.TrackConfig(corrn=4, corrd=2, corrp=2), outms=400,
        rinex=False, relock=relock, pullin_timeout=pullin_timeout)
    return Receiver(cfg, FileFrontend(path, fs), device="cpu",
                    nsteps_per_block=nsteps, **kw)


def _run(pkg: str, path: str, mode: str):
    """(receiver, emitted epochs) of a SECONDS run in ``mode``."""
    rx = _receiver(pkg, path, **MODES[mode])
    epochs = []
    orig = rx.hub.emit_epochs

    def record(inputs):
        out = orig(inputs)
        epochs.extend(out)
        return out
    rx.hub.emit_epochs = record
    rx.run_seconds(seconds=SECONDS)
    return rx, epochs


@pytest.fixture(scope="module")
def runs(capture):
    """{(pkg, mode): (receiver, epochs)}: the port in every mode, the JAX
    package sequential and with pipelined acquisition (on a thread)."""
    with ThreadPoolExecutor(1) as pool:
        jax_runs = {m: pool.submit(_run, "jax", capture, m)
                    for m in ("seq", "acq")}
        out = {("torch", m): _run("torch", capture, m) for m in MODES}
        out.update((("jax", m), f.result()) for m, f in jax_runs.items())
    return out


def _by_tow(eps):
    return {round(o[0].tow, 3): {x.prn: x for x in o} for o in eps}


def _same_as_jax(jrx, trx):
    """Acquisitions (C/N0 within 1e-3 dB, peak ratio within 1e-4) and nav
    events identical; the same epoch and nav record counts."""
    acq_j = [e for e in jrx.events if e[0] == "acq"]
    acq_t = [e for e in trx.events if e[0] == "acq"]
    assert [e[:3] for e in acq_t] == [e[:3] for e in acq_j]
    for a, b in zip(acq_j, acq_t):
        assert b[3] == pytest.approx(a[3], abs=1e-3)
        assert b[4] == pytest.approx(a[4], rel=1e-4)
    nav = [e for e in jrx.events if e[0].startswith("nav:")]
    assert nav and [e for e in trx.events if e[0].startswith("nav:")] == nav
    assert trx.epochs_written == jrx.epochs_written
    assert trx.ephs_written == jrx.ephs_written


def test_pipelined_matches_sequential(runs):
    """Steady-state pipelining (dispatch block k+1 before processing
    block k's telemetry) is a pure scheduling change: identical device
    programs in the same order, so events, nav decodes and epochs must
    match the sequential receiver exactly (the blocks are placed from the
    same position estimates in both modes)."""
    rx_p, ep_p = runs[("torch", "pipe")]
    rx_s, ep_s = runs[("torch", "seq")]
    assert rx_p._pending == [] and rx_s._pending == []
    assert rx_p.events == rx_s.events
    assert rx_p.epochs_written == rx_s.epochs_written > 0
    assert rx_p.ephs_written == rx_s.ephs_written
    for cp, cs in zip(rx_p.channels, rx_s.channels):
        assert cp.nav.flagdec == cs.nav.flagdec
        assert cp.hist.nrec == cs.hist.nrec
        np.testing.assert_array_equal(cp.hist.tow[:8], cs.hist.tow[:8])
    assert [[(o.prn, o.tow, o.P, o.L, o.D) for o in e] for e in ep_p] == \
        [[(o.prn, o.tow, o.P, o.L, o.D) for o in e] for e in ep_s]
    _same_as_jax(runs[("jax", "seq")][0], rx_s)


def test_pullin_pipeline_equivalent(runs):
    """Pipelined PULL-IN (per-period blocks dispatched depth-deep, nav
    fed at maturity) defers set_bit_sync by up to pipeline_depth blocks,
    so outputs are not bit-identical to the synchronous pull-in; the
    divergence is bounded: same locks, same bit sync, same subframe
    decodes, and common-epoch observables within loop noise."""
    rx_p, ep_p = runs[("torch", "pullin")]
    rx_s, ep_s = runs[("torch", "pipe")]
    assert rx_p._pending == []
    acq_p = sorted(e for e in rx_p.events if e[0] == "acq")
    acq_s = sorted(e for e in rx_s.events if e[0] == "acq")
    assert acq_p == acq_s
    for cp, cs in zip(rx_p.channels, rx_s.channels):
        assert cp.locked and cs.locked
        assert cp.synced and cs.synced
        assert cp.nav.flagdec == cs.nav.flagdec
        assert cp.nav.polarity == cs.nav.polarity
        assert cp.nav.firstsftow == cs.nav.firstsftow
    assert rx_p.ephs_written == rx_s.ephs_written
    tp, ts = _by_tow(ep_p), _by_tow(ep_s)
    common = sorted(set(tp) & set(ts))
    assert len(common) >= 3
    t = common[-1]
    for prn in DELAYS:
        assert tp[t][prn].P == pytest.approx(ts[t][prn].P, abs=5.0)
        assert tp[t][prn].D == pytest.approx(ts[t][prn].D, abs=0.5)


def test_acq_pipeline_matches_sequential(runs):
    """Pipelined acquisition (dispatch the search, apply its decision
    acq_pipeline_depth blocks later): locks land exactly depth blocks
    late with the acquired code phase propagated to the new stream
    position; same locks, decodes and acquisition statistics, and
    common-epoch pseudoranges within loop noise (a slip of one sample
    would move P by c/f_sf = 73 m).  The pipelined run equals the JAX
    package's."""
    rx_a, ep_a = runs[("torch", "acq")]
    rx_s, ep_s = runs[("torch", "pullin")]
    assert [ch.locked for ch in rx_a.channels] == \
        [ch.locked for ch in rx_s.channels] == [True, True]
    assert all(ch.nav.flagdec for ch in rx_a.channels)
    acq_a = sorted(e for e in rx_a.events if e[0] == "acq")
    acq_s = sorted(e for e in rx_s.events if e[0] == "acq")
    assert acq_a == acq_s
    late = rx_a.acq_pipeline_depth * rx_a.nsteps
    assert all(int(a) == int(s) - late for a, s in
               zip(rx_a._cnt_host, rx_s._cnt_host))
    ta, ts = _by_tow(ep_a), _by_tow(ep_s)
    common = sorted(set(ta) & set(ts))
    assert len(common) >= 3
    t = common[-1]
    for prn in DELAYS:
        assert ta[t][prn].P == pytest.approx(ts[t][prn].P, abs=5.0)
        assert ta[t][prn].D == pytest.approx(ts[t][prn].D, abs=0.5)
    jrx = runs[("jax", "acq")][0]
    _same_as_jax(jrx, rx_a)
    np.testing.assert_array_equal(rx_a._cnt_host, jrx._cnt_host)


def test_acq_pipeline_depth_auto(capture):
    """The search-collect depth is 2 at every block size unless given, as
    in the JAX receiver; the pipeline depth sets the block's margin and so
    its span (each depth captures its own block programs)."""
    for nsteps, kw in ((400, {}), (1000, {}), (2000, {}),
                       (2000, dict(acq_pipeline_depth=3))):
        rt = _receiver("torch", capture, prns=(3,), nsteps=nsteps, **kw)
        rj = _receiver("jax", capture, prns=(3,), nsteps=nsteps,
                       precompile=False, **kw)
        assert rt.acq_pipeline_depth == rj.acq_pipeline_depth == \
            kw.get("acq_pipeline_depth", 2)
        assert rt.pipeline_depth == rj.pipeline_depth == 2
    # each depth adds its block's NSPAN drift to both margins
    spans = [_receiver("torch", capture, prns=(3,), nsteps=100,
                       pipeline_depth=d).span for d in (1, 2, 3)]
    assert np.diff(spans).tolist() == [2 * 100 * NSPAN] * 2


def test_lock_generation_guard(capture, monkeypatch):
    """RELOCK with a synchronous search: the pull-in watchdog (PULLINTMO
    1 s) resets a channel while blocks of its lock are still queued, the
    next block's search starts it again at once, and no block dispatched
    for the old lock is fed to the new lock's NavChannel (each nav update
    starts at or after its lock's first sample)."""
    fed, starts, stale = [], {}, []
    update = NavChannel.update

    def record_update(nav, ip, locs, cnt):
        fed.append((nav, int(locs[0])))
        return update(nav, ip, locs, cnt)
    monkeypatch.setattr(NavChannel, "update", record_update)
    start = Receiver._start

    def record_start(rx, i, *a):
        start(rx, i, *a)
        ch = rx.channels[i]
        starts[id(ch.nav)] = (ch.nav, int(rx._pos[i]))
        # queued blocks dispatched under an older lock of this channel
        stale.append(sum(p[5][i] != rx._lockgen[i] for p in rx._pending))
    monkeypatch.setattr(Receiver, "_start", record_start)

    rx = _receiver("torch", capture, relock=True, pullin_timeout=1.0,
                   pipeline_acq=False)
    rx.run_seconds(seconds=6.0)
    lol = [e for e in rx.events if e[0] == "lol"]
    acq = [e for e in rx.events if e[0] == "acq"]
    assert len(lol) >= 2 and len(acq) >= len(lol)
    # a restart found blocks of the old lock still queued
    assert max(stale) >= 1
    assert fed
    for nav, loc0 in fed:
        assert id(nav) in starts, "a block fed a NavChannel with no lock"
        assert loc0 >= starts[id(nav)][1] - rx.nsamp
