"""The port's receiver tools (``gnsslib_tpu_torch.tools``) against the JAX
package, on the CPU at a narrow width: the receiver tools run on
test_torch_receiver.py's construction (GPS L1CA PRNs 3 and 21 visible at
4.092 Msps, 47 dB-Hz, LNAV frames after 4 s of padding bits, bit sync
at 3.6 s; 12 s of it, four epochs)
with CORR (4, 2, 2); the JAX receivers run on a thread beside the port's.

- the rxbench capture's chunks equal the JAX tool's bytes;
- ``receiver_throughput.run`` (pipelined and sequential) gives the JAX
  Receiver's locks, decodes, epoch count and events in the same mode
  (C/N0 within 1e-3 dB, peak ratio within 1e-4, nav events exact);
- ``ttff``: the stream run equals the resident run, and the timeline
  carries the JAX milestones, ``precompiled`` included;
- ``receiver_256ch`` with duplicated PRNs equals a JAX Receiver with the
  same channel list;
- ``scaling_channels``, ``acq_throughput`` and ``e2e_receiver_check``
  against their JAX counterparts."""
import importlib.util
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gnsslib_tpu import sim as jsim
from gnsslib_tpu.acquire import Acquirer as JaxAcquirer
from gnsslib_tpu.constants import CodeType, DType, FrontendType
from gnsslib_tpu.io.frontend import FileFrontend as JaxFileFrontend
from gnsslib_tpu.io.frontend import FrontendSpec as JaxFrontendSpec
from gnsslib_tpu.nav import NavChannel as JaxNavChannel
from gnsslib_tpu.runtime import config as j_config
from gnsslib_tpu.runtime.receiver import Receiver as JaxReceiver
from gnsslib_tpu.track import TrackConfig as JaxTrackConfig
from gnsslib_tpu.track import Tracker as JaxTracker
from gnsslib_tpu_torch import sim
from gnsslib_tpu_torch.tools import (acq_throughput, e2e_receiver_check,
                                     receiver_256ch, scaling_channels, ttff)
from gnsslib_tpu_torch.tools import receiver_throughput as rxt

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_SF = 4.092e6
F_IF = 1.023e6
TOW0 = 352800.0
DELAYS = {3: 300, 21: 1300}          # visible PRN -> delay (samples)
SECONDS = 12.0
CORR = (4, 2, 2)
DUP = (3, 5, 21, 30)                 # receiver_256ch's PRNs (5, 30 absent)


def _jax_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chunk(args):
    t0, n = args
    chans = []
    for prn, d in DELAYS.items():
        eph = sim.example_eph(prn=prn, week=2200, toe_tow=TOW0)
        frames = sim.lnav_bit_stream(eph, TOW0 + 6.0, nframes=5)
        pad = np.concatenate([np.tile([1, -1], 99), [1, 1]]).astype(np.int8)
        chans.append(sim.SimChannel(
            prn=prn, doppler=500.0 + 100.0 * prn,
            code_phase=-d * 1.023e6 / F_SF, carr_phase=0.1 * prn,
            nav_bits=np.concatenate([pad, frames])))
    noise = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.REAL)
    x = sim.synthesize(chans, F_SF, F_IF, DType.REAL, n, noise_std=noise,
                       seed=1000 + t0, t0=t0)
    return sim.quantize_int8(x, 16.0).tobytes()


def _jax_receiver(path: str, prns, **kw):
    fs = JaxFrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9, f_sf=F_SF,
                         f_if=F_IF, dtype=DType.REAL)
    cfg = j_config.ReceiverConfig(
        channels=[j_config.ChannelConfig(prn=p) for p in prns],
        fends=[fs], files=[path], track=JaxTrackConfig(*CORR), outms=400,
        rinex=False)
    return JaxReceiver(cfg, JaxFileFrontend(path, fs), **kw)


def _jax_run(path: str, prns, **kw):
    rx = _jax_receiver(path, prns, **kw)
    s = rx.run_seconds()
    return rx, s


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_tools") / "sim_l1ca.bin"
    n, step = int(SECONDS * F_SF), int(F_SF)
    jobs = [(t0, min(step, n - t0)) for t0 in range(0, n, step)]
    with ThreadPoolExecutor(4) as pool:
        path.write_bytes(b"".join(pool.map(_chunk, jobs)))
    return str(path)


@pytest.fixture(scope="module")
def jax_runs(capture):
    """The JAX receivers on a thread: pipelined (with its precompile
    thread, for the ``precompiled`` milestone), sequential, and the
    duplicated-PRN channel list."""
    with ThreadPoolExecutor(1) as pool:
        yield {
            "pipe": pool.submit(_jax_run, capture, tuple(DELAYS),
                                precompile=True),
            "seq": pool.submit(_jax_run, capture, tuple(DELAYS),
                               pipeline=False),
            "dup": pool.submit(_jax_run, capture, DUP * 2),
        }


def _cap(path: str, prns=tuple(DELAYS)) -> rxt.Capture:
    return rxt.Capture(path, F_SF, F_IF, prns, CORR)


def _same_events(ev_j, ev_t):
    """Acquisitions (C/N0 within 1e-3 dB, peak ratio within 1e-4) and nav
    events identical."""
    acq_j = [e for e in ev_j if e[0] == "acq"]
    acq_t = [e for e in ev_t if e[0] == "acq"]
    assert [e[:3] for e in acq_t] == [e[:3] for e in acq_j]
    for a, b in zip(acq_j, acq_t):
        assert b[3] == pytest.approx(a[3], abs=1e-3)
        assert b[4] == pytest.approx(a[4], rel=1e-4)
    assert [e for e in ev_t if e[0] != "acq"] == \
        [e for e in ev_j if e[0] != "acq"]


def test_synth_chunk_bytes_match_jax():
    """The rxbench capture's chunks: the port's bytes equal the JAX
    tool's (12 satellites, 16.368 Msps, 0.05 s chunks at three
    offsets)."""
    jrxt = _jax_tool("receiver_throughput")
    noise = sim.noise_std_for_cn0(1.0, 46.0, rxt.F_SF, DType.REAL)
    assert noise == jsim.noise_std_for_cn0(1.0, 46.0, jrxt.F_SF, DType.REAL)
    n = int(0.05 * rxt.F_SF)
    for t0 in (0, int(rxt.F_SF), int(7.5 * rxt.F_SF)):
        tj, qj = jrxt._synth_chunk((t0, n, noise))
        tt, qt = rxt._synth_chunk((t0, n, noise, jrxt.SECONDS))
        assert tt == tj and qt.dtype == np.int8
        assert qt.tobytes() == qj.tobytes()


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "sequential"])
def test_receiver_throughput_matches_jax(capture, jax_runs, pipeline):
    """Both passes run; the timed pass's locks, decodes, epochs and events
    equal the JAX Receiver's in the same mode, and its rates are set."""
    s = rxt.run(pipeline, 400, 2, device="cpu", capture=_cap(capture))
    jrx, js = jax_runs["pipe" if pipeline else "seq"].result()
    assert sorted(s["locked"]) == sorted(js["locked"]) == sorted(DELAYS)
    assert sorted(s["decoded"]) == sorted(js["decoded"]) == sorted(DELAYS)
    assert s["epochs"] == js["epochs"] > 0
    _same_events(jrx.events, s["events"])
    assert s["label"] == ("pipelined" if pipeline else "sequential") \
        + "/400/d2"
    assert s["device"] == "cpu"
    assert s["msps"] > 0 and s["msps_steady"] > 0
    assert s["msps_steady_p50"] > 0 and s["n_steady_blocks"] >= 8


def test_ttff_stream_equals_resident(capture, jax_runs):
    """``ttff`` resident and ``--stream`` (an ended live stream through the
    live cache): identical events and epochs; the timeline carries every
    JAX milestone, ``precompiled`` first, in the order of a run, and the
    JAX Receiver's timeline has the same keys."""
    cap = _cap(capture)
    t0 = 0.0
    res = ttff.run_once(t0, device="cpu", capture=cap)
    stm = ttff.run_once(t0, device="cpu", capture=cap, stream=True)
    assert stm["events"] == res["events"]
    assert (stm["epochs"], stm["locked"], stm["decoded"]) == \
        (res["epochs"], res["locked"], res["decoded"]) == (4, 2, 2)
    for r in (res, stm):
        tl = r["timeline"]
        assert [k for k in sorted(tl, key=tl.get) if k != "build"] == \
            list(ttff.MILESTONES)
        assert tl["build"] <= tl["precompiled"]
        assert r["device"] == "cpu" and r["nvcc_s"] == {}
    jrx, _ = jax_runs["pipe"].result()
    deadline = time.monotonic() + 300.0
    while "precompiled" not in jrx.timeline and \
            time.monotonic() < deadline:    # the JAX precompile thread
        time.sleep(0.1)
    jtl = {k for k in jrx.timeline if k != "t0"}
    assert jtl == set(ttff.MILESTONES)
    # the JAX receiver precompiles on a thread: its other milestones keep
    # the order of a run
    order = [k for k in sorted(jtl, key=jrx.timeline.get)
             if k != "precompiled"]
    assert order == list(ttff.MILESTONES[1:])


def test_receiver_256ch_duplicate_prns_match_jax(capture, jax_runs):
    """receiver_256ch's build at 2 copies of 4 PRNs (two absent): the
    port's locks, decodes and events equal a JAX Receiver with the same
    duplicated channel list."""
    out = receiver_256ch.run(2, device="cpu", capture=_cap(capture, DUP))
    jrx, js = jax_runs["dup"].result()
    assert out["channels"] == 8
    assert out["locked"] == len(js["locked"]) == 4
    assert out["decoded"] == len(js["decoded"]) == 4
    assert out["epochs"] == js["epochs"]
    _same_events(jrx.events, out["events"])
    assert out["msps_steady_avg"] > 0 and out["captures"] == 0
    assert out["peak_reserved_gb"] is None and out["device"] == "cpu"


def test_scaling_channels_rows():
    """C = 2 and 4, 20-step blocks through the plain K1 version: one K1
    call per super-step run, a row each."""
    rows = scaling_channels.run((2, 4), 20, device="cpu", f_sf=F_SF,
                                f_if=F_IF, corr=CORR, reps=1)
    assert [r["C"] for r in rows] == [2, 4]
    for r in rows:
        assert r["super_steps"] == 2 and r["windows"] == 10 * r["C"]
        assert r["k1_launches"] == r["expected"] == 2 * 3
        assert r["ms_step"] > 0 and r["ms_step_event"] is None
        assert "channel-Msps" in scaling_channels.line(r)


def test_acq_throughput_matches_jax():
    """``acq_throughput --device cpu --iters 1``: the grid's bins and
    Doppler bins are the JAX Acquirer's, and the search's decisions on
    the 8 present channels equal the JAX ``_search_flat``'s."""
    r = acq_throughput.run(1, 10, device="cpu")
    acq, block = acq_throughput.workload(10, device="cpu")
    jacq = JaxAcquirer(list(range(1, 33)), [CodeType.L1CA] * 32,
                       acq_throughput.F_SF, acq_throughput.F_IF, DType.REAL,
                       intg=10)
    assert (r["bins"], r["nfreq"]) == (32 * jacq.nfreq * 10, jacq.nfreq)
    assert r["acquired"] == list(range(1, 9))
    assert r["device"] == "cpu" and r["seconds_per_search"] > 0
    _, codei, freqi, cn0, peakr, conf = acq_throughput.search(acq, block)
    out = jacq._search_flat(jnp.asarray(block.numpy()), jacq._consts)
    rj = jacq.postprocess(*[np.asarray(v) for v in out[1:]])
    rt = acq.postprocess(codei.numpy(), freqi.numpy(), cn0.numpy(),
                         peakr.numpy(), conf.numpy())
    np.testing.assert_array_equal(rt.acquired, rj.acquired)
    np.testing.assert_array_equal(rt.codei[:8], rj.codei[:8])
    np.testing.assert_array_equal(rt.freqi[:8], rj.freqi[:8])
    np.testing.assert_allclose(rt.cn0[:8], rj.cn0[:8], atol=1e-3)


def _jax_e2e_events(seconds: float) -> list:
    """e2e_receiver_check's loop through the JAX package's Acquirer,
    Tracker and NavChannel."""
    m = e2e_receiver_check
    eph = jsim.example_eph(prn=m.PRN, week=2200)
    bits = jsim.lnav_bit_stream(eph, m.TOW_START, nframes=8)
    ch = jsim.SimChannel(prn=m.PRN, doppler=m.DOPPLER,
                         code_phase=-m.CODEI_TRUE * 1.023e6 / m.F_SF,
                         carr_phase=0.37, nav_bits=bits)
    noise = jsim.noise_std_for_cn0(1.0, 45.0, m.F_SF, DType.REAL)
    acq = JaxAcquirer([m.PRN], [CodeType.L1CA], m.F_SF, m.F_IF, DType.REAL)
    head = jsim.synthesize([ch], m.F_SF, m.F_IF, DType.REAL, 12 * m.NSAMP,
                           noise_std=noise, seed=1)
    res = acq.search(np.asarray(head, np.float32))
    trk = JaxTracker(JaxTrackConfig(4, 2, 2), [m.PRN], [CodeType.L1CA],
                     m.F_SF, m.F_IF, DType.REAL)
    st = trk.start_channels(trk.init_state(), [0], [int(res.codei[0])],
                            [float(res.dcarr[0])])
    nav = JaxNavChannel(CodeType.L1CA, prn=m.PRN, ref_week=2200)
    block_len = m.NSTEPS * m.NSAMP + trk.nwin + 8 * m.NSTEPS + 16
    base = done = 0
    events, synced = [], False
    while done < int(seconds * 1000):
        data = jsim.synthesize([ch], m.F_SF, m.F_IF, DType.REAL, block_len,
                               noise_std=noise, seed=100 + done, t0=base)
        cnt0 = int(np.asarray(st.cnt)[0])
        st, out = trk.run_block(st, jnp.asarray(np.asarray(data,
                                                           np.float32)),
                                m.NSTEPS)
        for e in nav.update(out.ip[:, 0],
                            base + out.loc[:, 0].astype(np.int64), cnt0):
            events.append((e.kind, e.cnt, e.sfid, e.tow, e.week))
        if nav.flagsync and not synced:
            st = trk.set_bit_sync(st, 0, nav.sync_offset)
            synced = True
        st = trk.rebase(st, m.NSTEPS * m.NSAMP)
        base += m.NSTEPS * m.NSAMP
        done += m.NSTEPS
    return events


def test_e2e_receiver_check_matches_jax():
    """The end-to-end loop over its first 19 s (acquisition, bit sync ~6 s
    in, and the first preamble with its decode, once the framer holds the
    whole subframe that starts 12 s in): the port's nav events equal the
    same loop through the JAX package's Acquirer, Tracker and
    NavChannel."""
    seconds = 19.0
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_jax_e2e_events, seconds)
        r = e2e_receiver_check.track(seconds, device="cpu")
        jev = fut.result()
    kinds = [e[0] for e in r["events"]]
    assert kinds[:3] == ["bitsync", "preamble", "decode"], kinds
    assert r["events"] == jev
    assert bool(r["acq"].acquired[0]) and r["done"] == 20 * 950
