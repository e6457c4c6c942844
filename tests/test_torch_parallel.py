"""The port's channel- and Doppler-sharded engines and mesh receiver
(``gnsslib_tpu_torch.parallel``) against the JAX package's, on the CPU:
the counterparts of ``tests/test_parallel.py``.

The JAX sharded objects run on the conftest's 8 virtual CPU devices
(``make_mesh(8)``/``make_mesh(4)``), the port's on ``make_mesh(devices=
["cpu"] * n)``, from the same numpy inputs (F_SF = 1.023e6, C = 8; the
receivers on the JAX test's 4-PRN 9 s capture at 4.092 Msps).

Tolerances: the port's sharded engine against its unsharded one, bit for
bit (the JAX test holds its own pair to ip rtol 1e-5 / atol 1e-3, loc
exact, remcode 1e-6, cn0 rtol 1e-4, decisions exact); the port against
JAX at the JAX test's tolerances where both packages compute the same f32
sums (pull-in, acquisition), and at ``test_torch_fast.py``'s
cross-package bound in the steady state, where the JAX backends round
the mixed samples to bf16 (loc and loop flags exact there, dcarr within
0.5 Hz)."""
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gnsslib_tpu import sim
from gnsslib_tpu.acquire import Acquirer as JaxAcquirer
from gnsslib_tpu.constants import CodeType, DType, FrontendType
from gnsslib_tpu.parallel import ShardedAcquirer as JaxShardedAcquirer
from gnsslib_tpu.parallel import ShardedFastTracker as JaxShardedFast
from gnsslib_tpu.parallel import ShardedTracker as JaxShardedTracker
from gnsslib_tpu.parallel import make_mesh as jax_mesh
from gnsslib_tpu.track import FastTracker as JaxFastTracker
from gnsslib_tpu.track import TrackConfig as JaxTrackConfig
from gnsslib_tpu.track import Tracker as JaxTracker
from gnsslib_tpu_torch.acquire import Acquirer
from gnsslib_tpu_torch.parallel import (Mesh, ShardedAcquirer,
                                        ShardedFastTracker, ShardedTracker,
                                        make_mesh)
from gnsslib_tpu_torch.track import (FastTracker, TrackConfig, Tracker,
                                     state_from_numpy, state_to_numpy)
from torch_reference_loop import reference_carrier_loop  # noqa: F401

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

F_SF = 1.023e6          # 1 sample/chip: tiny shapes
F_IF = F_SF / 4
C = 8

# the carrier loop's pull-in as the reference and the JAX package run it
# (tests/torch_reference_loop.py): the port's FLL pulls in alone first
pytestmark = [pytest.mark.usefixtures("reference_carrier_loop"),
              pytest.mark.skipif(len(jax.devices()) < 8,
                                 reason="needs 8 JAX devices")]


def _signal(n):
    chans = [sim.SimChannel(prn=p, doppler=200.0 * p - 900.0,
                            code_phase=50.0 * p, carr_phase=0.1 * p)
             for p in range(1, 5)]
    return np.asarray(sim.synthesize(chans, F_SF, F_IF, DType.REAL, n,
                                     noise_std=0.5, seed=9), np.float32)


def _cpu(n):
    return make_mesh(devices=["cpu"] * n)


def _trackers(nch):
    prns = list(range(1, nch + 1))
    jt = JaxTracker(JaxTrackConfig(corrn=1, corrd=1, corrp=1), prns,
                    [CodeType.L1CA] * nch, F_SF, F_IF, DType.REAL)
    tt = Tracker(TrackConfig(corrn=1, corrd=1, corrp=1), prns,
                 [CodeType.L1CA] * nch, F_SF, F_IF, DType.REAL,
                 device="cpu")
    return jt, tt, prns


def _started(jt, prns, synced=False):
    """The JAX test's started state, and the same state in the port."""
    nch = len(prns)
    js = jt.start_channels(jt.init_state(), list(range(nch)),
                           [10 * p for p in prns],
                           [100.0 * p - 400.0 for p in prns])
    if synced:
        for c in range(nch):
            js = jt.set_bit_sync(js, c, c % 10)
    return js, state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in js.__dataclass_fields__},
        "cpu")


def _same_outputs(a, b):
    """Two port TrackOutputs, bit for bit."""
    for f in a.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def _same_states(a, b):
    da, db = state_to_numpy(a), state_to_numpy(b)
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def _jax_tol(jo, js, to, ts):
    """The JAX test's tolerances (ip, loc, remcode)."""
    np.testing.assert_allclose(to.ip, jo.ip, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(to.loc, jo.loc)
    np.testing.assert_allclose(state_to_numpy(ts)["remcode"],
                               np.asarray(js.remcode), atol=1e-6)


def _cross(jo, to, loop=True):
    """test_torch_fast.py's bound between the packages' steady state: ip/qp
    median error < 1e-3*scale with at most 3 outliers > 5e-3*scale, loc
    exact; with ``loop`` also the loop flags exact and dcarr within 0.5
    Hz."""
    for a, b in ((jo.ip, to.ip), (jo.qp, to.qp)):
        scale = np.max(np.abs(a))
        d = np.abs(a - b)
        assert int(np.sum(d > 5e-3 * scale)) <= 3, float(d.max())
        assert np.median(d) < 1e-3 * scale
    np.testing.assert_array_equal(to.loc, jo.loc)
    if loop:
        np.testing.assert_array_equal(to.flagloopfilter, jo.flagloopfilter)
        np.testing.assert_allclose(to.dcarr, jo.dcarr, atol=0.5)


def _same_acq(ra, rb):
    for f in ("codei", "freqi", "cn0", "peakr", "acquired", "confirmed"):
        np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f),
                                      err_msg=f)


def _jax_acq_tol(rj, rt, peakr=False):
    np.testing.assert_array_equal(rt.codei, rj.codei)
    np.testing.assert_array_equal(rt.freqi, rj.freqi)
    np.testing.assert_allclose(rt.cn0, rj.cn0, rtol=1e-4)
    if peakr:
        np.testing.assert_allclose(rt.peakr, rj.peakr, rtol=1e-4)
    np.testing.assert_array_equal(rt.acquired, rj.acquired)


def _acquirers(prns, intg):
    n = len(prns)
    return (JaxAcquirer(prns, [CodeType.L1CA] * n, F_SF, F_IF, DType.REAL,
                        intg=intg),
            Acquirer(prns, [CodeType.L1CA] * n, F_SF, F_IF, DType.REAL,
                     device="cpu", intg=intg))


# ---------------------------------------------------------------------- #
def test_mesh_ranges_and_devices():
    """Contiguous, uneven channel ranges; empty shards skipped; explicit
    and repeated devices; too few cards raise the JAX message (no CPU
    fallback); owners out of rank order are refused."""
    m = _cpu(4)
    assert m.shape == {"ch": 4} and m.axis == "ch"
    assert m.ranges(13) == [(0, 0, 4), (1, 4, 7), (2, 7, 10), (3, 10, 13)]
    assert m.ranges(6) == [(0, 0, 2), (1, 2, 4), (2, 4, 5), (3, 5, 6)]
    assert _cpu(8).ranges(5) == [(i, i, i + 1) for i in range(5)]
    assert all(d == torch.device("cpu") for d in m.devices)
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {have + 1} devices, have "
                                         f"{have}"):
        make_mesh(have + 1)
    with pytest.raises(ValueError, match="rank order"):
        Mesh(["cpu", None], owners=[1, 0], rank=1)
    g = Mesh(["cpu", "cpu", None, None], owners=[0, 0, 1, 1], rank=0)
    assert g.nproc == 2 and g.local(6) == [(0, 0, 2), (1, 2, 4)]


def test_sharded_tracker_matches_single():
    jt, tt, prns = _trackers(C)
    nsteps = 12
    data = _signal(nsteps * jt.n_nom + jt.nwin + 8 * nsteps + 3000)
    js0, ts0 = _started(jt, prns)
    js, jo = JaxShardedTracker(jt, jax_mesh(8)).run_block(
        js0, jnp.asarray(data), nsteps)
    strk = ShardedTracker(tt, _cpu(8))
    assert [b - a for a, b, _ in strk.shards] == [1] * 8
    ts, to = strk.run_block(ts0, torch.from_numpy(data), nsteps)
    ts1, to1 = tt.run_block(ts0, torch.from_numpy(data), nsteps)
    _same_outputs(to, to1)
    _same_states(ts, ts1)
    _jax_tol(jo, js, to, ts)


def test_sharded_acquirer_matches_single():
    prns = list(range(1, C + 1))
    ja, ta = _acquirers(prns, 3)
    data = _signal((ja.intg + 2) * ja.nsamp)
    sacq = ShardedAcquirer(ta, _cpu(8))
    assert sacq.mode == "ch"
    rt = sacq.search(data)
    _same_acq(rt, ta.search(data))
    _jax_acq_tol(JaxShardedAcquirer(ja, jax_mesh(8)).search(data), rt)
    # the receiver's entry point: the device block, the surface kept
    rd = sacq.search_dev(torch.from_numpy(data), diag=True)
    _same_acq(rd, rt)
    assert rd.P.shape == (C, ta.nfreq, ta.nsamp_d)
    assert torch.equal(rd.P, ta.search_dev(torch.from_numpy(data),
                                           diag=True).P)


def test_sharded_fast_tracker_matches_single():
    """Steady state over the mesh (the xla backend, the JAX test's
    ``use_pallas=False``), and the pipelined API with two blocks in
    flight, collected in order."""
    jt, tt, prns = _trackers(C)
    fast = FastTracker(tt, use_pallas=False)
    nsteps = 40                       # 4 super-steps of L=10
    data = _signal(nsteps * jt.n_nom + jt.nwin + 8 * nsteps + 3000)
    block = torch.from_numpy(data)
    js0, ts0 = _started(jt, prns, synced=True)
    js, jo = JaxShardedFast(JaxFastTracker(jt, use_pallas=False),
                            jax_mesh(8)).run_block(js0, jnp.asarray(data),
                                                   nsteps)
    sfast = ShardedFastTracker(fast, _cpu(8))
    ts, to = sfast.run_block(ts0, block, nsteps)
    ts1, to1 = fast.run_block(ts0, block, nsteps)
    _same_outputs(to, to1)
    _same_states(ts, ts1)
    _cross(jo, to)
    np.testing.assert_allclose(state_to_numpy(ts)["remcode"],
                               np.asarray(js.remcode), atol=1e-4)

    st1, h1 = sfast.run_block_start(ts0, block, nsteps)
    # the JAX test rebases by 0 and its second block reads clamped samples
    # past the block's end; the port's backends refuse that, so the second
    # block starts where the first ended, nominally
    st1 = sfast.rebase(st1, nsteps * jt.n_nom)
    st2, h2 = sfast.run_block_start(st1, block, nsteps)
    o1 = sfast.run_block_collect(h1)
    o2 = sfast.run_block_collect(h2)
    _same_outputs(o1, to1)
    _, o2_ref = fast.run_block(st1, block, nsteps)
    _same_outputs(o2, o2_ref)


def test_sharded_acquirer_doppler_axis_few_channels():
    """C = 2 on 8 shards engages the Doppler axis: each shard's power stage
    covers its slice of the grid, the decision runs once; equal to the
    unsharded search and to channel mode, and to the JAX freq mode."""
    prns = [3, 7]
    ja, ta = _acquirers(prns, 4)
    data = _signal((ja.intg + 2) * ja.nsamp)
    sacq = ShardedAcquirer(ta, _cpu(8))
    assert sacq.mode == "freq"
    assert [(a, b) for a, b, _, _ in sacq.shards][:2] == [(0, 9), (9, 18)]
    rt = sacq.search(data)
    _same_acq(rt, ta.search(data))
    _same_acq(ShardedAcquirer(ta, _cpu(8), mode="ch").search(data), rt)
    jsacq = JaxShardedAcquirer(ja, jax_mesh(8))
    assert jsacq.mode == "freq"
    _jax_acq_tol(jsacq.search(data), rt, peakr=True)
    rd = sacq.search_dev(torch.from_numpy(data), diag=True)
    assert torch.equal(rd.P, ta.search_dev(torch.from_numpy(data),
                                           diag=True).P)


def test_sharded_band_correlator_matches_single():
    """The band backend (K1's plain version on the CPU) on every shard:
    the caller's ``corr`` is kept on the shards (no downgrade) and the
    caller's engine is not written; equal to the unsharded band program,
    and within the cross-package bound of the JAX band kernel (interpret
    mode) over its mesh.  A backend set on the wrapped engine afterwards
    reaches the shards at the next block."""
    jt, tt, prns = _trackers(C)
    fast = FastTracker(tt)
    assert fast.corr == "band"
    nsteps = 20                        # 2 super-steps of L=10
    data = _signal(nsteps * jt.n_nom + jt.nwin + 8 * nsteps + 3000)
    block = torch.from_numpy(data)
    js0, ts0 = _started(jt, prns, synced=True)
    jf = JaxFastTracker(jt, use_pallas=False)
    jf.corr = "band-interpret"
    js, jo = JaxShardedFast(jf, jax_mesh(8)).run_block(
        js0, jnp.asarray(data), nsteps)
    sfast = ShardedFastTracker(fast, _cpu(8))
    ts, to = sfast.run_block(ts0, block, nsteps)
    assert {e.corr for _, _, e in sfast.shards} == {"band"}
    assert fast.corr == "band" and sfast.fast is fast
    ts1, to1 = fast.run_block(ts0, block, nsteps)
    _same_outputs(to, to1)
    _same_states(ts, ts1)
    # the JAX test's fields (ip, loc): at one sample per chip the f32 band
    # and the bf16 band round PRN 1's near-zero prompt apart enough to
    # flip its FLL branch (dcarr -285.6 against -318.8 Hz after two
    # super-steps; the port's xla backend, which rounds as JAX does, gives
    # -318.8), so its loop state is not compared across the packages
    _cross(jo, to, loop=False)
    fast.corr = "pallas"
    _, to_p = sfast.run_block(ts0, block, nsteps)
    assert {e.corr for _, _, e in sfast.shards} == {"pallas"}
    _same_outputs(to_p, fast.run_block(ts0, block, nsteps)[1])


def test_sharded_uneven_channels():
    """6 channels on 4 shards (2, 2, 1, 1: no padding) through the pull-in
    and steady engines, the steady one through its pipelined API; 5
    channels on 8 shards in the acquisition's freq and channel modes."""
    cu = 6
    jt, tt, prns = _trackers(cu)
    strk = ShardedTracker(tt, _cpu(4))
    assert [b - a for a, b, _ in strk.shards] == [2, 2, 1, 1]
    nsteps = 12
    data = _signal(nsteps * jt.n_nom + jt.nwin + 8 * nsteps + 3000)
    block = torch.from_numpy(data)
    js0, ts0 = _started(jt, prns)
    js, jo = JaxShardedTracker(jt, jax_mesh(4)).run_block(
        js0, jnp.asarray(data), nsteps)
    ts, to = strk.run_block(ts0, block, nsteps)
    assert to.ip.shape == jo.ip.shape
    ts1, to1 = tt.run_block(ts0, block, nsteps)
    _same_outputs(to, to1)
    _same_states(ts, ts1)
    _jax_tol(jo, js, to, ts)

    fast = FastTracker(tt, use_pallas=False)
    sfast = ShardedFastTracker(fast, _cpu(4))
    nsteps = 40
    # a block of 40 periods (the JAX test reuses the 12-period one, whose
    # end its backend clamps into; the port's refuses such windows)
    data = _signal(nsteps * jt.n_nom + jt.nwin + 8 * nsteps + 3000)
    block = torch.from_numpy(data)
    js0, ts0 = _started(jt, prns, synced=True)
    js, jo = JaxShardedFast(JaxFastTracker(jt, use_pallas=False),
                            jax_mesh(4)).run_block(js0, jnp.asarray(data),
                                                   nsteps)
    ts, h = sfast.run_block_start(ts0, block, nsteps)
    to = sfast.run_block_collect(h)
    assert to.ip.shape == jo.ip.shape
    ts1, to1 = fast.run_block(ts0, block, nsteps)
    _same_outputs(to, to1)
    _same_states(ts, ts1)
    _cross(jo, to)

    ca = 5
    ja, ta = _acquirers(list(range(1, ca + 1)), 3)
    adata = _signal((ja.intg + 2) * ja.nsamp)
    ru = ta.search(adata)
    rj = JaxShardedAcquirer(ja, jax_mesh(8)).search(adata)
    sacq = ShardedAcquirer(ta, _cpu(8))
    assert sacq.mode == "freq"
    sacq_ch = ShardedAcquirer(ta, _cpu(8), mode="ch")
    assert [b - a for a, b, _ in sacq_ch.shards] == [1] * 5
    for rb in (sacq.search(adata), sacq_ch.search(adata)):
        _same_acq(rb, ru)
        _jax_acq_tol(rj, rb)


# ---------------------------------------------------------------------- #
def _capture(path, prns, seconds):
    """The JAX test's receiver capture: ``prns`` with LNAV frames after 6
    s of padding bits, 46 dB-Hz, int8 at 4.092 Msps."""
    f_sf, f_if = 4.092e6, 1.023e6
    chans = []
    for p in prns:
        eph = sim.example_eph(prn=p, week=2200, toe_tow=352800.0)
        frames = sim.lnav_bit_stream(eph, 352806.0, nframes=2)
        pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
        chans.append(sim.SimChannel(
            prn=p, doppler=300.0 * p - 1500.0, code_phase=40.0 * p,
            nav_bits=np.concatenate([pad, frames])))
    noise = sim.noise_std_for_cn0(1.0, 46.0, f_sf, DType.REAL)
    n = int(seconds * f_sf)
    with open(path, "wb") as f:
        step = int(f_sf)
        for t0 in range(0, n, step):
            x = sim.synthesize(chans, f_sf, f_if, DType.REAL,
                               min(step, n - t0), noise_std=noise,
                               seed=77 + t0, t0=t0)
            sim.quantize_int8(x, 16.0).tofile(f)


def test_receiver_over_mesh_matches_single(tmp_path):
    """The port's Receiver with ``mesh=`` (4 CPU shards): its events and
    epochs equal the JAX mesh receiver's (``make_mesh(4)``), and, bit for
    bit, the port's unsharded receiver with ``pipeline_acq=False`` (a mesh
    decides its searches at once, as the JAX mesh receiver does)."""
    from gnsslib_tpu.io.frontend import FileFrontend as JaxFileFrontend
    from gnsslib_tpu.io.frontend import FrontendSpec as JaxFrontendSpec
    from gnsslib_tpu.runtime.config import ChannelConfig as JaxChannelConfig
    from gnsslib_tpu.runtime.config import ReceiverConfig as JaxReceiverConfig
    from gnsslib_tpu.runtime.receiver import Receiver as JaxReceiver
    from gnsslib_tpu_torch.io.frontend import FileFrontend, FrontendSpec
    from gnsslib_tpu_torch.runtime.config import (ChannelConfig,
                                                  ReceiverConfig)
    from gnsslib_tpu_torch.runtime.receiver import Receiver

    f_sf, f_if = 4.092e6, 1.023e6
    prns = [2, 5, 9, 12]
    path = str(tmp_path / "m.bin")
    _capture(path, prns, 9.0)

    def jax_run(out):
        spec = JaxFrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9,
                               f_sf=f_sf, f_if=f_if, dtype=DType.REAL)
        cfg = JaxReceiverConfig(
            channels=[JaxChannelConfig(prn=p) for p in prns], fends=[spec],
            files=[path], track=JaxTrackConfig(corrn=4, corrd=2, corrp=2),
            outms=400, rinex=False)
        rx = JaxReceiver(cfg, JaxFileFrontend(path, spec),
                         mesh=jax_mesh(4), pipeline_acq=False)
        rx.run_seconds()
        out.append(rx)

    def mk(mesh):
        spec = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9,
                            f_sf=f_sf, f_if=f_if, dtype=DType.REAL)
        cfg = ReceiverConfig(
            channels=[ChannelConfig(prn=p) for p in prns], fends=[spec],
            files=[path], track=TrackConfig(corrn=4, corrd=2, corrp=2),
            outms=400, rinex=False)
        return Receiver(cfg, FileFrontend(path, spec), device="cpu",
                        mesh=mesh, pipeline_acq=False)

    jout = []
    th = threading.Thread(target=jax_run, args=(jout,))
    th.start()
    try:
        rx_m = mk(_cpu(4))
        assert rx_m.pipeline_acq is False
        assert len(rx_m._slow_eng.shards) == 4
        rx_s = mk(None)
        rx_m.run_seconds()
        rx_s.run_seconds()
    finally:
        th.join()
    rx_j = jout[0]
    assert rx_m.events == rx_s.events
    assert rx_m.epochs_written == rx_s.epochs_written
    assert [e[:3] for e in rx_m.events] == [e[:3] for e in rx_j.events]
    assert rx_m.epochs_written == rx_j.epochs_written
    assert sorted(ch.cfg.prn for ch in rx_m.channels if ch.locked) == prns
    # every shard ran its own block programs
    assert all(e.programs for _, _, e in rx_m._slow_eng.shards)
    assert all(e.programs for _, _, e in rx_m._fast_eng.shards)


def _mixed_capture(path):
    """GPS PRN 7 (LNAV) and SBAS PRN 129 (type 12 time messages), 14 s at
    4.092 Msps, 47 dB-Hz, int8."""
    from gnsslib_tpu.nav.sbas import encode_sbas_message
    from gnsslib_tpu.nav.viterbi import conv27_encode

    f_sf, f_if = 4.092e6, 1.023e6
    towref, secs = 352818.0, 14.0
    eph = sim.example_eph(prn=7, week=2200, toe_tow=towref)
    frames = sim.lnav_bit_stream(eph, towref + 6.0, nframes=3)
    pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
    gps = sim.SimChannel(prn=7, doppler=700.0, code_phase=-50.0,
                         carr_phase=0.4,
                         nav_bits=np.concatenate([pad, frames]))
    preambles = [0x53, 0x9A, 0xC6]
    rng = np.random.default_rng(12)
    msgs = []
    for k in range(int(secs) + 2):
        if k % 3 == 0:
            payload = np.zeros(212, np.int64)
            tow_field = int(towref) + k + 2
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
    sbas_syms = np.where(conv27_encode(bits01) == 0, 1, -1).astype(np.int8)
    sbas = sim.SimChannel(prn=129, ctype=CodeType.L1SBAS, doppler=-900.0,
                          code_phase=-170.0, carr_phase=0.9, nav_ms=2.0,
                          nav_bits=sbas_syms)
    noise = sim.noise_std_for_cn0(1.0, 47.0, f_sf, DType.REAL)
    n = int(secs * f_sf)
    with open(path, "wb") as f:
        for t0 in range(0, n, int(f_sf)):
            x = sim.synthesize([gps, sbas], f_sf, f_if, DType.REAL,
                               min(int(f_sf), n - t0), noise_std=noise,
                               seed=7000 + t0, t0=t0)
            sim.quantize_int8(x, 16.0).tofile(f)


# the GPS + SBAS receiver of ``_mixed_capture`` through build_receiver,
# in one process over 4 CPU shards ("single") or as process PID of two
# over a global mesh of 2 x 2 CPU shards; writes its events, epochs,
# locks, decodes and local shards per group as JSON
MIXED_RECEIVER = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(2)
    from gnsslib_tpu_torch.constants import CodeType, DType, FrontendType
    from gnsslib_tpu_torch.io.frontend import FileFrontend, FrontendSpec
    from gnsslib_tpu_torch.parallel import Mesh
    from gnsslib_tpu_torch.parallel import distributed as dd
    from gnsslib_tpu_torch.runtime.config import (ChannelConfig,
                                                  ReceiverConfig)
    from gnsslib_tpu_torch.runtime.receiver import build_receiver
    from gnsslib_tpu_torch.track import TrackConfig

    def mixed(path, mesh):
        spec = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9,
                            f_sf=4.092e6, f_if=1.023e6, dtype=DType.REAL)
        cfg = ReceiverConfig(
            channels=[ChannelConfig(prn=7),
                      ChannelConfig(prn=129, sys=2, ctype=CodeType.L1SBAS)],
            fends=[spec], files=[path],
            track=TrackConfig(corrn=4, corrd=2, corrp=2),
            outms=400, rinex=False)
        return build_receiver(cfg, FileFrontend(path, spec), device="cpu",
                              mesh=mesh)

    if __name__ == "__main__":
        path, out, who = sys.argv[1:4]
        if who == "single":
            mesh = Mesh(["cpu"] * 4)
        else:
            dd.init_distributed(sys.argv[4], 2, int(who), timeout_s=60)
            mesh = dd.global_mesh(per_process=2, device="cpu")
        rx = mixed(path, mesh)
        shards = [len(r._fast_eng.shards) for r in rx.rx]
        rx.run_seconds()
        rx.close()
        json.dump(dict(
            events=[list(e) for e in rx.events], epochs=rx.epochs_written,
            locked=sorted(ch.cfg.prn for ch in rx.channels if ch.locked),
            decoded=sorted(ch.cfg.prn for ch in rx.channels
                           if ch.nav.flagdec),
            shards=shards), open(out, "w"))
        dd.shutdown()
""")


def test_mixed_cadence_receiver_over_mesh(tmp_path):
    """GPS (1 ms loop) + SBAS (2 ms loop) through ``build_receiver`` with a
    mesh of 4 CPU shards: two cadence groups of one channel each (three
    shards of each group left without a channel); both groups lock,
    decode and merge into common epochs."""
    path = tmp_path / "mix.bin"
    _mixed_capture(path)
    ns = {"__name__": "mixed_receiver"}
    exec(MIXED_RECEIVER, ns)               # its receiver, in this process
    rx = ns["mixed"](str(path), _cpu(4))
    assert len(rx.rx) == 2                 # two cadence groups
    assert all(len(r._fast_eng.shards) == 1 and r.mesh.size == 4
               for r in rx.rx)
    rx.run_seconds()
    rx.close()
    locked = sorted(ch.cfg.prn for ch in rx.channels if ch.locked)
    assert locked == [7, 129]
    decoded = {ch.cfg.prn for ch in rx.channels if ch.nav.flagdec}
    assert decoded == {7, 129}
    assert rx.epochs_written > 0


def test_mixed_cadence_receiver_two_processes(tmp_path):
    """The GPS + SBAS receiver over a global mesh of 2 processes x 2 CPU
    shards (gloo): each cadence group has one channel, so process 1 runs
    no shard of either group and gives zero channels to every all-gather.
    Both processes' events, epochs, locks and decodes equal the
    single-process receiver's over 4 shards."""
    from gnsslib_tpu_torch.tools import free_port
    path = tmp_path / "mix.bin"
    _mixed_capture(path)
    script = tmp_path / "mixed.py"
    script.write_text(MIXED_RECEIVER)
    coord = f"127.0.0.1:{free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    who = ["single", "0", "1"]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(path), str(tmp_path / f"{w}.json"),
         w, coord], cwd=root, env=env, stdout=subprocess.DEVNULL,
        stderr=open(tmp_path / f"{w}.err", "w")) for w in who]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    assert rcs == [0, 0, 0], [(tmp_path / f"{w}.err").read_text()[-2000:]
                              for w in who]
    single, r0, r1 = [json.load(open(tmp_path / f"{w}.json")) for w in who]
    assert single["shards"] == [1, 1]
    assert r0["shards"] == [1, 1] and r1["shards"] == [0, 0]
    assert single["locked"] == single["decoded"] == [7, 129]
    assert single["epochs"] > 0
    for r in (r0, r1):
        assert r["events"] == single["events"]
        assert r["epochs"] == single["epochs"]
        assert r["locked"] == single["locked"]
        assert r["decoded"] == single["decoded"]
