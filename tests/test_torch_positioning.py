"""The port's positioning receiver against the JAX receiver on one
geometry-consistent capture: 6 satellites above 15 degrees for a known
receiver position, 27 s at 4.096 Msps (``test_receiver_spp.py``'s
construction).  Both receivers run once with SPP, a 20-epoch Hatch
smoother, RAIM, RTCM to a TCP client and the hot start; one satellite's
FFT acquisition is suppressed in both and its ephemeris supplied as
assistance, so it joins by the hot start once fixes exist."""
import copy
import os
import socket
import time

import numpy as np
import pytest
import torch

import jax

from gnsslib_tpu import sim
from gnsslib_tpu.constants import DType, FrontendType, PTIMING, SYS_GPS
from gnsslib_tpu.io.frontend import FileFrontend as JFileFrontend
from gnsslib_tpu.io.frontend import FrontendSpec as JFrontendSpec
from gnsslib_tpu.runtime.config import ChannelConfig as JChannelConfig
from gnsslib_tpu.runtime.config import ReceiverConfig as JReceiverConfig
from gnsslib_tpu.runtime.receiver import Receiver as JReceiver
from gnsslib_tpu.track.state import TrackConfig as JTrackConfig
from gnsslib_tpu_torch.io.frontend import FileFrontend, FrontendSpec
from gnsslib_tpu_torch.nav.bits import crc24q
from gnsslib_tpu_torch.runtime.config import ChannelConfig, ReceiverConfig
from gnsslib_tpu_torch.runtime.receiver import Receiver
from gnsslib_tpu_torch.track.state import TrackConfig

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

F_SF = 4.096e6          # not chip-commensurate (see test_receiver_spp.py)
F_IF = 1.023e6
WEEK, TOW0 = 2200, 352800.0
T_OBS = 25.0
SECONDS = 27.0
RCV = np.array([-3954844.0, 3354936.0, 3700264.0])


def candidates():
    cands, k = [], 0
    for omg0 in (-0.9, -0.55, -0.2, 0.15, 0.5, 0.85):
        for m0 in (-0.6, 0.0, 0.6):
            k += 1
            cands.append(sim.example_eph(prn=k, week=WEEK, toe_tow=TOW0,
                                         m0=m0, omg0=omg0))
    return cands


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_spp")
    cands = candidates()
    geo = sim.geometry_scenario(cands, RCV, TOW0 + T_OBS, TOW0,
                                min_elev_deg=15.0)[:6]
    assert len(geo) == 6
    by_prn = {e.prn: e for e in cands}
    pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
    chans = [sim.SimChannel(
        prn=g["prn"], doppler=g["doppler"], code_phase=g["code_phase"],
        carr_phase=0.11 * g["prn"],
        nav_bits=np.concatenate([pad, sim.lnav_bit_stream(
            by_prn[g["prn"]], TOW0 + 6.0, nframes=4)])) for g in geo]
    noise = sim.noise_std_for_cn0(1.0, 46.0, F_SF, DType.REAL)
    path = tmp / "const.bin"
    n = int(SECONDS * F_SF)
    with open(path, "wb") as f:
        for t0 in range(0, n, int(F_SF)):
            x = sim.synthesize(chans, F_SF, F_IF, DType.REAL,
                               min(int(F_SF), n - t0), noise_std=noise,
                               seed=500 + t0, t0=t0)
            sim.quantize_int8(x, 16.0).tofile(f)
    return tmp, str(path), geo, by_prn


def _read_frames(client) -> list:
    """Every RTCM3 frame the server sent, CRC-checked: [(type, bytes)]."""
    client.settimeout(1.0)
    buf = b""
    while True:
        try:
            chunk = client.recv(65536)
        except socket.timeout:
            break
        if not chunk:
            break
        buf += chunk
    frames, pos = [], 0
    while pos < len(buf):
        assert buf[pos] == 0xD3, f"no RTCM3 preamble at byte {pos}"
        n = ((buf[pos + 1] & 0x03) << 8) | buf[pos + 2]
        msg = buf[pos:pos + 3 + n + 3]
        assert len(msg) == n + 6, "truncated frame"
        assert crc24q(msg[:3 + n]) == int.from_bytes(msg[3 + n:], "big")
        frames.append(((msg[3] << 4) | (msg[4] >> 4), msg))
        pos += n + 6
    return frames


def _run(rx, blocked_idx, assist):
    """Suppress ``blocked_idx``'s FFT acquisitions, supply its ephemeris,
    record emitted epochs, read the RTCM stream; run the whole file."""
    orig_post = rx.acq.postprocess

    def suppress(*a):
        res = orig_post(*a)
        res.acquired[blocked_idx] = False
        return res
    rx.acq.postprocess = suppress
    rx.hub.ephs[(SYS_GPS, assist.prn)] = copy.deepcopy(assist.eph)
    epochs = []
    emit = rx.hub.emit_epochs

    def record(inputs):
        out = emit(inputs)
        epochs.extend(out)
        return out
    rx.hub.emit_epochs = record
    srv = rx.hub.rtcm_srv
    client = socket.create_connection(("127.0.0.1", srv.port))
    for _ in range(500):
        if srv.nclients:
            break
        time.sleep(0.01)
    assert srv.nclients == 1
    rx.run_seconds()
    rx.close()
    srv.close()                       # the JAX hub leaves its server open
    frames = _read_frames(client)
    client.close()
    return epochs, frames


@pytest.fixture(scope="module")
def both(capture):
    tmp, path, geo, by_prn = capture
    prns = [g["prn"] for g in geo]
    blocked = prns[-1]
    out = {}
    for tag, (RC, CC, TC, FS, FF, RX, kw) in {
        "jax": (JReceiverConfig, JChannelConfig, JTrackConfig, JFrontendSpec,
                JFileFrontend, JReceiver, {}),
        "torch": (ReceiverConfig, ChannelConfig, TrackConfig, FrontendSpec,
                  FileFrontend, Receiver, {"device": "cpu"}),
    }.items():
        spec = FS(fend=FrontendType.FILE, f_cf=1.57542e9, f_sf=F_SF,
                  f_if=F_IF, dtype=DType.REAL)
        cfg = RC(channels=[CC(prn=p) for p in prns], fends=[spec],
                 files=[path],
                 track=TC(corrn=4, corrd=2, corrp=2, interp_replica=True),
                 outms=400, rinex=True, rinexpath=str(tmp / tag), spp=True,
                 smooth=20, raim=10.0, hotstart=True, rtcm=True, rtcmport=0)
        rx = RX(cfg, FF(path, spec), **kw)
        epochs, frames = _run(rx, prns.index(blocked), by_prn[blocked])
        out[tag] = (rx, epochs, frames)
    return out, blocked, geo


def test_events_and_epochs_match_jax(both):
    """The same acquisitions, hot start, nav events and epochs;
    pseudoranges within 1 m."""
    (jrx, jep, _), (trx, tep, _) = both[0]["jax"], both[0]["torch"]
    for kind in ("acq", "hot"):
        assert [e[:3] for e in trx.events if e[0] == kind] == \
            [e[:3] for e in jrx.events if e[0] == kind], kind
    nav_j = [e for e in jrx.events if e[0].startswith("nav:")]
    assert [e for e in trx.events if e[0].startswith("nav:")] == nav_j
    assert len(tep) == len(jep) == trx.epochs_written >= 3
    for oj, ot in zip(jep, tep):
        assert ot[0].tow == oj[0].tow
        assert [o.prn for o in ot] == [o.prn for o in oj]
        for a, b in zip(oj, ot):
            assert b.P == pytest.approx(a.P, abs=1.0)


def test_fixes_match_jax_and_truth(both):
    """Every fix within 2 m of the JAX fix at the same TOW and within
    30 m of the true position (test_receiver_spp.py's bound)."""
    (jrx, _, _), (trx, _, _) = both[0]["jax"], both[0]["torch"]
    fj = {round(f[1], 3): f for f in jrx.hub.positions}
    ft = {round(f[1], 3): f for f in trx.hub.positions}
    assert len(ft) >= 3 and sorted(ft) == sorted(fj)
    for tow, (_, _, pos, clk, nsat) in ft.items():
        assert nsat == fj[tow][4]
        assert float(np.linalg.norm(pos - fj[tow][2])) < 2.0, tow
        assert float(np.linalg.norm(pos - RCV)) < 30.0, tow
    anchor = TOW0 + T_OBS + PTIMING / 1000.0
    assert min(abs(t - anchor) for t in ft) < 1.0


def test_pos_file_columns_match_jax(both):
    """The .pos file shares the RINEX stamp, carries the JAX header and
    one line per fix in the same columns."""
    paths = {}
    for tag in ("jax", "torch"):
        rx = both[0][tag][0]
        d = os.path.dirname(rx.obs_writer.path)
        pos = [f for f in os.listdir(d) if f.endswith(".pos")]
        assert len(pos) == 1
        assert pos[0][:-4] == os.path.basename(rx.obs_writer.path)[:-4]
        paths[tag] = os.path.join(d, pos[0])
    lines = {t: open(p).read().splitlines() for t, p in paths.items()}
    head = {t: [ln for ln in v if ln.startswith("%")]
            for t, v in lines.items()}
    assert head["torch"] == head["jax"]
    rows = {t: [ln.split() for ln in v if not ln.startswith("%")]
            for t, v in lines.items()}
    assert len(rows["torch"]) == len(rows["jax"]) == len(
        both[0]["torch"][0].hub.positions)
    for a, b in zip(rows["jax"], rows["torch"]):
        assert len(a) == len(b) == 12
        assert b[:2] == a[:2] and b[6] == a[6]          # week, tow, nsat
        assert abs(float(b[7]) - float(a[7])) < 1e-4    # lat (deg)


def test_rtcm_stream_matches_jax(both):
    """The client receives CRC-valid frames: 1019 byte-identical to the
    JAX receiver's, and as many MSM7 (1077) frames."""
    fj, ft = both[0]["jax"][2], both[0]["torch"][2]
    types = {t for t, _ in ft}
    assert {1019, 1077} <= types
    assert [m for t, m in ft if t == 1019] == [m for t, m in fj if t == 1019]
    assert sum(t == 1077 for t, _ in ft) == sum(t == 1077 for t, _ in fj) \
        == both[0]["torch"][0].epochs_written


def test_hotstart_handoff_matches_jax(both):
    """The suppressed satellite starts by the hot start: the predicted
    code-boundary sample within 1 sample and the Doppler within 0.1 Hz of
    the JAX receiver's prediction, and within pull-in range of the
    truth."""
    out, blocked, geo = both
    hot = {t: [e for e in out[t][0].events if e[0] == "hot"]
           for t in ("jax", "torch")}
    assert len(hot["torch"]) == len(hot["jax"]) == 1
    (_, tj, pj, dj, lj), (_, tt, pt, dt, lt) = hot["jax"][0], hot["torch"][0]
    assert pt == pj == blocked and tt == tj
    assert abs(lt - lj) <= 1 and abs(dt - dj) <= 0.1
    g = next(x for x in geo if x["prn"] == blocked)
    assert abs(-dt - g["doppler"]) < 5.0
    t0 = (int(round(tt * F_SF)) + lt) / F_SF
    chips = (g["code_phase"] + 1.023e6 * (1.0 - g["doppler"] / 1.57542e9)
             * t0) % 1023.0
    assert min(chips, 1023.0 - chips) * F_SF / 1.023e6 < 3.0
    assert next(c for c in out["torch"][0].channels
                if c.cfg.prn == blocked).locked

