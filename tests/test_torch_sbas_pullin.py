"""A satellite acquired a Doppler bin too far from its carrier still
frames (the port's carrier loop, ``gnsslib_tpu_torch/track/loop.py``).

The search's 200 Hz grid now and then decides the bin ~240 Hz off.  With
the PLL on from a channel's start, as in the reference, such a channel
stays near the 250 Hz edge of the 1 ms FLL until bit sync sets its loop's
cadence (2 periods for SBAS, 10 for GPS), which then locks a Costas
ambiguity off the carrier (250 or 50 Hz): bit-synced, never a frame.  The
port lets the FLL pull in alone first (``FLL_PULLIN``).  Here the sky of
seed 3000000403 of ``rxbench/traffic/sbas_long.json`` (SBAS PRN 133 at
-161.4 Hz, GPS PRN 3 and 7 of the same sky) runs through
``build_receiver`` at 4.092 Msps with PRN 133's and PRN 3's decisions
planted 240 Hz off, as the card's search made PRN 133's in that capture.
The NovAtel stream must carry every SBAS message due, bit for bit,
against what ``rxbench.sky`` sent, and the GPS subframes and pseudoranges
must pass ``rxbench.truth``'s judges."""
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from gnsslib_tpu_torch.runtime.config import load_ini
from gnsslib_tpu_torch.runtime.receiver import build_receiver
from gnsslib_tpu_torch.track import loop
from rxbench import sky, truth
from rxbench.frontend import MemoryFrontend

torch.set_num_threads(2)

F_SF, F_IF = 4.092e6, 1.023e6
SECONDS = 18.0              # GPS subframe 1 (the week) ends at 12 s
SEED = 3000000403           # the sky of the card run that missed PRN 133
PRNS = (3, 7, 133)
PLANTED = (3, 133)          # the decisions planted PLANTED_HZ off
PLANTED_HZ = 240.0          # the SBAS decision's error in that run: 239 Hz
FIRST_DUE_S = 7.0           # bit sync ~2.8 s, the preamble pair ~3 s more


@pytest.fixture(scope="module")
def capture():
    path = os.path.join(os.path.dirname(sky.__file__), "traffic",
                        "sbas_long.json")
    with open(path) as f:
        mix = json.load(f)
    sk = sky.draw_sky(mix, np.random.default_rng([SEED, 0]), mix["seconds"])
    sk.signals = [s for s in sk.signals if s.prn in PRNS]
    data = sky.synthesize(sk, F_SF, F_IF, int(SECONDS * F_SF),
                          device="cpu", noise_seed=21).numpy()
    return sk, data


def _ini(tmp_path) -> str:
    (tmp_path / "fend.ini").write_text(f"""[FEND]
TYPE     =FILE
CF1      =1575.42e6
SF1      ={F_SF}
IF1      ={F_IF}
DTYPE1   =1
FILE1    =unused.bin
[TRACK]
CORRN    =2
CORRD    =2
CORRP    =2
""")
    ini = tmp_path / "rx.ini"
    ini.write_text(f"""[RCV]
FENDCONF ={tmp_path / "fend.ini"}
[CHANNEL]
NCH      =3
PRN      =3,7,133
SYS      =1,1,2
CTYPE    =1,1,27
FTYPE    =1,1,1
[OUTPUT]
OUTMS    =400
RINEX    =1
RINEXPATH ={tmp_path}
SBAS     =1
SBASPORT =0
""")
    return str(ini)


def _sig(sk, prn: int):
    return sk.by_prn("sbas" if prn >= sky.SBAS_FIRST else "gps", prn)


def run_planted(ini: str, sk, data, planted_hz: float) -> dict:
    """The receiver of ``ini`` over ``data`` with the search decisions of
    the PRNs in PLANTED moved ``planted_hz`` from their true Dopplers
    (through the receiver's search override point; the search itself
    runs): the SBAS bytes it sent, the job record ``rxbench.truth``
    judges, and the receiver."""
    cfg = load_ini(ini)
    outdir = pathlib.Path(cfg.rinexpath)
    rx = build_receiver(cfg, {1: MemoryFrontend(data, cfg.fends[0])},
                        device="cpu")
    for g in rx.rx:
        def search(g=g, real=g._acq_dispatch):
            res = real()
            for i, ch in enumerate(g.channels):
                if ch.cfg.prn in PLANTED:
                    res.dcarr[i] = -_sig(sk, ch.cfg.prn).doppler + planted_hz
            return res
        g._acq_search = search
    sent = bytearray()
    send = rx.hub.sbas_srv.send

    def keep(b):
        sent.extend(b)
        send(b)
    rx.hub.sbas_srv.send = keep
    ends = [g.end_sample() for g in rx.rx]
    while all(g.can_step(e) for g, e in zip(rx.rx, ends)):
        rx.step_block()
    rx.flush()
    rx.close()
    rinex = {key: "".join(p.read_text() for p in outdir.glob(pat))
             for key, pat in (("rinex_obs", "*.obs"), ("rinex_nav", "*.nav"))}
    job = dict(events=list(rx.events), sbas_bytes=bytes(sent),
               seconds=SECONDS, outms=cfg.outms, **rinex)
    return dict(sbas=bytes(sent), job=job, rx=rx)


def test_sbas_acquired_240_hz_off_frames(capture, tmp_path):
    sk, data = capture
    out = run_planted(_ini(tmp_path), sk, data, PLANTED_HZ)
    for ch in out["rx"].channels:
        true_dcarr = -_sig(sk, ch.cfg.prn).doppler
        if ch.cfg.prn in PLANTED:
            assert ch.acq_dcarr == pytest.approx(true_dcarr + PLANTED_HZ)
        # locked on the carrier, not a Costas ambiguity (250, 50 Hz) off it
        assert abs(ch.dcarr_live - true_dcarr) < 20.0, ch.cfg.prn
        assert ch.nav.flagsync and ch.nav.flagsyncf, ch.cfg.prn
    # GPS: each decoded subframe's ID and time of week, subframe 1 (6-12
    # s, the week) on both PRNs, and every epoch's pseudoranges
    job = out["job"]
    assert truth.judge_nav(job, sk) == (0, 0)
    sf1 = {(ev[2], int(ev[3])) for ev in job["events"]
           if ev[0] == "nav:decode" and ev[2] < sky.SBAS_FIRST
           and float(ev[4]) - 6.0 - sky.TOW0 == sky.LNAV_PAD}
    assert sf1 == {(3, 1), (7, 1)}
    with open(os.path.join(os.path.dirname(sky.__file__), "limits",
                           "sbas35.long.json")) as f:
        limits = json.load(f)
    obs_miss, pr_err = truth.judge_obs(job, sk)
    assert obs_miss <= limits["obs_miss"]
    assert 0.0 < pr_err <= limits["pr_err_m"]
    ch = next(c for c in out["rx"].channels if c.cfg.prn == 133)
    frames = truth.parse_novatel_sbas(out["sbas"])
    sig = sk.by_prn("sbas", 133)
    sent = {bytes(np.packbits(m[:232].astype(np.uint8)))
            for m in sig.messages}
    assert frames and all(p in sent for p, _, _ in frames)
    got = {p for p, _, _ in frames}
    # message k is sent over [TOW0 + k, TOW0 + k + 1) and framed once its
    # successor's preamble is in, by TOW0 + k + 2
    due = [bytes(np.packbits(m[:232].astype(np.uint8)))
           for k, m in enumerate(sig.messages, -int(sky.LEAD))
           if FIRST_DUE_S <= k + 2 <= SECONDS - truth.LATENCY_S]
    assert len(due) >= 3
    assert all(p in got for p in due)
    group = next(g for g in out["rx"].rx if ch in g.channels)
    assert group.spans.counters["sbas.frames"] == len(frames)


@pytest.mark.parametrize("step_deg", [-85.0, -30.0, 5.0, 60.0, 85.0])
@pytest.mark.parametrize("phase_deg", [-80.0, 0.0, 70.0, 88.0])
def test_fll_reads_the_reference_step(step_deg, phase_deg):
    """Two accumulations ``step`` apart, the first at ``phase``: the FLL
    reads the step where atan does not wrap between the two, and minus the
    step where it does (the reference's reflection, pi - x), with
    probability |step|/pi over phases: its pull fades toward 250 Hz at one
    code period, which is why the FLL pulls in without the PLL."""
    def at(deg):
        a = np.deg2rad(deg)
        return torch.tensor([np.cos(a)]), torch.tensor([np.sin(a)])
    i0, q0 = at(phase_deg)
    i1, q1 = at(phase_deg + step_deg)
    taps = lambda x: x[:, None].repeat(1, 5)
    _, freq_err, _ = loop.discriminators(taps(i1), taps(q1), taps(i0),
                                         taps(q0), 1, 2)
    wraps = abs(((phase_deg + step_deg + 90.0) // 180.0)
                - ((phase_deg + 90.0) // 180.0)) > 0
    want = -step_deg if wraps else step_deg
    assert float(freq_err[0]) == pytest.approx(np.deg2rad(want), abs=1e-5)


def test_fll_alone_before_the_pll_joins():
    """The per-period loop's coefficient rows: the first FLL_PULLIN
    periods after a start carry no PLL gain, then prm1, and prm2 after bit
    sync; the FLL and DLL gains are prm1's throughout pull-in."""
    from gnsslib_tpu_torch.track.state import TrackConfig
    cfg = TrackConfig(corrn=2, corrd=2, corrp=2)
    trk = loop.Tracker(cfg, [133], [27], F_SF, F_IF, 1, device="cpu")
    p1, p2 = cfg.prm1, cfg.prm2
    rows = trk._prm.tolist()
    assert rows[0] == pytest.approx([0.0, 0.0, p1.fllw, p1.dllaw, p1.dllw2])
    assert rows[1] == pytest.approx([p1.pllaw, p1.pllw2, p1.fllw, p1.dllaw,
                                     p1.dllw2])
    assert rows[2] == pytest.approx([p2.pllaw, p2.pllw2, p2.fllw, p2.dllaw,
                                     p2.dllw2])
    assert 0 < loop.FLL_PULLIN < 2000     # within the bit-sync wait
