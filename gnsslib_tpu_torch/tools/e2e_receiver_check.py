"""End-to-end check of the port: IF synthesis -> acquisition -> tracking
-> nav decode, through the public API as a receiver drives it (port of
the JAX package's ``tools/e2e_receiver_check.py``).

    python -m gnsslib_tpu_torch.tools.e2e_receiver_check [--device cuda|cpu]

One GPS L1CA satellite (PRN 17, +1234 Hz, 45 dB-Hz) with real LNAV
frames at 4.092 Msps: ``Acquirer.search`` on the first 12 ms, then
950-period ``Tracker.run_block`` blocks synthesized on the host (on a
card each block is one replay of the program captured at the block's
shape: one capture for the run), the ``NavChannel`` framer fed from each
block's prompt values, bit sync handed back to the tracker.  The run
stops once three subframes of ephemeris are decoded, checks acquisition,
bit sync, TOW, decode, the ephemeris against the truth and the tracked
Doppler, and prints ``E2E PASS``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import no_card

F_SF = 4.092e6
F_IF = 1.023e6
NSAMP = 4092
PRN = 17
DOPPLER = 1234.0
CODEI_TRUE = 2345
SECONDS = 55.0
TOW_START = 352800.0
NSTEPS = 950


class E2EFailure(RuntimeError):
    """A check of the end-to-end run failed."""


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise E2EFailure(what)


def track(seconds: float = SECONDS, *, device="cuda") -> dict:
    """Acquire, then track and decode up to ``seconds`` of signal (or until
    three subframes of ephemeris are decoded); prints the nav events.
    Returns the acquisition result, the events as (kind, cnt, sfid, tow,
    week) tuples, the framer, the truth, the last block's outputs and the
    run's counts."""
    import torch
    from .. import sim
    from ..acquire import Acquirer
    from ..constants import CodeType, DType
    from ..nav import NavChannel
    from ..track import TrackConfig, Tracker
    from ..track.program import CAPTURES

    eph = sim.example_eph(prn=PRN, week=2200)
    bits = sim.lnav_bit_stream(eph, TOW_START, nframes=8)   # 8 x 30 s
    print(f"nav bit stream: {len(bits)} bits")
    ch = sim.SimChannel(prn=PRN, doppler=DOPPLER,
                        code_phase=-CODEI_TRUE * 1.023e6 / F_SF,
                        carr_phase=0.37, nav_bits=bits)
    noise = sim.noise_std_for_cn0(1.0, 45.0, F_SF, DType.REAL)

    # --- acquisition on the first 12 ms ----------------------------------
    acq = Acquirer([PRN], [CodeType.L1CA], F_SF, F_IF, DType.REAL,
                   device=device)
    head = sim.synthesize([ch], F_SF, F_IF, DType.REAL, 12 * NSAMP,
                          noise_std=noise, seed=1)
    t0 = time.time()
    res = acq.search(np.asarray(head, np.float32))
    print(f"acq: acquired={res.acquired[0]} codei={res.codei[0]} "
          f"dcarr={res.dcarr[0]:+.0f} Hz cn0={res.cn0[0]:.1f} dB-Hz "
          f"peakr={res.peakr[0]:.2f}  ({time.time() - t0:.1f}s)")
    _check(bool(res.acquired[0]), "acquisition failed")

    # --- tracking + nav, block-streamed ----------------------------------
    cfg = TrackConfig(corrn=4, corrd=2, corrp=2)
    trk = Tracker(cfg, [PRN], [CodeType.L1CA], F_SF, F_IF, DType.REAL,
                  device=device)
    st = trk.init_state()
    st = trk.start_channels(st, [0], [int(res.codei[0])],
                            [float(res.dcarr[0])])
    nav = NavChannel(CodeType.L1CA, prn=PRN, ref_week=2200)
    margin = trk.nwin + 8 * NSTEPS + 16
    block_len = NSTEPS * NSAMP + margin
    base = 0                       # absolute sample index of block start
    total_steps = int(seconds * 1000)
    done = 0
    events = []
    captures = CAPTURES.captures
    t0 = time.time()
    synced = False
    out = None
    while done < total_steps:
        data = sim.synthesize([ch], F_SF, F_IF, DType.REAL, block_len,
                              noise_std=noise, seed=100 + done, t0=base)
        block = torch.from_numpy(np.asarray(data, np.float32)).to(trk.device)
        cnt0 = int(st.cnt[0])
        st, out = trk.run_block(st, block, NSTEPS)
        for e in nav.update(out.ip[:, 0],
                            base + out.loc[:, 0].astype(np.int64), cnt0):
            events.append((e.kind, e.cnt, e.sfid, e.tow, e.week))
            print(f"  [t={done / 1000.0:5.1f}s] nav event: {e.kind} "
                  f"cnt={e.cnt} sfid={e.sfid} tow={e.tow} week={e.week}")
        if nav.flagsync and not synced:
            st = trk.set_bit_sync(st, 0, nav.sync_offset)
            synced = True
            print(f"  bit sync at offset {nav.sync_offset}; switching to "
                  "prm2")
        advance = NSTEPS * NSAMP
        st = trk.rebase(st, advance)
        base += advance
        done += NSTEPS
        if nav.eph.cnt >= 3 and nav.flagdec:
            break
    dt = time.time() - t0
    print(f"tracked {done / 1000.0:.1f} s of signal in {dt:.1f} s "
          f"({base / 1e6 / dt:.1f} Msamples/s, "
          f"{base / 1e6 / (done / 1000.0):.3f} Msps stream)")
    return dict(acq=res, events=events, nav=nav, truth=eph, out=out,
                done=done, wall=dt, captures=CAPTURES.captures - captures,
                device=trk.device.type)


def run(seconds: float = SECONDS, *, device="cuda") -> dict:
    """:func:`track`, then the checks; raises :class:`E2EFailure` at the
    first that fails, else prints ``E2E PASS``."""
    r = track(seconds, device=device)
    res, nav, eph, out = r["acq"], r["nav"], r["truth"], r["out"]
    err_code = (int(res.codei[0]) - CODEI_TRUE) % NSAMP
    err_code = min(err_code, NSAMP - err_code)
    _check(err_code <= 2, f"code phase error {err_code} samples")
    _check(abs(res.dcarr[0] + DOPPLER) <= 100.0,
           f"acquired Doppler {res.dcarr[0]}")
    _check(nav.flagsync, "no bit sync")
    _check(nav.flagtow, "no preamble/tow")
    _check(nav.flagdec, "no decode")
    print(f"firstsftow={nav.firstsftow} (expect multiple of 6 in frame)")
    e = nav.eph.eph
    print(f"eph: week={e.week} iode={e.iode} iodc={e.iodc} A={e.A:.3f} "
          f"e={e.e:.6f} (truth A={eph.eph.A:.3f})")
    _check(e.iode == eph.eph.iode and e.iodc == eph.eph.iodc
           and abs(e.A - eph.eph.A) < 1e-3 and e.week == 2200,
           "ephemeris mismatch")
    d_end = -np.mean(out.dcarr[-50:, 0])
    print(f"tracked Doppler {d_end:+.2f} Hz (truth {DOPPLER:+.1f})")
    _check(abs(d_end - DOPPLER) < 5.0, f"tracked Doppler {d_end:+.2f} Hz")
    if r["device"] == "cuda":
        print(f"block programs captured: {r['captures']} (one per block "
              "shape)")
        _check(r["captures"] == 1, f"{r['captures']} captures")
    print("E2E PASS", flush=True)
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch.tools.e2e_receiver_check",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    if no_card(a.device, "e2e_receiver_check"):
        return 2
    try:
        run(device=a.device)
    except E2EFailure as e:
        print(f"E2E FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
