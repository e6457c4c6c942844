"""Channel-count scaling of the steady-state tracker on one card: how
many channels one card carries (port of the JAX package's
``tools/scaling_channels.py``).

    python -m gnsslib_tpu_torch.tools.scaling_channels [--device cuda|cpu]

For C = 32, 64, 128 and 256 channels (copies of PRNs 1-32, bit-synced)
one ``FastTracker`` runs 500-step blocks (0.5 s of signal, 50
super-steps of L = 10 periods, C x L windows each) through the band
correlator (K1), each block one replay of the block program
(``FastTracker.program``, a CUDA graph on the card), on random samples at
the 16.368 Msps envelope.  The state advances through one long block
with no rebase: one warm-up block and two per timing repeat.  Per C it
prints ms per super-step by host wall (two blocks queued, then both
collected) and by CUDA events around the same two blocks, the aggregate
channel-samples per second, the K1 launches against the super-steps run
(one launch per super-step), and the program's build (capture) time.
A window past the block's end fails the block's collect (K1's
out-of-band flag), so the block covers every block the state runs.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import no_card

F_SF = 16.368e6
F_IF = 4.092e6
CHANNELS = (32, 64, 128, 256)
NSTEPS = 500                       # 0.5 s of signal per block
CORR = (6, 3, 6)
REPS = 3


def run(channels=CHANNELS, nsteps: int = NSTEPS, *, device="cuda",
        f_sf: float = F_SF, f_if: float = F_IF, corr=CORR,
        reps: int = REPS) -> list:
    """One row (a dict) per channel count."""
    import torch
    from ..constants import CodeType, DType
    from ..ops import kernels
    from ..track import FastTracker, TrackConfig, Tracker
    from ..track.loop import resolve_device
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(0)
    rows = []
    for C in channels:
        prns = [(i % 32) + 1 for i in range(C)]
        trk = Tracker(TrackConfig(*corr), prns, [CodeType.L1CA] * C, f_sf,
                      f_if, DType.REAL, device=dev)
        fast = FastTracker(trk)
        nsamp = trk.n_nom
        nblocks = 1 + 2 * reps
        block_len = (nblocks * nsteps * nsamp + trk.nwin
                     + 8 * nblocks * nsteps + 2 * nsamp + 64)
        block = torch.from_numpy(rng.standard_normal(block_len)
                                 .astype(np.float32)).to(dev)
        st = trk.init_state()
        st = trk.start_channels(st, list(range(C)),
                                [37 * p % nsamp for p in prns],
                                [100.0 * (i % 13) for i in range(C)])
        for c in range(C):
            st = trk.set_bit_sync(st, c, c % 10)
        t0 = time.perf_counter()
        fast.program(nsteps, block.shape)         # built (captured) here
        build_s = time.perf_counter() - t0
        before = kernels.snapshot()
        t0 = time.perf_counter()
        st, h = fast.run_block_start(st, block, nsteps)
        fast.run_block_collect(h)
        first_s = time.perf_counter() - t0
        best = best_ev = float("inf")
        for _ in range(reps):
            if cuda:
                torch.cuda.synchronize(dev)
                ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                ev0.record()
            t0 = time.perf_counter()
            st, h = fast.run_block_start(st, block, nsteps)
            st, h2 = fast.run_block_start(st, block, nsteps)
            if cuda:
                ev1.record()
            fast.run_block_collect(h)
            fast.run_block_collect(h2)
            best = min(best, (time.perf_counter() - t0) / 2)
            if cuda:
                best_ev = min(best_ev, ev0.elapsed_time(ev1) / 2e3)
        k1 = kernels.since(before).get("band_taps", {})
        nsuper = nsteps // fast.L
        rows.append(dict(
            C=C, windows=C * fast.L, nsteps=nsteps, super_steps=nsuper,
            ms_step=best / nsuper * 1e3,
            ms_step_event=(best_ev / nsuper * 1e3 if cuda else None),
            ch_msps=C * nsteps * nsamp / best / 1e6,
            build_s=build_s, first_block_s=first_s,
            k1_launches=sum(k1.values()), expected=nsuper * nblocks,
            device=dev.type))
    return rows


def line(r: dict) -> str:
    ev = (f"{r['ms_step_event']:7.3f} ms by CUDA events"
          if r["ms_step_event"] is not None else "events n/a (CPU)")
    return (f"C={r['C']:4d}  {r['ms_step']:7.3f} ms/super-step wall, {ev}  "
            f"{r['ch_msps']:9.0f} channel-Msps  "
            f"({r['ch_msps'] / (32 * F_SF / 1e6):5.1f}x 32-ch real-time)  "
            f"K1 {r['k1_launches']}/{r['expected']} launches  "
            f"build {r['build_s']:.1f}s [{r['device']}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch.tools.scaling_channels",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    if no_card(a.device, "scaling_channels"):
        return 2
    for r in run(device=a.device):
        print(line(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
