"""Stage-level timing of the steady-state FastTracker super-step, one
correlator backend against another (port of the JAX package's
``tools/profile_fast.py``).

    python -m gnsslib_tpu_torch.tools.profile_fast [--duel N]
        [--device cuda|cpu] [--steps S] [--channels C]

The workload is the 32-channel GPS L1CA steady state: C channels (32 by
default) on 16.368 Msps real int8 IF at a 4.092 MHz IF,
``TrackConfig(6, 3, 6)`` (13 taps), L = 10 code periods per super-step,
S super-steps (50 by default) per timed run.  Per super-step it prints:

  band, pallas, fused, xla  ``run_steps`` through that correlator backend
                            (the eager loop)
  band:graph, ...           the same S super-steps as one replayed block
                            program (``FastTracker.program``: a CUDA graph
                            of the whole block, what the receiver runs)
  band:step, ...            a program of one super-step, its carry kept in
                            place, replayed S times (the other way to
                            capture a block, measured against it)
  nocorr   geometry + loop filter, taps zeroed (the loop's floor)
  gather   geometry + replica rows + window fetch, strided sums
  mater    the same, consumed by full sums
  kconst   K4 (correlate_windows8) on constant windows and rows + filter
  kconst1  K5 (correlate_windows) on the same
  realwin  K4 on the fetched windows, constant rows
  realrc   K4 on constant windows, the real replica rows

each as host wall time and as the CUDA-event span on the stream (the
device time between the first and last launch, idle gaps included), and
for the backends the kernel launches per super-step.  A program is built
(on the card: warmed up and captured) before its row is timed.  ``--duel
N`` instead interleaves the backends' eager, graph and step rows
round-robin for N rounds and prints each one's median, min, max and
interquartile range.  The tool runs on the card unless ``--device cpu``
is given; it fails when the card is asked for and absent.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time

import numpy as np
import torch

from .. import sim
from ..constants import CodeType, DType
from ..ops import band_taps, gram_taps, window_taps
from ..ops.window_taps import correlate_windows, correlate_windows8
from ..track import FastTracker, TrackConfig, Tracker

F_SF, F_IF = 16.368e6, 4.092e6
BACKENDS = ("band", "pallas", "fused", "xla")
REPLAYED = tuple(f"{c}:{u}" for c in BACKENDS for u in ("graph", "step"))
PROBES = ("nocorr", "gather", "mater", "kconst", "kconst1", "realwin",
          "realrc")
REPS = 3
# the launch counter of each backend's kernel (xla has none)
BACKEND_COUNTS = {"band": band_taps.COUNTS, "pallas": window_taps.COUNTS16,
                  "fused": gram_taps.COUNTS}


class Workload:
    """The tracker, its FastTracker, a started 32-channel state and an
    int8-alphabet sample block long enough for ``steps`` super-steps."""

    def __init__(self, device: torch.device, steps: int, channels: int):
        self.device = device
        self.S = steps
        prns = list(range(1, channels + 1))
        self.trk = Tracker(TrackConfig(corrn=6, corrd=3, corrp=6), prns,
                           [CodeType.L1CA] * channels, F_SF, F_IF,
                           DType.REAL, device=device)
        self.fast = FastTracker(self.trk)
        trk, fast = self.trk, self.fast
        L, nsamp = fast.L, trk.n_nom
        self.nsteps = steps * L
        block_len = (self.nsteps * nsamp + trk.nwin + 8 * self.nsteps
                     + 2 * nsamp + 64)
        x = sim.synthesize([sim.SimChannel(prn=1, doppler=500.0)], F_SF,
                           F_IF, DType.REAL, block_len, noise_std=1.5,
                           seed=3)
        q = sim.quantize_int8(x, 16.0).astype(np.float32)
        self.block = torch.from_numpy(q).to(device)
        self.block2 = fast._block_rows(self.block)
        st = trk.start_channels(trk.init_state(), list(range(channels)),
                                [0] * channels, [0.0] * channels)
        for c in range(channels):
            st = trk.set_bit_sync(st, c, c % 10)
        self.state = st
        self.carry = trk.state_to_carry(st)
        B = fast.C * L
        rng = np.random.default_rng(0)
        self.winc = torch.from_numpy(rng.integers(
            -8, 8, (B, trk.nwin)).astype(np.float32)).to(device)
        self.rcc = torch.from_numpy(rng.choice(
            np.asarray([-1.0, 1.0], np.float32), (B, trk.next))).to(device)

    # --- the timed variants: each runs S super-steps ---------------------
    def backend(self, corr: str):
        def run():
            self.fast.corr = corr
            return self.fast.run_steps(self.carry, self.block, self.S)
        return run

    def replayed(self, tag: str):
        """A ``REPLAYED`` row: ``<backend>:graph`` starts the S super-steps
        as one block program; ``<backend>:step`` loads a one-super-step
        program and replays it S times (its carry stays in the program's
        buffers), taking each step's telemetry.  The program is built
        here, before any timing."""
        corr, unit = tag.split(":")
        fast = self.fast
        fast.corr = corr
        prog = fast.program(self.nsteps if unit == "graph" else fast.L,
                            self.block.shape)

        def run():
            fast.corr = corr          # the CPU body reads the backend
            if unit == "graph":
                return prog.start(self.state, self.block)
            prog.load(self.state, self.block)
            for _ in range(self.S):
                prog.replay()
                prog.outputs()
        return run

    def _scan(self, taps):
        """S super-steps of geometry, ``taps(st, geo)`` -> (cur_i, cur_q)
        and the loop filter."""
        fast = self.fast
        st = self.carry
        for _ in range(self.S):
            geo = fast._geo_only(st)
            cur_i, cur_q = taps(st, geo)
            new, _, _ = fast._filter(st, geo, cur_i, cur_q)
            st = fast._merge(st, new)
        return st

    def _k(self, fn, win_of, rc_of):
        """Taps through kernel ``fn`` on the windows and rows that
        ``win_of(st, geo)``/``rc_of(geo)`` give."""
        fast = self.fast
        C, L = fast.C, fast.L
        B = C * L

        def taps(st, geo):
            ftot = (fast._fconsts["fbt"] + st["dcps"])[:, None].expand(C, L)
            z2 = fn(win_of(st, geo), rc_of(geo),
                    geo["rem_k"].reshape(B).contiguous(),
                    ftot.reshape(B).contiguous(),
                    geo["n_k"].reshape(B).contiguous(), fast.offsets,
                    fast.smax).reshape(C, L, -1)
            return z2[..., 1::2], z2[..., 0::2]
        return lambda: self._scan(taps)

    def _real_win(self, st, geo):
        return self.fast._fetch_windows(
            self.block2, geo["wstart"].reshape(-1)).to(torch.float32)

    def _real_rc(self, geo):
        return self.fast._replica_rows(geo["q_idx"]).to(torch.float32)

    def _fetch(self, full: bool):
        fast = self.fast

        def run():
            st = self.carry
            for _ in range(self.S):
                geo = fast._geo_only(st)
                rc = fast._replica_rows(geo["q_idx"])
                win = fast._fetch_windows(self.block2,
                                          geo["wstart"].reshape(-1))
                if full:
                    s = rc.to(torch.float32).sum() + win.to(
                        torch.float32).sum()
                else:
                    s = (rc[:, ::997].to(torch.float32).sum()
                         + win[:, ::997].to(torch.float32).sum())
                st = dict(st, remcarr=st["remcarr"] + 1e-12 * s)
            return st
        return run

    def probe(self, tag: str):
        fast = self.fast
        zeros = torch.zeros((fast.C, fast.L, fast.cfg.ntaps),
                            dtype=torch.float32, device=self.device)
        winc, rcc = (lambda st, geo: self.winc), (lambda geo: self.rcc)
        return {
            "nocorr": lambda: self._scan(lambda st, geo: (zeros, zeros)),
            "gather": self._fetch(full=False),
            "mater": self._fetch(full=True),
            "kconst": self._k(correlate_windows8, winc, rcc),
            "kconst1": self._k(correlate_windows, winc, rcc),
            "realwin": self._k(correlate_windows8, self._real_win, rcc),
            "realrc": self._k(correlate_windows8, winc, self._real_rc),
        }[tag]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_run(fn, device: torch.device, reps: int = REPS):
    """(wall s, CUDA-event ms or None) per call of ``fn``: one warm-up
    call, then ``reps`` back-to-back calls ending in a synchronize."""
    fn()
    _sync(device)
    ev = None
    if device.type == "cuda":
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if ev is not None:
        ev[1].record()
    _sync(device)
    wall = (time.perf_counter() - t0) / reps
    return wall, (ev[0].elapsed_time(ev[1]) / reps if ev else None)


def profile(device, steps: int = 50, channels: int = 32,
            log=print) -> dict:
    """Time every backend and probe; returns {tag: {"wall_ms", "event_ms"
    (None on the CPU), and for kernel backends "launches" and "plain"
    (calls of the kernel and of its plain version)}}, each per
    super-step."""
    device = torch.device(device)
    t0 = time.time()
    w = Workload(device, steps, channels)
    log(f"# workload: {channels} ch x L={w.fast.L} periods x {steps} "
        f"super-steps at {F_SF / 1e6:.3f} Msps on {device} "
        f"({time.time() - t0:.1f} s set-up)")
    out = {}
    samples = w.nsteps * w.trk.n_nom
    for tag in BACKENDS + REPLAYED + PROBES:
        fn = (w.backend(tag) if tag in BACKENDS else w.replayed(tag)
              if tag in REPLAYED else w.probe(tag))
        counts = BACKEND_COUNTS.get(tag.split(":")[0])
        before = (counts.kernel, counts.plain) if counts else None
        wall, ev = time_run(fn, device)
        rec = {"wall_ms": wall / steps * 1e3,
               "event_ms": None if ev is None else ev / steps}
        line = (f"{tag:12s} {rec['wall_ms']:8.3f} ms/step wall  "
                f"({samples / wall / 1e6:7.1f} Msps)")
        if ev is not None:
            line += f"  {rec['event_ms']:8.3f} ms/step events"
        if counts:
            calls = (REPS + 1) * steps
            rec["launches"] = (counts.kernel - before[0]) / calls
            rec["plain"] = (counts.plain - before[1]) / calls
            line += (f"  {rec['launches']:g} launch/step, "
                     f"{rec['plain']:g} plain/step")
        log(line)
        out[tag] = rec
    w.fast.corr = "band"
    return out


def duel(device, rounds: int, steps: int = 50, channels: int = 32,
         log=print) -> dict:
    """The four backends, eager and replayed (``REPLAYED``), interleaved
    round-robin for ``rounds`` rounds, so every round samples the same
    host and card load; returns {tag: [wall ms/step per round]}."""
    device = torch.device(device)
    w = Workload(device, steps, channels)
    tags = [t for c in BACKENDS for t in (c, f"{c}:graph", f"{c}:step")]
    runs = {tag: w.replayed(tag) if ":" in tag else w.backend(tag)
            for tag in tags}
    for fn in runs.values():
        fn()
    T = collections.defaultdict(list)
    for _ in range(rounds):
        for tag in tags:
            wall, _ = time_run(runs[tag], device, reps=2)
            T[tag].append(wall / steps * 1e3)
    samples = w.nsteps * w.trk.n_nom
    log(f"per-backend over {rounds} interleaved rounds (wall ms/super-step):")
    for tag in tags:
        v = np.asarray(T[tag])
        med = float(np.median(v))
        iqr = float(np.percentile(v, 75) - np.percentile(v, 25))
        log(f"  {tag:12s} med {med:7.3f}  min {v.min():7.3f}  max "
            f"{v.max():7.3f}  iqr {iqr:7.3f}  -> "
            f"{samples / (med * 1e-3 * steps) / 1e6:7.1f} Msps")
    w.fast.corr = "band"
    return dict(T)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gnsslib_tpu_torch.tools.profile_fast",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=50,
                    help="super-steps per timed run (default 50)")
    ap.add_argument("--channels", type=int, default=32,
                    help="tracked channels (default 32)")
    ap.add_argument("--duel", type=int, nargs="?", const=10, default=None,
                    metavar="N", help="interleave the backends for N rounds "
                    "(default 10)")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("profile_fast: no CUDA card (use --device cpu for the plain "
              "versions on the CPU)", file=sys.stderr)
        return 2
    if a.device == "cuda":
        print(f"# card: {torch.cuda.get_device_name(0)}")
    if a.duel is not None:
        duel(a.device, a.duel, a.steps, a.channels)
    else:
        profile(a.device, a.steps, a.channels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
