"""Common-epoch observable formation — the sync-thread equivalent.

Re-expresses src/sdrsync.c:18-135 as a pure function over the channels'
observable histories: pick the reference epoch (minimum tow), align every
channel's history to it, anchor the receiver timebase at the reference
satellite's first-subframe sample, and form pseudorange / carrier-phase /
Doppler at a common receive time offset PTIMING (68.802 ms).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import CLIGHT, PTIMING, OBSINTERPN
from .history import ObsHistory


def interp1(x, y, t: float) -> float:
    """Piecewise local Lagrange interpolation, faithful to the reference
    (src/sdrcmn.c:505-553): 3-point at the edges, 4-point centered in the
    interior, binary-search neighborhood selection."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    if n < 1:
        return 0.0
    if n == 1:
        return float(y[0])
    if n == 2:
        return float((y[0] * (t - x[1]) - y[1] * (t - x[0])) / (x[0] - x[1]))
    if x[0] > x[-1]:
        x = x[::-1].copy()
        y = y[::-1].copy()
    if t <= x[1]:
        k, m = 0, 2
    elif t >= x[n - 2]:
        k, m = n - 3, n - 1
    else:
        k, m = 1, n
        while m - k != 1:
            i = (k + m) // 2
            if t < x[i - 1]:
                m = i
            else:
                k = i
        k -= 1
        m -= 1
        if abs(t - x[k]) < abs(t - x[m]):
            k -= 1
        else:
            m += 1
    z = 0.0
    for i in range(k, m + 1):
        s = 1.0
        for j in range(k, m + 1):
            if j != i:
                s *= (t - x[j]) / (x[i] - x[j])
        z += s * y[i]
    return float(z)


@dataclasses.dataclass
class SdrObs:
    """One satellite's observables at a common epoch (reference sdrobs_t,
    src/sdr.h:332-342)."""
    sys: int
    prn: int
    week: int
    tow: float
    P: float       # pseudorange (m)
    L: float       # carrier phase (cycles)
    D: float       # Doppler (Hz)
    S: float       # SNR (dB-Hz)
    fcn: int = 0   # GLONASS frequency channel number (0 otherwise)


@dataclasses.dataclass
class ChannelObsInput:
    """What the aligner needs per locked+decoded channel."""
    hist: ObsHistory
    sys: int
    prn: int
    week: int
    nsamp: int          # nominal samples per code period
    ctime: float        # code period (s)
    ti: float           # 1 / f_sf
    firstsf: int        # abs sample index at preamble (nav.firstsf)
    firstsfcnt: int
    fcn: int = 0        # GLONASS FDMA channel number (cfg.prn for G1)


class EpochAligner:
    """Stateful epoch gate: emits one obs set per OUTMS-aligned reftow
    (reference syncthread loop body, src/sdrsync.c:49-135)."""

    def __init__(self, outms: int = 400):
        self.outms = int(outms)
        self._oldreftow = 0.0

    def try_epoch(self, chans: list[ChannelObsInput]) -> list[SdrObs] | None:
        """Return observables for the current epoch, or None if the output
        gate does not fire (no new reftow / not on the OUTMS grid) — the
        reference's per-iteration gate (src/sdrsync.c:64-74)."""
        if not chans:
            return None
        reftow = min(float(c.hist.tow[0]) for c in chans)
        oldreftow = self._oldreftow
        self._oldreftow = reftow
        if oldreftow == reftow or round(reftow * 1000) % self.outms != 0:
            return None
        return self._epoch_at(chans, reftow)

    def _epoch_at(self, chans: list[ChannelObsInput], reftow: float
                  ) -> list[SdrObs] | None:
        """Observables at a specific reftow present in all histories."""
        # per-channel history index at the common tow (src/sdrsync.c:76-86)
        ind = []
        for c in chans:
            j = np.nonzero(np.abs(c.hist.tow - reftow) < 1e-4)[0]
            if len(j) == 0:
                return None     # a channel lacks the epoch: skip this epoch
            ind.append(int(j[0]))

        codei = np.array([c.hist.codei[ind[i]] for i, c in enumerate(chans)],
                         dtype=np.int64)
        remc = np.array([c.hist.remc[ind[i]] for i, c in enumerate(chans)])

        # reference satellite = nearest.  The reference compares raw sample
        # counts (minimum codei, src/sdrsync.c:88-98) — valid there because
        # both STEREO paths share one byte clock; here channels may live on
        # front ends with different sample rates, so compare and anchor in
        # RECEIVER TIME (seconds of the shared capture clock: all paths are
        # sample-synchronous from stream start, sample k <-> t = k*ti).
        t_arrive = codei.astype(np.float64) * np.array(
            [c.ti for c in chans])
        refi = int(np.argmin(t_arrive))
        ref = chans[refi]
        diffcnt = int(ref.hist.cnt[ind[refi]]) - ref.firstsfcnt
        sampref = ref.firstsf + int(
            ref.nsamp * (-PTIMING / (1000.0 * ref.ctime) + diffcnt))
        tref = sampref * ref.ti
        tbase = (int(ref.hist.codei[-1]) - 10 * ref.nsamp) * ref.ti
        trefd = tref - tbase

        out = []
        for i, c in enumerate(chans):
            P = CLIGHT * ((float(codei[i]) - remc[i]) * c.ti - tref)
            codeid = c.hist.codei.astype(np.float64) * c.ti - tbase
            L = interp1(codeid, c.hist.L, trefd)
            D = interp1(codeid, c.hist.D, trefd)
            out.append(SdrObs(sys=c.sys, prn=c.prn, week=c.week,
                              tow=reftow + PTIMING / 1000.0,
                              P=P, L=L, D=D, S=float(c.hist.S[0]),
                              fcn=c.fcn))
        return out
