"""Per-channel observable history — the setobsdata equivalent.

Maintains the 80-deep rolling record (tow, codei, cnt, remcode-in-samples,
L, D, SNR) the epoch aligner interpolates over, with the reference's exact
carrier-phase accumulation and SNR smoothing (src/sdrtrk.c:160-208).

Batched: one call consumes a whole block of tracker outputs for one
channel, appending an entry per loop-filter event (flagloopfilter==2,
i.e. the reference's swloop cadence, src/sdrmain.c:277-302).
"""
from __future__ import annotations

import numpy as np

from ..constants import DPI, OBSINTERPN, SNSMOOTHMS


class ObsHistory:
    """History ring for one channel (newest entry at index 0, matching the
    reference's shiftdata-down layout)."""

    def __init__(self, ctime: float, f_sf: float, crate: float,
                 loop_periods: int, depth: int = OBSINTERPN):
        self.ctime = ctime                # code period (s)
        self.f_sf = f_sf
        self.crate = crate
        self.loop = loop_periods          # periods per loop-filter update
        self.depth = depth
        self.tow = np.zeros(depth)
        self.codei = np.zeros(depth, dtype=np.int64)
        self.cnt = np.zeros(depth, dtype=np.int64)
        self.remc = np.zeros(depth)       # remcode in samples
        self.L = np.zeros(depth)
        self.D = np.zeros(depth)
        self.S = np.zeros(depth)
        self.codeisum = np.zeros(depth, dtype=np.int64)
        self.nrec = 0
        self._L_acc = 0.0
        self._isum = 0.0
        self._loopcnt = 0
        self._flag_remcarr_added = False
        self._flag_polarity_added = False

    # ------------------------------------------------------------------ #
    def _push(self, tow, codei, cnt, remc, L, D):
        for a in (self.tow, self.codei, self.cnt, self.remc, self.L, self.D):
            a[1:] = a[:-1]
        self.tow[0] = tow
        self.codei[0] = codei
        self.cnt[0] = cnt
        self.remc[0] = remc
        self.L[0] = L
        self.D[0] = D
        self.nrec += 1

    @staticmethod
    def _prepend(a: np.ndarray, newest_first: np.ndarray) -> None:
        """Shift the ring down by len(newest_first) and place the new
        records at the top (index 0 = newest)."""
        take = min(len(newest_first), len(a))
        if take < len(a):
            a[take:] = a[:-take].copy()      # overlapping shift
        a[:take] = newest_first[:take]

    # ------------------------------------------------------------------ #
    def update(self, *, cnts, bufflocs, ns, dcarr, remcode, dcode,
               sum_i, flagloopfilter, remcarr,
               firstsftow: float, firstsfcnt: int,
               flagsyncf: bool, polarity: int) -> None:
        """Consume one block of per-period tracker outputs for this channel.

        Arguments are 1-D arrays over code periods (see track.loop
        .TrackOutputs): ``cnts`` period counters, ``bufflocs`` absolute
        sample index of each period start, ``ns`` period lengths,
        ``dcarr``/``dcode`` the post-update NCO offsets (Hz),
        ``remcode`` chips / ``remcarr`` cycles at period start,
        ``sum_i`` accumulated prompt-I taps (steps, ntaps),
        ``flagloopfilter`` 0/1/2.

        Fully vectorized over the block's loop-filter events: the
        per-event ring shift was the receiver's largest host cost
        (~63 ms per 2 s block x 32 channels), on the critical path that
        must overlap device compute.
        """
        upd = np.nonzero(np.asarray(flagloopfilter) == 2)[0]
        m = len(upd)
        if m == 0:
            return
        cnts = np.asarray(cnts)
        bufflocs = np.asarray(bufflocs)
        tow_u = firstsftow + (cnts[upd] - firstsfcnt) * self.ctime
        codefreq = self.crate + np.asarray(dcode)[upd]
        remc_u = np.asarray(remcode)[upd] * self.f_sf / codefreq
        D_u = -np.asarray(dcarr)[upd]

        # one-time phase anchors (src/sdrtrk.c:180-196), applied at the
        # first event of this block only
        anchor = 0.0
        if not self._flag_remcarr_added:
            anchor -= float(np.asarray(remcarr)[upd[0]])   # cycles
            self._flag_remcarr_added = True
        if flagsyncf and not self._flag_polarity_added:
            if polarity == 1:
                anchor += 0.5
            self._flag_polarity_added = True
        # delta-range accumulation (src/sdrtrk.c:198)
        dL = D_u * (self.loop * np.asarray(ns)[upd] / self.f_sf)
        L_u = self._L_acc + anchor + np.cumsum(dL)
        self._L_acc = float(L_u[-1])

        for a, v in ((self.tow, tow_u), (self.codei, bufflocs[upd]),
                     (self.cnt, cnts[upd]), (self.remc, remc_u),
                     (self.L, L_u), (self.D, D_u)):
            self._prepend(a, v[::-1])
        self.nrec += m

        # SNR smoothing every SNSMOOTHMS (src/sdrtrk.c:200-208 with the
        # snrflag cadence of src/sdrmain.c:284-288): segment sums of
        # |prompt I| between cadence firings, carried across blocks
        kappa = max(1, SNSMOOTHMS //
                    max(1, int(self.loop * self.ctime * 1000)))
        a_i = np.abs(np.asarray(sum_i)[upd, 0])
        fire = np.nonzero((self._loopcnt + np.arange(m)) % kappa == 0)[0]
        if len(fire):
            c = np.cumsum(a_i)
            s_vals = np.empty(len(fire))
            isum = self._isum
            last = -1
            for j, idx in enumerate(fire):
                isum += c[idx] - (c[last] if last >= 0 else 0.0)
                with np.errstate(divide="ignore"):
                    s_vals[j] = (10.0 * np.log(isum / 100.0 / 100.0)
                                 + np.log(500.0) + 5.0)
                isum = 0.0
                last = idx
            self._isum = float(isum + c[-1] - c[last])
            self._prepend(self.S, s_vals[::-1])
            self._prepend(self.codeisum, bufflocs[upd[fire]][::-1])
        else:
            self._isum += float(a_i.sum())
        self._loopcnt += m

    @property
    def full(self) -> bool:
        return self.nrec >= self.depth
