"""Per-channel navigation framer: bit sync, bit decision, frame decode.

Re-expresses the reference per-period ``sdrnavigation()`` state machine
(src/sdrnav.c:15-88, 198-282) as a *batched* host-side consumer of the
device tracker's prompt-correlator stream: the tracker (track/loop.py)
hands the host arrays of per-period prompt I values once per block, and the
framer advances its state over the whole batch with vectorized voting /
bit integration plus a tiny per-bit Python loop for frame logic
(~50 bits/s/channel).

State machine (identical to the reference):
* bit sync by zero-crossing histogram vote over bit phase, threshold
  NAVSYNCTH=50 (src/sdrnav.c:198-232); rate-1 signals sync trivially
  after 2 s (src/sdrnav.c:25-28);
* bit decision: accumulate prompt I across the bit, sign at the last
  period (src/sdrnav.c:241-282);
* frame sync: FEC predecode + preamble correlation each new bit until
  found, then decode every ``update`` periods (src/sdrnav.c:39-82).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..constants import (CodeType, NAVSYNCTH, NAVRATE_L1CA, NAVFLEN_L1CA,
                         NAVADDFLEN_L1CA, NAVPRELEN_L1CA, NAVEPHCNT_L1CA,
                         NAVRATE_SBAS, NAVFLEN_SBAS, NAVADDFLEN_SBAS,
                         NAVPRELEN_SBAS, NAVEPHCNT_SBAS, NAVRATE_G1,
                         NAVFLEN_G1, NAVADDFLEN_G1, NAVPRELEN_G1,
                         NAVEPHCNT_G1)
from .bits import bits2byte
from .eph import SdrEph
from .glonass import TIMEMARK_G1, decode_g1_symbols
from .lnav import PREAMBLE_L1CA, decode_frame_l1ca, paritycheck_l1ca
from .sbas import PREAMBLE_SBAS, SbasMsg, check_crc_sbas, decode_l1sbas_bits


@dataclasses.dataclass(frozen=True)
class NavParams:
    """Framing constants per code type (reference initnavstruct,
    src/sdrinit.c:489-581)."""
    rate: int        # code periods per nav bit/symbol
    flen: int        # frame length (bits/symbols)
    addflen: int     # extra leading bits kept
    prelen: int
    cntth: int       # subframes for a full ephemeris
    update: int      # decode cadence (code periods)
    prebits: np.ndarray


def nav_params(ctype: int) -> NavParams:
    if ctype == CodeType.L1CA:
        return NavParams(NAVRATE_L1CA, NAVFLEN_L1CA, NAVADDFLEN_L1CA,
                         NAVPRELEN_L1CA, NAVEPHCNT_L1CA,
                         NAVFLEN_L1CA * NAVRATE_L1CA, PREAMBLE_L1CA)
    if ctype == CodeType.L1SBAS:
        return NavParams(NAVRATE_SBAS, NAVFLEN_SBAS, NAVADDFLEN_SBAS,
                         NAVPRELEN_SBAS, NAVEPHCNT_SBAS,
                         NAVFLEN_SBAS // 3 * NAVRATE_SBAS, PREAMBLE_SBAS)
    if ctype == CodeType.G1:
        return NavParams(NAVRATE_G1, NAVFLEN_G1, NAVADDFLEN_G1,
                         NAVPRELEN_G1, NAVEPHCNT_G1,
                         NAVFLEN_G1 * NAVRATE_G1, TIMEMARK_G1)
    raise ValueError(f"no nav framing for ctype {ctype}")


@dataclasses.dataclass
class NavEvent:
    """Host-visible nav milestone."""
    kind: str          # 'bitsync' | 'preamble' | 'decode'
    cnt: int           # period counter at the event
    buffloc: int       # absolute sample index of the event period start
    sfid: int = 0
    tow: float = 0.0
    week: int = 0


class NavChannel:
    """Navigation state for one tracking channel."""

    def __init__(self, ctype: int, prn: int, sat: int = 0,
                 ref_week: int = 2200, sync_wait_periods: int = 2000):
        self.ctype = int(ctype)
        self.prn = int(prn)
        self.p = nav_params(ctype)
        self.ref_week = ref_week
        self.sync_wait = sync_wait_periods   # 2000/(ctime·1000) periods ~ 2 s
        self.eph = SdrEph(ctype=self.ctype, prn=prn, cntth=self.p.cntth)
        self.eph.eph.sat = sat
        self.sbas = SbasMsg()

        self.flagsync = False
        self.synci = 0
        self.votes = np.zeros(self.p.rate, dtype=np.int64)
        self.last_ip = 0.0

        n = self.p.flen + self.p.addflen
        self.fbits = np.zeros(n, dtype=np.int64)
        self.fbitsdec = np.zeros(n, dtype=np.int64)
        self.nbits_seen = 0
        self.bit_ip = 0.0            # partial-bit accumulator carry

        self.flagpol = False         # SBAS polarity flip (src/sdrnav.c:404)
        self.polarity = 1
        self.flagsyncf = False       # preamble found
        self.flagtow = False
        self.flagdec = False         # full ephemeris decoded
        self.firstsf = 0             # abs sample index at preamble period
        self.firstsfcnt = 0
        self.firstsftow = 0.0
        self.events: list[NavEvent] = []

    # ------------------------------------------------------------------ #
    @property
    def sync_offset(self) -> int:
        """Loop-cadence phase for Tracker.set_bit_sync: device swloop fires
        when (cnt+1 - sync_offset) % loop == 0, matching the reference's
        nav.cnt%loopms timing (src/sdrnav.c:261-263)."""
        return (self.synci + 1) % self.p.rate

    # ------------------------------------------------------------------ #
    def update(self, ip: np.ndarray, buffloc: np.ndarray, cnt0: int
               ) -> list[NavEvent]:
        """Feed prompt-I values for periods cnt0 .. cnt0+len(ip)-1.

        ``buffloc[k]`` is the absolute sample index of period k's start.
        Returns the nav events produced by this batch.
        """
        self.events = []
        ip = np.asarray(ip, dtype=np.float64)
        buffloc = np.asarray(buffloc, dtype=np.int64)
        n = len(ip)
        start = 0
        if not self.flagsync:
            start = self._bitsync_batch(ip, cnt0)
            if not self.flagsync:
                self.last_ip = ip[-1] if n else self.last_ip
                return self.events
        if start < n:
            self._bits_batch(ip[start:], buffloc[start:], cnt0 + start)
        self.last_ip = ip[-1] if n else self.last_ip
        return self.events

    # ------------------------------------------------------------------ #
    def _bitsync_batch(self, ip: np.ndarray, cnt0: int) -> int:
        """Vectorized zero-crossing vote; returns index of the first period
        AFTER sync is declared (len(ip) if no sync)."""
        n = len(ip)
        if self.p.rate == 1:
            # NH-premixed signals need no bit sync (src/sdrnav.c:25-28)
            if cnt0 + n > self.sync_wait + 1:
                self.synci = 0
                self.flagsync = True
                k = max(0, self.sync_wait + 1 - cnt0)
                self.events.append(NavEvent("bitsync", cnt0 + k, 0))
                return k
            return n
        prev = np.concatenate(([self.last_ip], ip[:-1]))
        cnts = cnt0 + np.arange(n, dtype=np.int64)
        chg = (prev * ip < 0) & (cnts > self.sync_wait)
        biti = cnts % self.p.rate
        if not np.any(chg):
            return n
        # find the period where the winning bin crosses the threshold
        idx = np.nonzero(chg)[0]
        for k in idx:
            b = int(biti[k])
            self.votes[b] += 1
            if self.votes[b] > NAVSYNCTH:
                self.synci = (b - 1) % self.p.rate
                self.flagsync = True
                self.events.append(NavEvent("bitsync", int(cnts[k]), 0))
                # the sync period is the first period of a new bit — include
                # it in bit processing (reference runs checkbit in the same
                # sdrnavigation call, src/sdrnav.c:31-36)
                return int(k)
        return n

    # ------------------------------------------------------------------ #
    def _bits_batch(self, ip: np.ndarray, buffloc: np.ndarray, cnt0: int
                    ) -> None:
        """Vectorized bit integration + per-bit frame logic."""
        n = len(ip)
        cnts = cnt0 + np.arange(n, dtype=np.int64)
        mod = (cnts - self.synci) % self.p.rate
        resets = np.nonzero(mod % self.p.rate == 1 % self.p.rate)[0]
        ends = np.nonzero(mod == 0)[0]

        # prefix: periods before the first reset extend the carried bit
        csum = np.cumsum(ip)

        def seg_sum(endi):
            """Sum of ip over the bit ending at index endi (inclusive)."""
            j = resets[resets <= endi]
            if len(j) == 0:
                return self.bit_ip + csum[endi]
            j0 = j[-1]
            s = csum[endi] - (csum[j0 - 1] if j0 > 0 else 0.0)
            return s  # reset at j0: bitIP starts fresh there
        for e in ends:
            bit_sum = seg_sum(int(e))
            self._complete_bit(bit_sum, int(cnts[e]), int(buffloc[e]))
        # carry for the trailing partial bit
        if len(resets) and resets[-1] > (ends[-1] if len(ends) else -1):
            j0 = int(resets[-1])
            self.bit_ip = float(csum[-1] - (csum[j0 - 1] if j0 > 0 else 0.0))
        elif len(ends):
            self.bit_ip = float(csum[-1] - csum[int(ends[-1])])
        else:
            self.bit_ip += float(csum[-1]) if n else 0.0

    # ------------------------------------------------------------------ #
    def _complete_bit(self, bit_sum: float, cnt: int, buffloc: int) -> None:
        pol = -1 if self.flagpol else 1
        bit = -pol if bit_sum < 0 else pol
        self.fbits[:-1] = self.fbits[1:]
        self.fbits[-1] = bit
        self.nbits_seen += 1

        p = self.p
        if not self.flagtow:
            if self.nbits_seen < p.flen + p.addflen:
                return
            self._predecodefec()
            if not self._findpreamble():
                return
            self.flagsyncf = True
            self.firstsf = buffloc
            self.firstsfcnt = cnt
            self.flagtow = True
            self.events.append(NavEvent("preamble", cnt, buffloc))
            # fall through: the reference decodes in the same call
            # (src/sdrnav.c:57-82 with cnt==firstsfcnt)
        if (cnt - self.firstsfcnt) % p.update == 0:
            self._predecodefec()
            sfid = self._decodenav()
            if self.eph.tow_gpst == 0.0:
                # reset on failed tow decode (src/sdrnav.c:69-72)
                self.flagsyncf = False
                self.flagtow = False
                return
            if cnt == self.firstsfcnt:
                self.flagdec = True
                self.firstsftow = self.eph.tow_gpst
                if self.ctype == CodeType.G1 and self.eph.prn:
                    self.prn = self.eph.prn
            self.events.append(NavEvent(
                "decode", cnt, buffloc, sfid=sfid,
                tow=self.eph.tow_gpst, week=self.eph.week_gpst))

    # ------------------------------------------------------------------ #
    def _predecodefec(self) -> None:
        """FEC predecode (src/sdrnav.c:288-318): L1CA/G1 pass through; SBAS
        runs the K=7 r=1/2 Viterbi over the symbol buffer."""
        p = self.p
        if self.ctype in (CodeType.L1CA, CodeType.G1):
            self.fbitsdec = self.fbits.copy()
            return
        sym = np.where(self.fbits == 1, 0, 255).astype(np.uint8)
        bits = native.viterbi27_decode(sym, p.flen // 2)
        dec = (1 - 2 * bits.astype(np.int64))
        self.fbitsdec = np.zeros_like(self.fbits)
        self.fbitsdec[:p.flen // 2] = dec

    def _findpreamble(self) -> bool:
        """Preamble correlation + parity gate (src/sdrnav.c:373-415)."""
        p = self.p
        if self.ctype == CodeType.L1CA:
            corr = int(np.dot(self.fbitsdec[p.addflen:p.addflen + p.prelen],
                              p.prebits[:p.prelen]))
        elif self.ctype == CodeType.L1SBAS:
            h = p.prelen // 2
            corr = int(np.dot(self.fbitsdec[:h], p.prebits[:h]) +
                       np.dot(self.fbitsdec[250:250 + h], p.prebits[h:2 * h]))
        else:  # G1 time mark trails the string
            corr = int(np.dot(self.fbitsdec[p.flen - p.prelen:p.flen],
                              p.prebits[:p.prelen]))
        if abs(corr) != p.prelen:
            return False
        self.polarity = 1 if corr > 0 else -1
        if self._paritycheck():
            return True
        if self.ctype == CodeType.L1SBAS and self.polarity == 1:
            self.flagpol = True   # retry with flipped bits (src/sdrnav.c:404)
        return False

    def _paritycheck(self) -> bool:
        """Frame parity/CRC (src/sdrnav.c:325-367)."""
        p = self.p
        bits = self.polarity * self.fbitsdec
        if self.ctype == CodeType.L1CA:
            for w in range(10):
                word = bits[w * 30:w * 30 + 32].copy()
                if word[1] == -1:
                    word[2:26] *= -1
                if not paritycheck_l1ca(word):
                    return False
            return True
        if self.ctype == CodeType.L1SBAS:
            return check_crc_sbas(bits[:250])
        return True  # G1: no parity here (reference stubs it, sdrnav.c:362)

    def _decodenav(self) -> int:
        """Dispatch frame decode (src/sdrnav.c:417-432)."""
        if self.ctype == CodeType.L1CA:
            bits = self.polarity * self.fbitsdec
            # un-invert data bits by previous word's D30* (sdrnav_gps.c:176)
            work = bits.copy()
            for w in range(10):
                if work[w * 30 + 1] == -1:
                    work[w * 30 + 2:w * 30 + 26] *= -1
            buff = bits2byte(work[self.p.addflen:], self.p.flen, 38)
            return decode_frame_l1ca(buff, self.eph, self.ref_week)
        if self.ctype == CodeType.L1SBAS:
            sfid = decode_l1sbas_bits(self.fbitsdec[:250], self.polarity,
                                      self.sbas, self.ref_week)
            if self.sbas.week != 0:
                self.eph.tow_gpst = self.sbas.tow
                self.eph.week_gpst = self.sbas.week
            return sfid
        return decode_g1_symbols(self.fbits, self.polarity, self.eph)
