"""Block-streamed file-replay receiver (port of
:mod:`gnsslib_tpu.runtime.receiver`).

For each block of IF samples:

    acquisition search  (pending channels, pipelined: decided
                         ``acq_pipeline_depth`` blocks later)
    tracking            (per-period Tracker during pull-in, FastTracker
                         once every locked channel is bit-synced)
    nav framers         (host, per channel)
    observable history + epoch alignment + RINEX output

Each tracking block is one program (:mod:`..track.program`): on a card a
CUDA graph of the pull-in or steady-state loop, captured when the receiver
is built (the counterpart of the JAX receiver's ``_precompile``) and
replayed per block.  The JAX receiver's pipeline options carry over with
its defaults: tracking blocks are queued ``pipeline_depth`` blocks deep in
the steady state (``pipeline``) and in pull-in (``pipeline_pullin``), and a
block's telemetry, whose copy to the host is queued right behind it, is
read only after later blocks have been queued, waiting for that block's
own end event and not for the later ones; searches are queued too
(``pipeline_acq``) and decided ``acq_pipeline_depth`` blocks later, the
code phase propagated along the acquired code-Doppler trajectory.
Without them a block's or a search's results are read at once.  A
block's telemetry feeds only the lock it was dispatched for: a channel
reset and started again while the block was queued has a new lock
generation.

With SPEC (``[SPECTRUM] SPEC=1``) the receiver carries the diagnostics of
the JAX receiver: a :class:`~..diag.monitor.SpectrumMonitor` on the
stream-time SPEC_MS grid, the acquisition surface of each acquired
channel (``acq_views``, ``on_acq``; the search then runs over every
channel and keeps its surface on the device until a lock is applied), the
last correlator tap shape of each channel (``corr_views``), and the host
shadows ``dcarr_live``/``prompt_live`` that the dashboards read.

The positioning options follow the JAX receiver: single-point positions
per epoch (SPP, with RAIM and a Hatch smoother before output), RTCM3 over
TCP, loss-of-lock detection with reacquisition (RELOCK, PULLINTMO),
position-aided hot start (HOTSTART), the even/odd acquisition
confirmation (ACQCONFIRM), per-channel tracking logs (LOG) and
checkpoints.

A tracking block follows its channels, not the nominal stream cursor
``base``: its first sample (``origin``) lies ``lead`` samples before the
earliest channel's next period start, as the host estimates it from the
blocks it has collected (:meth:`Receiver._place`), and its length
(``span``) covers the widest spread the channels of one group reach
(:data:`SPREAD_PERIODS`), so no window leaves the block however long the
stream runs, for channels whose code period is shorter than nominal and
for channels whose period is longer.  Live front ends (a capture process,
a growing file, the in-process driver bindings) stream through
:meth:`Receiver.run_live` and :meth:`MultiReceiver.run_live`.

Channels are grouped by RF path and loop cadence (:func:`build_receiver`):
GPS L1CA and GLONASS G1 channels update their loops every 10 periods after
bit sync, SBAS channels every 2, and the steady-state FastTracker needs
one interval.  Each group is a :class:`Receiver` with its own tracker and
block programs; the groups of one RF path share its device sample cache,
and a :class:`MultiReceiver` steps them in lockstep and merges their
observables in one :class:`OutputHub` (RINEX obs/nav, RTCM3 and the
NovAtel SBAS stream).

With ``mesh`` (a :class:`~..parallel.mesh.Mesh`) the group's three engines
are the channel-sharded ones of :mod:`..parallel.sharded`: each shard runs
its channels' block programs, and a search is decided at once over every
channel (the JAX mesh receiver's ``_acq_dev_ok = mesh is None``), so a
mesh receiver equals an unsharded one with ``pipeline_acq=False``.  Over a
multi-process mesh every process runs the same receiver, the telemetry and
decisions are all-gathered, and only the output host should write files
(``rinex=is_output_host()``).
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import math
import os
import pickle
import time

import numpy as np

from ..constants import (ACQSLEEP, CLIGHT, CodeType, DType, FREQ1,
                         OBSINTERPN, SYS_GPS, SYS_QZS)
from ..diag.tracklog import TrackLogger
from ..gtime import gpst2time
from ..nav import NavChannel
from ..obs.epoch import ChannelObsInput, EpochAligner, SdrObs
from ..obs.history import ObsHistory
from ..obs.rinex import RinexNavWriter, RinexObsWriter
from ..nav.sbas import gen_novatel_sbasmsg
from ..obs.rtcm import encode_1019, encode_1020, encode_1044, encode_msm7
from ..obs.smooth import HatchSmoother
from ..obs.spp import ecef2llh, predict_range, spp_solve
from ..acquire.search import Acquirer, AcqResult
from ..diag.monitor import SpectrumMonitor
from ..io.devcache import block_cache
from ..ops.nco import NSPAN
from ..sat import satno, satno2id
from ..spans import SBAS_COUNTERS, SBAS_SEND, SpanTable, merge
from ..track.fast import FastTracker
from ..track.loop import Tracker
from ..track.state import loop_interval, state_from_numpy, state_to_numpy
from .config import ReceiverConfig, unported_options
from .tcpout import TcpServer

# The widest spread, in code periods, between the channels of one group
# that a tracking block covers.  A GPS satellite's range moves between
# ~20,200 km (zenith) and ~25,800 km (horizon) over a pass: 5,600 km,
# 18.7 ms of code, ~19 periods of 1 ms.  A rising satellite (range
# shrinking) and a setting one (range growing) move in opposite directions,
# so two channels may drift ~38 periods apart from where they started, and
# they start within one period of each other (a code phase in [0, 1)):
# 40.  GLONASS (19,100 km altitude: ~16 periods over a pass) and SBAS
# (geostationary) stay inside it.  The receiver's clock offset moves every
# channel alike and does not widen the spread.
SPREAD_PERIODS = 40


def block_geometry(nsteps: int, nsamp: int, nwin: int,
                   depth: int = 2) -> dict:
    """A tracking block's extents for ``nsteps`` periods of ``nsamp``
    nominal samples, ``nwin``-sample windows and a pipeline ``depth``:

    * ``block_len``: what one block's periods need after a channel's
      first window (nsteps periods of at most nsamp + NSPAN samples, the
      last window, slack), and the extent the search reads from ``base``;
    * ``margin``: the host places a block from each channel's position in
      the block ``depth`` blocks before it (:meth:`Receiver._place`), and
      a period moves a window by at most NSPAN samples from nominal
      (``n`` is clamped there), so this bounds the error of its estimate;
    * ``lead``: the block starts one code period and the margin before
      the earliest channel's estimated next period start;
    * ``room``: a channel may start up to this far into the block (the
      :data:`SPREAD_PERIODS` bound, one period, the margin on both sides);
    * ``span``: the block's length, room + block_len."""
    block_len = nsteps * nsamp + nwin + NSPAN * nsteps + 2 * nsamp + 64
    margin = (depth + 1) * nsteps * NSPAN
    room = (SPREAD_PERIODS + 1) * nsamp + 2 * margin
    return dict(block_len=block_len, margin=margin, lead=nsamp + margin,
                room=room, span=room + block_len)


@dataclasses.dataclass
class ChannelRuntime:
    """Mutable per-channel receiver state (beyond the device state)."""
    idx: int
    cfg: object              # ChannelConfig
    nav: NavChannel
    hist: ObsHistory
    locked: bool = False
    synced: bool = False
    last_acq_attempt: float = -1e9
    acq_codei: int = -1      # code phase the search reported (searched block)
    acq_dcarr: float = 0.0   # its Doppler bin (Hz)
    t_acq: float = -1e9      # stream time the current lock started
    cn0: float = 0.0
    peak_prompt: float = 0.0
    # host shadows of the last collected block's telemetry for the
    # operator dashboards (diag/watch.py): never read from the device
    dcarr_live: float = 0.0
    prompt_live: float = 0.0


class OutputHub:
    """RINEX obs/nav writers, the RTCM3 and SBAS servers, SPP with its .pos
    file, and the common-epoch clock: one per receiver, shared by its
    channel groups, so that every RF path's pseudoranges land in the same
    epochs (the reference's one sync thread over all channels,
    src/sdrsync.c:49-135)."""

    def __init__(self, cfg: ReceiverConfig):
        self.cfg = cfg
        self.aligner = EpochAligner(cfg.outms)
        self.outms_ms = int(cfg.outms)
        self._oldreftow = 0.0
        self.obs_writer: RinexObsWriter | None = None
        self.nav_writer: RinexNavWriter | None = None
        if cfg.rinex:
            ts = time.gmtime()
            stamp = time.strftime("%Y%m%d%H%M%S", ts)
            date = [ts.tm_year, ts.tm_mon, ts.tm_mday, ts.tm_hour,
                    ts.tm_min, ts.tm_sec]
            os.makedirs(cfg.rinexpath, exist_ok=True)
            self.obs_writer = RinexObsWriter(
                os.path.join(cfg.rinexpath, f"sdr_{stamp}.obs"), date)
            self.nav_writer = RinexNavWriter(
                os.path.join(cfg.rinexpath, f"sdr_{stamp}.nav"), date)
        self.rtcm_srv = TcpServer(cfg.rtcmport) if cfg.rtcm else None
        self.sbas_srv = TcpServer(cfg.sbasport) if cfg.sbas else None
        self.epochs_written = 0
        self.ephs_written = 0
        # single-point positioning: the receiver registers complete
        # ephemerides in ``ephs``; each emitted epoch with >= 4 usable
        # satellites is solved and appended to ``positions`` (week, tow,
        # ecef, clk, nsat), ``solutions`` (week, tow, SppSolution) and the
        # .pos file
        self.spp = bool(cfg.spp)
        self.smoother = (HatchSmoother(window=int(cfg.smooth)) if cfg.smooth
                         else None)
        self.ephs = {}
        self.positions = []
        self.solutions = []
        self.pos_writer = None
        self._last_pos = None
        if self.spp and cfg.rinex:
            os.makedirs(cfg.rinexpath, exist_ok=True)
            stamp = time.strftime('%Y%m%d%H%M%S', time.gmtime())
            if self.obs_writer is not None:
                # share the RINEX files' timestamp
                stamp = os.path.basename(self.obs_writer.path)[4:-4]
            self.pos_writer = open(
                os.path.join(cfg.rinexpath, f"sdr_{stamp}.pos"), "w")
            self.pos_writer.write(
                "% gnsslib_tpu single-point positions\n"
                "% week tow  x(m) y(m) z(m)  clk(m)  nsat  "
                "lat(deg) lon(deg) h(m)  speed(m/s) gdop\n")

    def emit_epochs(self, inputs: list[ChannelObsInput]
                    ) -> list[list[SdrObs]]:
        """Emit every OUTMS-grid epoch now covered by all channel
        histories."""
        if not inputs:
            return []
        newest = min(float(c.hist.tow[0]) for c in inputs)
        lo = self._oldreftow if self._oldreftow > 0 else newest - 0.6
        epochs = []
        k = int(np.floor(lo * 1000.0 / self.outms_ms + 1e-6)) + 1
        while k * self.outms_ms <= newest * 1000.0 + 1e-3:
            t = k * self.outms_ms / 1000.0
            obs = self.aligner._epoch_at(inputs, t)
            if obs:
                if self.smoother is not None:
                    self.smoother.smooth(
                        obs, max_gap_s=2.5 * self.outms_ms / 1000.0)
                epochs.append(obs)
                if self.obs_writer:
                    self.obs_writer.write_epoch(obs)
                if self.rtcm_srv:
                    by_sys = {}
                    for o in obs:
                        by_sys.setdefault(o.sys, []).append(
                            (o.prn, o.P, o.L, o.D, o.S, o.fcn))
                    for sysid, lst in by_sys.items():
                        self.rtcm_srv.send(encode_msm7(
                            sysid, lst, obs[0].week, obs[0].tow))
                if self.spp:
                    self._solve_epoch(obs)
                self.epochs_written += 1
            k += 1
        self._oldreftow = newest
        return epochs

    def _solve_epoch(self, obs) -> None:
        sol = spp_solve(obs, self.ephs, x0=self._last_pos,
                        raim_thresh=float(self.cfg.raim))
        if not sol.ok:
            return
        self._last_pos = sol.pos
        self.positions.append((obs[0].week, obs[0].tow, sol.pos,
                               sol.clk, sol.nsat))
        self.solutions.append((obs[0].week, obs[0].tow, sol))
        if self.pos_writer:
            lat, lon, h = ecef2llh(sol.pos)
            spd = (float(np.linalg.norm(sol.vel))
                   if sol.vel is not None else 0.0)
            gdop = sol.dop["gdop"] if sol.dop else 0.0
            self.pos_writer.write(
                f"{obs[0].week:5d} {obs[0].tow:11.3f} "
                f"{sol.pos[0]:14.3f} {sol.pos[1]:14.3f} "
                f"{sol.pos[2]:14.3f} {sol.clk:12.3f} {sol.nsat:3d} "
                f"{math.degrees(lat):12.7f} {math.degrees(lon):12.7f} "
                f"{h:9.3f} {spd:8.3f} {gdop:6.2f}\n")
            self.pos_writer.flush()

    def emit_nav(self, channels: list[ChannelRuntime]) -> None:
        """Nav records on ephemeris update (src/sdrsync.c:137-156), by code
        type: a GLONASS G1 channel writes its ``geph`` (RINEX and RTCM
        1020), an L1CA channel its ``eph`` (RINEX, and RTCM 1019 or 1044);
        SBAS channels write none.  Idempotent per update flag, so each
        channel group calls it with its own channels."""
        for ch in channels:
            eph = ch.nav.eph
            if eph.update and eph.cnt >= eph.cntth:
                eph.cnt = 0
                eph.update = False
                self.ephs_written += 1
                g1 = ch.cfg.ctype == CodeType.G1
                l1ca = ch.cfg.ctype == CodeType.L1CA
                if self.nav_writer:
                    if g1:
                        self.nav_writer.write_geph(ch.nav.prn, eph.geph)
                    elif l1ca:
                        self.nav_writer.write_eph(ch.cfg.sys, ch.cfg.prn,
                                                  eph.eph)
                if self.rtcm_srv:
                    if g1:
                        self.rtcm_srv.send(encode_1020(ch.nav.prn, eph.geph))
                    elif l1ca and ch.cfg.sys == SYS_QZS:
                        self.rtcm_srv.send(encode_1044(ch.cfg.prn, eph.eph))
                    elif l1ca and ch.cfg.sys == SYS_GPS:
                        self.rtcm_srv.send(encode_1019(ch.cfg.prn, eph.eph))

    def close(self) -> None:
        if self.pos_writer is not None:
            self.pos_writer.close()
            self.pos_writer = None
        for w in (self.obs_writer, self.nav_writer):
            if w is not None and hasattr(w, "close"):
                w.close()
        for name in ("rtcm_srv", "sbas_srv"):
            srv = getattr(self, name)
            if srv is not None:
                srv.close()
                setattr(self, name, None)


class Receiver:
    """The receiver of one channel group on one front end replayed from a
    file (``frontend.read(start, n)`` + ``nsamples``), on ``device``: the
    channels of RF path ``ftype`` (or ``channels``, a subset of them).

    ``hub``: an :class:`OutputHub` shared with other groups (then
    ``standalone=False``: the owner, a :class:`MultiReceiver`, emits the
    merged epochs); by default the receiver owns its hub and emits epochs
    itself.  ``cache``: the :class:`DeviceBlockCache` of another group on
    the same front end.  ``frontend`` may be live (``is_live``): then
    :meth:`run_live` streams it.

    The pipeline options are the JAX receiver's, with its defaults:
    ``pipeline`` queues steady-state blocks and ``pipeline_pullin`` (by
    default ``pipeline``) pull-in blocks ``pipeline_depth`` deep before
    their telemetry is collected; ``pipeline_acq`` (by default
    ``pipeline``) decides a search ``acq_pipeline_depth`` (by default 2)
    blocks after it was queued, else at once through :attr:`_acq_search`
    (the override point, :meth:`_acq_dispatch`).  The block's placement
    uses the same estimates in every mode, so a pure scheduling change
    gives the same bits.

    ``mesh``: shard the channels over a :class:`~..parallel.mesh.Mesh`
    (searches are then decided at once: ``pipeline_acq`` is off)."""

    def __init__(self, cfg: ReceiverConfig, frontend, *, device,
                 ftype: int = 1, nsteps_per_block: int = 400,
                 hub: OutputHub | None = None, standalone: bool = True,
                 channels=None, cache: DeviceBlockCache | None = None,
                 pipeline: bool = True, pipeline_depth: int = 2,
                 pipeline_acq: bool | None = None,
                 acq_pipeline_depth: int | None = None,
                 pipeline_pullin: bool | None = None, mesh=None):
        missing = unported_options(cfg)
        if missing:
            raise NotImplementedError(
                "not ported to gnsslib_tpu_torch yet: " + ", ".join(missing))
        chans = (list(channels) if channels is not None else
                 [c for c in cfg.channels if c.ftype == ftype])
        if not chans:
            raise ValueError(f"no channels on front end {ftype}")
        self.cfg = cfg
        self.frontend = frontend
        self.standalone = standalone
        self.pipeline = bool(pipeline)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.pipeline_pullin = (self.pipeline if pipeline_pullin is None
                                else bool(pipeline_pullin))
        self.pipeline_acq = (self.pipeline if pipeline_acq is None
                             else bool(pipeline_acq))
        self.acq_pipeline_depth = (2 if acq_pipeline_depth is None
                                   else max(1, int(acq_pipeline_depth)))
        # queued tracking blocks, oldest first: (getter, base, origin,
        # ndisp, gen0, lock0, cnt0), and the position updates of collected
        # blocks not yet applied (_track_positions)
        self._pending: list = []
        self._pos_pend: list = []
        self._acq_pend: list = []     # (getter, base, at, t_disp, pend_idx)
        self._acq_search = self._acq_dispatch      # the override point
        spec = cfg.fends[ftype - 1]
        self.spec = spec
        prns = [c.prn for c in chans]
        ctypes = [c.ctype for c in chans]
        foffsets = [spec.foffset + c.foffset_fdma for c in chans]

        self.acq = Acquirer(prns, ctypes, spec.f_sf, spec.f_if, spec.dtype,
                            foffsets=foffsets, device=device,
                            confirm=cfg.acqconfirm)
        self.trk = Tracker(cfg.track, prns, ctypes, spec.f_sf, spec.f_if,
                           spec.dtype, foffsets=foffsets,
                           f_cfs=[c.f_cf for c in chans], device=device)
        try:
            # the steady state's L periods per step; a group of mixed loop
            # cadences stays on the per-period loop (build_receiver splits
            # such groups)
            self.fast = FastTracker(self.trk)
        except ValueError:
            self.fast = None
        # the engines step_block runs and the search it decides with: the
        # unsharded ones, or their channel-sharded forms over the mesh
        self.mesh = mesh
        self._slow_eng, self._fast_eng, self._acq_eng = \
            self.trk, self.fast, self.acq
        if mesh is not None:
            from ..parallel import (ShardedAcquirer, ShardedFastTracker,
                                    ShardedTracker)
            self._slow_eng = ShardedTracker(self.trk, mesh)
            self._acq_eng = ShardedAcquirer(self.acq, mesh)
            if self.fast is not None:
                self._fast_eng = ShardedFastTracker(self.fast, mesh)
            self.pipeline_acq = False
        self.state = self.trk.init_state()
        self.nsamp = self.trk.n_nom
        self.nsteps = int(nsteps_per_block)
        # the block follows its channels (_place), at these extents
        geo = block_geometry(self.nsteps, self.nsamp, self.trk.nwin,
                             self.pipeline_depth)
        self.block_len, self.margin = geo["block_len"], geo["margin"]
        self.lead, self.room, self.span = geo["lead"], geo["room"], \
            geo["span"]
        # the groups of one RF path share its device samples (one upload)
        if cache is not None and cache.fe is frontend:
            self.cache = cache
        else:
            self.cache = block_cache(frontend, device=device, span=self.span)
        self.base = 0
        # the first sample of the next block; the state's loc counts from it
        self.origin = -self.lead
        # host estimate of each started channel's next period start (an
        # absolute sample), which channels the device tracks (started and
        # never stopped: a channel that lost its lock keeps running until
        # it is started again), and a generation bumped at each start or
        # move, so older telemetry no longer updates the estimate
        C = len(chans)
        self._pos = np.zeros(C, np.int64)
        self._live = np.zeros(C, bool)
        self._gen = np.zeros(C, np.int64)
        # each channel's lock generation, bumped whenever its lock starts or
        # ends: a queued block feeds a channel only while it is unchanged
        self._lockgen = np.zeros(C, np.int64)
        # each channel's median prompt magnitude in its latest collected
        # block (inf until one is collected): which channel gives way when
        # locked channels spread beyond the bound (_place)
        self._prompt = np.full(C, np.inf)
        self._ndisp = 0                  # tracking blocks dispatched
        self.channels = []
        for i, c in enumerate(chans):
            nav = NavChannel(c.ctype, c.prn, sat=0, ref_week=cfg.ref_week)
            depth = max(OBSINTERPN,
                        2 * self.nsteps // loop_interval(c.ctype) + 8)
            hist = ObsHistory(
                ctime=float(self.trk.ctime[i]), f_sf=spec.f_sf,
                crate=float(self.trk.crate[i]),
                loop_periods=loop_interval(c.ctype), depth=depth)
            self.channels.append(ChannelRuntime(idx=i, cfg=c, nav=nav,
                                                hist=hist))
        self.hub = hub if hub is not None else OutputHub(cfg)
        # every group's channels, set by a MultiReceiver: the SBAS week
        # borrow (src/sdrnav_sbs.c:124-127) looks across groups
        self.peer_channels = None
        self.loggers = {}
        if cfg.log:
            os.makedirs(cfg.logpath, exist_ok=True)
            for ch in self.channels:
                sid = satno2id(satno(ch.cfg.sys, ch.cfg.prn)) or \
                    f"C{ch.cfg.prn:02d}"
                self.loggers[ch.idx] = TrackLogger(
                    cfg.logpath, sid, cfg.track.corrn, cfg.track.corrd,
                    float(self.trk.crate[ch.idx]), spec.f_if)
        # host shadow of state.cnt (+nsteps per block for channels active
        # at dispatch, 0 at start_channels): no device read per block
        self._cnt_host = np.zeros(len(self.channels), np.int64)
        self._events = []
        # wall-clock milestones since construction ("precompiled",
        # "first_block", "first_lock", "first_sync", "steady",
        # "first_epoch"); the host spans of step_block per stage and the
        # build's split (..spans), which the engines time their waits
        # and device work into; and wall seconds spent in step_block per
        # phase, the step_block spans' totals: "acquire" (no channel
        # locked), "pullin" (per-period scan), "steady" (FastTracker)
        self.timeline = {"t0": time.time()}
        self.spans = SpanTable()
        for eng in (self.acq, self.trk, self.fast):
            if eng is not None:
                eng.spans = self.spans
        if any(ch.cfg.ctype == CodeType.L1SBAS for ch in self.channels):
            # shown from the start: no frame is a count too
            self.spans.counters.update(dict.fromkeys(SBAS_COUNTERS, 0))
        self.stage_wall = self.spans.stage_wall
        # cooperative stop (the reference's keythread 'q' -> stopflag,
        # src/sdrmain.c:59-80): run_seconds ends at the next block boundary
        self.stop_requested = False
        # live diagnostics (SPEC): the spectrum monitor on the reference
        # spectrum-thread cadence (SPEC_MS, src/sdrspec.c:29-110), the
        # acquisition surface per acquired PRN (pltacq) and the last
        # correlator tap shape per PRN (plttrk, src/sdrmain.c:258-299)
        self.spec_monitor = (SpectrumMonitor(
            frontend, spec.f_sf, spec.dtype == DType.IQ,
            device=self.trk.device) if cfg.spec else None)
        self.acq_views = {}
        self.corr_views = {}
        self.on_acq = None
        self._precompile()

    def _precompile(self) -> None:
        """Build the pull-in block program and, when ``nsteps`` is a
        multiple of the steady loop interval, the steady one, at this
        receiver's block length (under a mesh, every local shard's): on a
        card one eager warm-up and one CUDA graph capture each, here and
        never per block.  Marks the ``precompiled`` milestone, which
        therefore carries the kernels' load (and any nvcc build) and the
        captures.  The span table's ``build`` stage gets the milestone and
        its split: the programs' warm-ups, captures and instantiations
        (``build.*``), and the graph pools' bytes (a counter)."""
        shape = (self.span,) + (
            (2,) if self.spec.dtype == DType.IQ else ())
        progs = [self._slow_eng.program(self.nsteps, shape)]
        if self.fast is not None and self.nsteps % self.fast.L == 0:
            progs.append(self._fast_eng.program(self.nsteps, shape))
        self._mark("precompiled")
        # a mesh engine gives one program per local shard
        progs = [p for x in progs for p in (x if isinstance(x, list)
                                             else [x])]
        sp = self.spans
        sp.add("build", "build", self.timeline["precompiled"])
        for key in ("warmup", "capture", "instantiate"):
            sp.add(f"build.{key}", "build",
                   sum(getattr(p, key + "_s") for p in progs),
                   n=len(progs), parent="build")
        sp.counters["build.programs"] = len(progs)
        sp.counters["build.pool_bytes"] = sum(p.pool_bytes for p in progs)

    def _block(self):
        """The next tracking block: samples [origin, origin + span) on the
        device."""
        return self.cache.get(self.origin, self.span)

    def _search_offset(self) -> int:
        """Where the search reads the block: from ``base``, or the nearest
        sample that leaves it ``block_len`` samples when the channels have
        drifted far from the nominal cursor."""
        return min(max(self.base - self.origin, 0), self.room)

    def _start(self, i: int, boundary: int, dcarr: float,
               period: float) -> None:
        """Start channel ``i`` at its code boundary ``boundary`` samples
        after ``base`` with carrier offset ``dcarr``; a boundary outside
        the block moves by whole code periods of ``period`` samples into
        its first period."""
        loc = boundary + (self.base - self.origin)
        if not 0 <= loc <= self.room:
            loc = int(round((boundary + self.base - self.origin) % period))
        self.state = self.trk.start_channels(self.state, [i], [loc], [dcarr])
        self._cnt_host[i] = 0
        self._pos[i] = self.origin + loc
        self._live[i] = True
        self._gen[i] += 1
        self._lockgen[i] += 1
        self._prompt[i] = np.inf

    def _mark(self, name: str) -> None:
        if name not in self.timeline:
            self.timeline[name] = time.time() - self.timeline["t0"]

    @property
    def events(self) -> list:
        """Receiver events in stream-time order."""
        return sorted(self._events, key=lambda e: e[1])

    @property
    def epochs_written(self) -> int:
        return self.hub.epochs_written

    @property
    def ephs_written(self) -> int:
        return self.hub.ephs_written

    @property
    def obs_writer(self):
        return self.hub.obs_writer

    @property
    def nav_writer(self):
        return self.hub.nav_writer

    # ------------------------------------------------------------------ #
    def _search_block(self):
        """The samples a search reads (``block_len`` of them, from ``base``
        or the nearest sample in the block, :meth:`_search_offset`) and
        the stream sample where they start."""
        off = self._search_offset()
        return self._block()[off:off + self.block_len], self.origin + off

    def _acq_dispatch(self) -> AcqResult:
        """One acquisition pass over the current stream position, decided
        at once: the single override point (tests intercept it to suppress
        channels).  With the diagnostics monitor on, every channel is
        searched and the power surface rides along (the pltacq view,
        src/sdrmain.c:258-261)."""
        block, _ = self._search_block()
        return self._acq_eng.search_dev(block,
                                        diag=self.spec_monitor is not None)

    def _collect_acq(self, all_pending: bool = False) -> None:
        """Apply in-flight searches dispatched at least
        ``acq_pipeline_depth`` blocks ago (all of them with
        ``all_pending``)."""
        adv = self.nsteps * self.nsamp
        depth = self.acq_pipeline_depth
        while self._acq_pend and (
                all_pending
                or self.base - self._acq_pend[0][1] >= depth * adv
                or len(self._acq_pend) > depth):
            getter, _, at, t_disp, pend_idx = self._acq_pend.pop(0)
            self._apply_acq(getter(), at, t_disp, pend_idx)

    def _try_acquire(self) -> None:
        t_stream = self.base / self.spec.f_sf
        pend = [ch for ch in self.channels if not ch.locked and
                t_stream - ch.last_acq_attempt >= ACQSLEEP / 1000.0 - 1e-9]
        if not pend:
            return
        pend = self._try_hotstart(pend, t_stream)
        if not pend:
            return
        for ch in pend:
            ch.last_acq_attempt = t_stream
        idx = [ch.idx for ch in pend]
        if not (self.pipeline_acq and getattr(self._acq_search, "__func__",
                                              None) is Receiver._acq_dispatch):
            # decided now (tests overriding _acq_search take this path)
            _, at = self._search_block()
            self._apply_acq(self._acq_search(), at, t_stream, idx)
            return
        block, at = self._search_block()
        handle = self.acq.search_dev_start(
            block, idx=idx, diag=self.spec_monitor is not None)
        self._acq_pend.append((
            functools.partial(self.acq.search_dev_collect, handle),
            self.base, at, t_stream, idx))

    def _apply_acq(self, res: AcqResult, at: int, t_disp: float,
                   pend_idx: list[int]) -> None:
        """Start tracking for every pending channel the search accepted
        (the search read the stream from sample ``at``); a decision that
        arrives later than its searched block propagates the code phase
        along the acquired code-Doppler trajectory."""
        delta = self.base - at
        for i in pend_idx:
            ch = self.channels[i]
            if ch.locked or not bool(res.acquired[i]):
                continue
            codei = int(res.codei[i])
            dcarr = float(res.dcarr[i])
            ch.acq_codei, ch.acq_dcarr = codei, dcarr
            cfreq = float(self.trk.crate[i]) + dcarr * float(self.trk.aid[i])
            tc_samp = self.trk._clens[i] / cfreq * self.spec.f_sf
            if delta:
                codei = int(round((codei - delta) % tc_samp))
            ch.locked = True
            ch.t_acq = self.base / self.spec.f_sf
            ch.cn0 = float(res.cn0[i])
            self._mark("first_lock")
            self._start(i, codei, dcarr, tc_samp)
            self._events.append(
                ("acq", t_disp, ch.cfg.prn, float(res.cn0[i]),
                 float(res.peakr[i])))
            if res.P is not None:
                # only an acquired channel's surface leaves the device;
                # grid_scale: full-rate samples per surface code-phase cell
                # (> 1 with the coarse search): codei is full-rate
                view = dict(surface=res.P[i].cpu().numpy(),
                            dopp_hz=self.acq.dopp_hz,
                            codei=ch.acq_codei,
                            grid_scale=float(self.acq.scale),
                            cn0=float(res.cn0[i]), t=t_disp)
                self.acq_views[ch.cfg.prn] = view
                if self.on_acq is not None:
                    self.on_acq(ch, view)

    def _try_hotstart(self, pend: list, t_stream: float) -> list:
        """Position/ephemeris-aided handoff (HOTSTART=1): once fixes
        exist, an unlocked satellite's code-boundary sample and Doppler are
        predicted from the last fix, its broadcast orbit and a decoded
        reference channel's transmit-time anchor, and the channel starts
        straight in pull-in.  Returns the channels still needing the FFT
        search."""
        hub = self.hub
        if not self.cfg.hotstart or not hub.solutions:
            return pend
        # the prediction anchors on the reference channel's newest history
        # record: collect the in-flight blocks first, or the anchor is
        # pipeline_depth blocks stale
        self.flush()
        # the flush may have applied a search that locked some of these
        pend = [ch for ch in pend if not ch.locked]
        if not pend:
            return pend
        ref = next((c for c in self.channels if c.locked and c.nav.flagdec
                    and c.cfg.ctype == CodeType.L1CA
                    and c.hist.nrec > 0), None)
        if ref is None:
            return pend
        eph_r = hub.ephs.get((ref.cfg.sys, ref.nav.prn))
        if eph_r is None:
            return pend
        _, _, sol = hub.solutions[-1]
        pos = sol.pos
        week = ref.nav.eph.week_gpst
        ti = self.trk.ti
        # transmit-time anchor from the reference channel's newest record,
        # advanced at the reference's transmit rate (1 - dtau/dt)
        tow_r = float(ref.hist.tow[0])
        s_r = float(ref.hist.codei[0]) - float(ref.hist.remc[0])
        tau_r, rate_r = predict_range(eph_r, pos, gpst2time(week, tow_r))
        T_r = tow_r + (self.base - s_r) * ti * (1.0 - rate_r)
        t_rx = gpst2time(week, T_r + tau_r)      # GPS receive time at base
        remaining = []
        for ch in pend:
            if ch.cfg.ctype == CodeType.G1:
                # GLONASS: the hub keys a geph by its slot; find the one of
                # this channel's FDMA number (geph.frq)
                e = next((g for (s, _), g in hub.ephs.items()
                          if s == ch.cfg.sys
                          and getattr(g, "frq", None) == ch.cfg.prn), None)
                f_cf = ch.cfg.f_cf
            elif ch.cfg.ctype == CodeType.L1CA:
                e = hub.ephs.get((ch.cfg.sys, ch.cfg.prn))
                f_cf = FREQ1
            else:
                e = None
            if e is None:
                remaining.append(ch)
                continue
            tau_t, rate = predict_range(e, pos, t_rx)
            # sample of this satellite's next code-period boundary
            T_tx_t = (T_r + tau_r) - tau_t
            ctime = float(self.trk.ctime[ch.idx])
            loc = int(round(((-T_tx_t) % ctime) / ti))
            D = rate * f_cf + sol.clk_drift * f_cf / CLIGHT
            self._start(ch.idx, loc, -D, ctime / ti)
            ch.locked = True
            ch.t_acq = t_stream
            ch.last_acq_attempt = t_stream
            self._events.append(("hot", t_stream, ch.cfg.prn,
                                 float(-D), loc))
        return remaining

    # ------------------------------------------------------------------ #
    def _feed_nav_and_obs(self, out, cnt0: np.ndarray, base: int,
                          origin: int, lock0: np.ndarray) -> None:
        """Nav, relock checks, track logs and observable history of one
        collected block, whose first sample is ``origin``, for each
        channel still on the lock it had when the block was dispatched
        (lock generation ``lock0``): a channel that was idle then, or was
        reset and started again while the block was queued, skips it.
        Spans ``nav`` (all but the history, per channel), ``obs.hist``
        (:meth:`ObsHistory.update`) and, for an SBAS message decoded,
        ``sbas.send`` between the framer and the checks."""
        nav, hist = self.spans("nav"), self.spans("obs.hist")
        for ch in self.channels:
            i = ch.idx
            if not (ch.locked and lock0[i] == self._lockgen[i]):
                continue
            was_started = int(cnt0[i])
            steps = out.ip.shape[0]
            with nav:
                # the dashboards' shadows (host arrays; no device read)
                ch.dcarr_live = float(out.dcarr[-1, i])
                ch.prompt_live = float(np.median(np.abs(out.ip[:, i])))
                evs = ch.nav.update(
                    out.ip[:, i], origin + out.loc[:, i].astype(np.int64),
                    was_started, self.spans)
                for e in evs:
                    self._events.append(("nav:" + e.kind,
                                         base / self.spec.f_sf,
                                         ch.cfg.prn, e.sfid, e.tow))
                if ch.nav.flagsync and not ch.synced:
                    self.state = self.trk.set_bit_sync(self.state, i,
                                                       ch.nav.sync_offset)
                    ch.synced = True
                    self._mark("first_sync")
                sends = (ch.cfg.ctype == CodeType.L1SBAS
                         and self.hub.sbas_srv is not None
                         and any(e.kind == "decode" for e in evs))
                if not sends:
                    self._nav_checks(ch, out, cnt0, base)
            if sends:
                with self.spans(SBAS_SEND):
                    self._send_sbas(ch)
                with nav:
                    self._nav_checks(ch, out, cnt0, base)
            if ch.nav.flagdec:
                with hist:
                    ch.hist.update(
                        cnts=was_started + np.arange(steps),
                        bufflocs=origin + out.loc[:, i].astype(np.int64),
                        ns=out.n[:, i], dcarr=out.dcarr[:, i],
                        remcode=out.remcode[:, i], dcode=out.dcode[:, i],
                        sum_i=out.sum_i[:, i], remcarr=out.remcarr[:, i],
                        flagloopfilter=out.flagloopfilter[:, i],
                        firstsftow=ch.nav.firstsftow,
                        firstsfcnt=ch.nav.firstsfcnt,
                        flagsyncf=ch.nav.flagsyncf,
                        polarity=ch.nav.polarity)

    def _nav_checks(self, ch, out, cnt0: np.ndarray, base: int) -> None:
        """A channel's work after its framer in a collected block: its
        track log, the correlator view and the relock checks."""
        i = ch.idx
        if i in self.loggers:
            self.loggers[i].log_block(out, i, ch.nav, ch.hist, int(cnt0[i]))
        if self.spec_monitor is not None:
            # both loop phases update the taps: show the latest
            upd = np.nonzero(out.flagloopfilter[:, i] > 0)[0]
            if len(upd):
                k = int(upd[-1])
                self.corr_views[ch.cfg.prn] = dict(
                    offsets=np.asarray(self.trk.offsets),
                    mag=np.hypot(out.sum_i[k, i], out.sum_q[k, i]),
                    t=base / self.spec.f_sf)
        if self.cfg.relock and ch.synced:
            self._check_lock(ch, out, base)
        elif self.cfg.relock and not ch.synced:
            self._check_pullin(ch, base)

    def _send_sbas(self, ch) -> None:
        """The SBAS message a channel has just decoded as a NovAtel
        RAWSBASFRAME over TCP (src/sdrnav_sbs.c:100-140), counted in
        ``sbas.frames``; before the channel's own MT12 gives the week, it
        is borrowed from a decoded channel of any group."""
        sb = ch.nav.sbas
        if sb.week == 0:
            for other in (self.peer_channels or self.channels):
                if other.nav.flagdec and other.nav.eph.week_gpst:
                    sb.week = other.nav.eph.week_gpst
                    sb.tow = other.hist.tow[0]
                    break
        if sb.week:
            gen_novatel_sbasmsg(sb)
            self.hub.sbas_srv.send(bytes(sb.novatelmsg))
            self.spans.count("sbas.frames")

    def _check_lock(self, ch, out, base: int) -> None:
        """Loss-of-lock test (RELOCK=1) on a bit-synced channel: the
        outermost tap pair sits +-corrn*corrd samples from prompt, outside
        the +-1-chip correlation triangle for the usual geometries, so it
        measures the noise floor at the coherent length; lock is lost when
        the block-median prompt magnitude falls below twice that floor.
        Geometries whose outer taps lie inside the triangle (under ~1.05
        chips) fall back to 0.15 of the remembered peak prompt."""
        i = ch.idx
        upd = out.flagloopfilter[:, i] == 2
        if not np.any(upd):
            return
        mag = lambda t: (np.abs(out.sum_i[upd, i, t])
                         + np.abs(out.sum_q[upd, i, t]))
        p_med = float(np.median(mag(0)))
        outer_chips = (self.cfg.track.corrn * self.cfg.track.corrd
                       * float(self.trk.crate[i]) / self.spec.f_sf)
        if outer_chips >= 1.05:
            noise = float(np.median(np.concatenate([mag(-2), mag(-1)])))
            lost = p_med < 2.0 * noise
        else:
            lost = p_med < 0.15 * max(ch.peak_prompt, 1e-9)
        if lost:
            self._reset_channel(ch, base / self.spec.f_sf)
        else:
            ch.peak_prompt = max(ch.peak_prompt, p_med)

    def _reset_channel(self, ch, t_stream: float) -> None:
        """Loss-of-lock teardown: drop the lock, clear nav and observable
        state, make the channel eligible for the next search, and record a
        ``lol`` event.  The peak prompt is forgotten, so a satellite that
        returns weaker is not judged against the old lock's level."""
        ch.locked = False
        ch.synced = False
        ch.nav = NavChannel(ch.cfg.ctype, ch.cfg.prn,
                            ref_week=self.cfg.ref_week)
        ch.hist.nrec = 0
        ch.last_acq_attempt = -1e9
        ch.peak_prompt = 0.0
        self._lockgen[ch.idx] += 1
        self._events.append(("lol", t_stream, ch.cfg.prn))

    def _check_pullin(self, ch, base: int) -> None:
        """Pull-in watchdog (RELOCK=1, PULLINTMO): a channel with no bit
        sync ``pullin_timeout`` seconds after its lock started is tracking
        noise (a fade during pull-in, or a false lock) and is reset."""
        t_stream = base / self.spec.f_sf
        if t_stream - ch.t_acq > self.cfg.pullin_timeout:
            self._reset_channel(ch, t_stream)

    def collect_obs_inputs(self) -> list[ChannelObsInput]:
        """Aligner inputs for every channel with a full, decoded history;
        registers each channel's complete ephemeris in the hub for SPP and
        the hot start: an L1CA channel's when subframes 2 and 3 agree on
        the IODE, a G1 channel's ``geph`` under its slot once it has a
        position, marked with the channel's FDMA number (``frq``)."""
        for ch in self.channels:
            if not ch.nav.flagdec:
                continue
            if ch.cfg.ctype == CodeType.G1:
                if any(ch.nav.eph.geph.pos):
                    ch.nav.eph.geph.frq = ch.cfg.prn
                    self.hub.ephs[(ch.cfg.sys, ch.nav.prn)] = \
                        ch.nav.eph.geph
                continue
            e = ch.nav.eph.eph
            if e.A > 0.0 and e.i0 != 0.0 and e.toe.time and \
                    ch.nav.eph.iode_sf2 == ch.nav.eph.iode_sf3:
                key = (ch.cfg.sys, ch.nav.prn)
                old = self.hub.ephs.get(key)
                if old is None or old.iode != e.iode:
                    self.hub.ephs[key] = copy.deepcopy(e)
        ready = [ch for ch in self.channels
                 if ch.nav.flagdec and ch.nav.eph.week_gpst != 0
                 and ch.hist.full]
        return [ChannelObsInput(
            hist=ch.hist, sys=ch.cfg.sys, prn=ch.nav.prn,
            week=ch.nav.eph.week_gpst, nsamp=self.nsamp,
            ctime=float(self.trk.ctime[ch.idx]), ti=self.trk.ti,
            firstsf=ch.nav.firstsf, firstsfcnt=ch.nav.firstsfcnt,
            fcn=(ch.cfg.prn if ch.cfg.ctype == CodeType.G1 else 0))
            for ch in ready]

    def _emit_epochs(self) -> list[list[SdrObs]]:
        epochs = (self.hub.emit_epochs(self.collect_obs_inputs())
                  if self.standalone else [])
        self.hub.emit_nav(self.channels)
        if self.hub.epochs_written:
            self._mark("first_epoch")
        return epochs

    # ------------------------------------------------------------------ #
    def _snapshot(self) -> dict:
        if self.mesh is not None and self.mesh.nproc > 1:
            # each process's state holds only its own channels' rows
            raise RuntimeError(
                "a checkpoint of a multi-process mesh receiver is not "
                "supported: each process holds only its own channels' "
                "tracking state")
        return dict(
            base=self.base, origin=self.origin, pos=self._pos.copy(),
            live=self._live.copy(), oldreftow=self.hub._oldreftow,
            state=state_to_numpy(self.state),
            channels=[(ch.locked, ch.synced, ch.last_acq_attempt,
                       ch.cn0, ch.peak_prompt, ch.nav, ch.hist, ch.t_acq)
                      for ch in self.channels],
            epochs=self.epochs_written, ephs=self.ephs_written)

    def _restore(self, d: dict) -> None:
        self.base = d["base"]
        if "origin" in d:
            self.origin = d["origin"]
            self._pos = d["pos"].copy()
            self._live = d["live"].copy()
        else:
            # a snapshot from before blocks followed their channels: its
            # block started one code period before base, and the state's
            # offsets count from there
            self.origin = self.base - self.nsamp
            self._live = np.asarray(d["state"]["active"], bool).copy()
            self._pos = self.origin + np.asarray(d["state"]["loc"],
                                                 np.int64)
        self._gen += 1
        self._lockgen += 1
        self._prompt[:] = np.inf
        self.hub._oldreftow = d["oldreftow"]
        self.state = state_from_numpy(d["state"], self.trk.device)
        self._cnt_host = np.asarray(d["state"]["cnt"], np.int64).copy()
        for ch, rec in zip(self.channels, d["channels"]):
            (ch.locked, ch.synced, ch.last_acq_attempt, ch.cn0,
             ch.peak_prompt, ch.nav, ch.hist, ch.t_acq) = rec
        self.hub.epochs_written = d["epochs"]
        self.hub.ephs_written = d["ephs"]

    def save_checkpoint(self, path: str) -> None:
        """Snapshot the receiver after a flush: the absolute sample index,
        the tracking state (as numpy arrays), each channel's lock flags,
        nav and observable history, and the hub's counters."""
        self.flush()
        snap = self._snapshot()
        with open(path, "wb") as f:
            pickle.dump(snap, f)

    def load_checkpoint(self, path: str) -> None:
        """Restore a snapshot of :meth:`save_checkpoint` (same config) onto
        this receiver's device.  The file is unpickled: load only
        checkpoints this program wrote."""
        with open(path, "rb") as f:
            self._restore(pickle.load(f))

    def end_sample(self, seconds: float | None = None) -> int:
        end = self.frontend.nsamples
        if seconds is not None:
            end = min(end, int(seconds * self.spec.f_sf))
        return end

    def can_step(self, end_sample: int, final: bool = True) -> bool:
        """Whether the next block can run on a stream of ``end_sample``
        samples.  ``final``: the stream ends there (a file, or a live
        stream at its EOF), and a block runs while the search's extent
        from ``base`` lies inside it; its channels' windows may reach past
        the end, which reads zeros.  Otherwise (a live stream still
        growing) the producer must have written the whole block."""
        if final:
            return self.base + self.block_len <= end_sample
        return max(self.origin + self.span,
                   self.base + self.block_len) <= end_sample

    def step_block(self) -> None:
        """Process one block: acquire, track, nav, observable history and
        epochs.  A pipelined block is only queued here; its nav/obs host
        work runs when it matures (:meth:`flush` finalizes the rest).  The
        block's host work is timed in :attr:`spans` under its stage, and
        its wall in :attr:`stage_wall`."""
        sp = self.spans
        with sp.step(self._ndisp + 1):
            sp.stage = self._step_block()

    def _step_block(self) -> str:
        """The body of :meth:`step_block`; returns the block's stage:
        ``acquire`` (no channel locked), ``pullin`` or ``steady``."""
        sp = self.spans
        advance = self.nsteps * self.nsamp
        if self.spec_monitor is not None:
            with sp("spec"):
                self.spec_monitor.maybe_update(self.base)
        with sp("acq.collect"):
            self._collect_acq()
        with sp("acq.dispatch"):
            self._try_acquire()
        if not any(ch.locked for ch in self.channels):
            # no tracking block: the next block moves with the cursor, and
            # the channels the device still tracks (after a loss of lock)
            # keep their block offsets, as the device saw no block
            self.base += advance
            self.origin += advance
            self._pos[self._live] += advance
            self._mark("first_block")
            return "acquire"
        use_fast = (self.fast is not None and self.nsteps % self.fast.L == 0
                    and all(ch.synced for ch in self.channels if ch.locked))
        if use_fast:
            self._mark("steady")
        eng = self._fast_eng if use_fast else self._slow_eng
        pipelined = self.pipeline if use_fast else self.pipeline_pullin
        if not pipelined:
            # strict order: the queued blocks' nav work first (the queued
            # searches stay queued)
            self._flush_blocks()
        cnt0 = self._cnt_host.copy()
        locked0 = np.array([ch.locked for ch in self.channels])
        with sp("cache.get"):
            block = self._block()
        with sp("track.dispatch").at(self._ndisp + 1):
            self.state, handle = eng.run_block_start(self.state, block,
                                                     self.nsteps)
        self._ndisp += 1
        self._pos[self._live] += advance
        entry = (functools.partial(eng.run_block_collect, handle),
                 self.base, self.origin, self._ndisp, self._gen.copy(),
                 self._lockgen.copy(), cnt0)
        if pipelined:
            self._pending.append(entry)
            while len(self._pending) > self.pipeline_depth:
                self._collect(*self._pending.pop(0))
        else:
            self._collect(*entry)
        self._cnt_host[locked0] += self.nsteps
        self.base += advance
        # the next block starts from the channels' positions as of the
        # block dispatched pipeline_depth blocks back, in every mode
        with sp("place"):
            self._track_positions(self._ndisp - self.pipeline_depth)
            self._place()
        self._mark("first_block")
        return "steady" if use_fast else "pullin"

    def _place(self) -> None:
        """Choose the next block's first sample from the channels'
        estimated next period starts and rebase the state's offsets to it.

        The block starts ``lead`` samples before the earliest channel the
        device tracks.  Should the channels that lost their lock (which
        track noise until they are started again) stretch the group wider
        than ``room``, the block follows the locked channels alone, and
        each lost channel outside it moves by whole code periods to the
        earliest locked one.  Locked channels wider apart than the
        :data:`SPREAD_PERIODS` bound cannot all follow satellites (with
        RELOCK=0 a channel whose satellite has set keeps tracking noise):
        the weaker of the two outermost, by prompt magnitude, loses its
        lock (a ``lol`` event) and is moved as a lost one, until the
        others fit."""
        # a tracking block ran, so some channel is live (started)
        live, pos = self._live, self._pos
        moved = np.zeros(len(self.channels), np.int64)
        new = int(pos[live].min()) - self.lead
        wide = self.room - self.margin - self.lead
        if int(pos[live].max() - pos[live].min()) > wide:
            # (this block's collects may have unlocked every channel)
            locked = live & np.array([ch.locked for ch in self.channels])
            anchor = locked if locked.any() else live
            while int(pos[anchor].max() - pos[anchor].min()) > wide:
                idx = np.flatnonzero(anchor)
                ends = idx[[np.argmin(pos[idx]), np.argmax(pos[idx])]]
                drop = ends[int(self._prompt[ends[1]]
                                < self._prompt[ends[0]])]
                if self.channels[drop].locked:
                    self._reset_channel(self.channels[drop],
                                        self.base / self.spec.f_sf)
                anchor[drop] = False
            lo = int(pos[anchor].min())
            new = lo - self.lead
            out = live & ~anchor & ((pos < new + self.margin)
                                    | (pos > new + self.room - self.margin))
            moved[out] = -((pos[out] - lo) // self.nsamp)
            pos += moved * self.nsamp
            self._gen[out] += 1
        shift = new - self.origin
        self.state = self.trk.rebase(
            self.state, shift - moved * self.nsamp if moved.any() else shift)
        self.origin = new

    def _track_positions(self, upto: int | None = None) -> None:
        """Update the estimates from the collected blocks dispatched as the
        ``upto``-th or earlier (all of them by default), oldest first: each
        channel still on the same track (position generation unchanged)
        ends the block at its last window plus that period's length, and
        has run ``nsteps`` nominal periods in each block dispatched since.
        Whether a block was pipelined or not, its estimate is used after
        the same dispatches, so both modes place the same blocks."""
        while self._pos_pend and (upto is None
                                  or self._pos_pend[0][0] <= upto):
            ndisp, gen0, end, prompt = self._pos_pend.pop(0)
            same = self._live & (gen0 == self._gen)
            later = (self._ndisp - ndisp) * self.nsteps * self.nsamp
            self._pos[same] = end[same] + later
            self._prompt[same] = prompt[same]

    def _collect(self, getter, base: int, origin: int, ndisp: int,
                 gen0: np.ndarray, lock0: np.ndarray,
                 cnt0: np.ndarray) -> None:
        """The host work of the ``ndisp``-th block, under the span
        ``track.collect``: its telemetry (the engine's ``track.wait`` and
        ``track.unpack``), the position estimate, nav and observables,
        and the epochs (``obs.epoch``)."""
        sp = self.spans
        with sp("track.collect").at(ndisp):
            out = getter()
            self._pos_pend.append((
                ndisp, gen0,
                origin + out.loc[-1].astype(np.int64)
                + out.n[-1].astype(np.int64),
                np.median(np.abs(out.ip) + np.abs(out.qp), axis=0)))
            self._feed_nav_and_obs(out, cnt0, base, origin, lock0)
            with sp("obs.epoch"):
                self._emit_epochs()

    def _flush_blocks(self) -> None:
        pending, self._pending = self._pending, []
        for p in pending:
            self._collect(*p)

    def flush(self) -> None:
        """Apply in-flight searches, then finalize in-flight blocks and
        take their positions."""
        self._collect_acq(all_pending=True)
        self._flush_blocks()
        self._track_positions()

    def close(self) -> None:
        """Flush pending work, close the track logs and, when standalone,
        the hub's output files and servers."""
        self.flush()
        if self.standalone:
            self.hub.close()
        for lg in self.loggers.values():
            lg.close()
        self.loggers = {}

    def _summary(self, t_start: float, nblocks: int) -> dict:
        wall = time.time() - t_start
        return dict(
            samples=self.base, seconds=self.base / self.spec.f_sf,
            wall=wall, msps=self.base / 1e6 / max(wall, 1e-9),
            blocks=nblocks,
            locked=[ch.cfg.prn for ch in self.channels if ch.locked],
            decoded=[ch.cfg.prn for ch in self.channels if ch.nav.flagdec],
            epochs=self.epochs_written, ephs=self.ephs_written,
            stage_wall=dict(self.stage_wall), spans=self.spans.table(),
        )

    def request_stop(self) -> None:
        """Ask the run loop to stop at the next block boundary (signal /
        'q'-key safe: just sets a flag)."""
        self.stop_requested = True

    _finish = _summary

    def run_seconds(self, seconds: float | None = None,
                    progress=None) -> dict:
        """Process the stream (whole file by default) until its end or a
        :meth:`request_stop`; returns summary statistics.  ``progress``:
        optional callable(t_stream_seconds)."""
        t_start = time.time()
        end_sample = self.end_sample(seconds)
        nblocks = 0
        while not self.stop_requested and self.can_step(end_sample):
            self.step_block()
            nblocks += 1
            if progress:
                progress(self.base / self.spec.f_sf)
        self.flush()
        return self._summary(t_start, nblocks)

    def run_live(self, seconds: float | None = None, poll_s: float = 0.02,
                 progress=None) -> dict:
        """Stream from a live front end (a :class:`~..io.live.
        ProcessFrontend`, :class:`~..io.live.StreamFrontend` or a driver
        binding): step whenever the producer has written the next block,
        sleep-poll while it catches up (the reference's sleepms(1) wait,
        src/sdrtrk.c:30-50); stop at the producer's EOF (after the blocks
        a file of the same bytes would run), after ``seconds`` of stream
        time, or on :meth:`request_stop`.  The summary adds ``lag``: the
        largest distance in seconds between the producer and ``base``
        after a block."""
        return _run_live(self, [self], seconds, poll_s, progress)


def _run_live(rx, groups: list, seconds, poll_s: float, progress) -> dict:
    """The live loop of a :class:`Receiver` or a :class:`MultiReceiver`
    (``rx``) over its channel groups."""
    t_start = time.time()
    r0 = groups[0]
    target = None if seconds is None else int(seconds * r0.spec.f_sf)
    nblocks, lag = 0, 0.0
    while not rx.stop_requested:
        if target is not None and not all(r.can_step(target)
                                          for r in groups):
            break
        # EOF first: once it is seen, nsamples is the stream's length
        eof = [getattr(r.frontend, "eof", False) for r in groups]
        avail = [int(r.frontend.nsamples) for r in groups]
        ready = [r.can_step(n, final=e) for r, n, e in zip(groups, avail, eof)]
        if all(ready):
            rx.step_block()
            nblocks += 1
            lag = max(lag, max((int(r.frontend.nsamples) - r.base)
                               / r.spec.f_sf for r in groups))
            if progress:
                progress(r0.base / r0.spec.f_sf)
        elif any(e for e, ok in zip(eof, ready) if not ok):
            break
        else:
            time.sleep(poll_s)
    rx.flush()
    out = rx._finish(t_start, nblocks)
    out["lag"] = lag
    return out


class MultiReceiver:
    """Channel groups stepped in lockstep with one shared
    :class:`OutputHub`, so that common epochs hold every group's channels
    (the reference's one sync thread over all channel threads,
    src/sdrsync.c:49-135).  Groups come from RF paths (two front ends) and
    from loop cadences within a path (SBAS channels update every 2
    periods, GPS and GLONASS every 10; the FastTracker needs one).

    ``parts``: a list of (ftype, frontend, channels).  The groups of one
    front end share its device sample cache; each group captures its own
    block programs.  Every group's blocks must span the same stream time.
    Each group keeps the same number of blocks in flight and all of them
    step together, so after every lockstep step they have collected the
    same blocks; the hub then merges the epochs their histories cover.
    ``pipeline`` and ``mesh`` are every group's (:class:`Receiver`).  With
    SPEC, the groups of one front end share its one spectrum monitor (the
    first group's)."""

    def __init__(self, cfg: ReceiverConfig, parts: list, *, device,
                 nsteps_per_block: int = 400, pipeline: bool = True,
                 mesh=None):
        self.cfg = cfg
        self.hub = OutputHub(cfg)
        self.rx: list[Receiver] = []
        caches = {}
        try:
            for ft, fe, chans in parts:
                r = Receiver(cfg, fe, device=device, ftype=ft,
                             nsteps_per_block=nsteps_per_block, hub=self.hub,
                             standalone=False, channels=chans,
                             cache=caches.get(id(fe)), pipeline=pipeline,
                             mesh=mesh)
                if id(fe) in caches:
                    # one spectrum monitor per physical front end
                    r.spec_monitor = None
                caches.setdefault(id(fe), r.cache)
                self.rx.append(r)
            durations = {r.nsteps * r.nsamp / r.spec.f_sf for r in self.rx}
            if max(durations) - min(durations) > 1e-12:
                raise ValueError(f"group block durations differ "
                                 f"({sorted(durations)}); use code periods "
                                 "with equal duration across groups")
        except BaseException:
            self.hub.close()
            raise
        merged = self.channels
        for r in self.rx:
            r.peer_channels = merged

    @property
    def epochs_written(self) -> int:
        return self.hub.epochs_written

    @property
    def ephs_written(self) -> int:
        return self.hub.ephs_written

    @property
    def obs_writer(self):
        return self.hub.obs_writer

    @property
    def nav_writer(self):
        return self.hub.nav_writer

    @property
    def events(self) -> list:
        """Every group's events in stream-time order."""
        return sorted((e for r in self.rx for e in r.events),
                      key=lambda e: e[1])

    @property
    def channels(self) -> list[ChannelRuntime]:
        return [ch for r in self.rx for ch in r.channels]

    @property
    def timeline(self) -> dict:
        """Each milestone at its first group (wall seconds since the first
        group was built)."""
        t0 = self.rx[0].timeline["t0"]
        out = {"t0": t0}
        for r in self.rx:
            for k, v in r.timeline.items():
                if k != "t0":
                    v += r.timeline["t0"] - t0
                    out[k] = min(out.get(k, v), v)
        return out

    def save_checkpoint(self, path: str) -> None:
        """Every group's snapshot (after a flush), as a list."""
        self.flush()
        snaps = [r._snapshot() for r in self.rx]
        with open(path, "wb") as f:
            pickle.dump(snaps, f)

    def load_checkpoint(self, path: str) -> None:
        """Restore a :meth:`save_checkpoint` of the same config.  The file
        is unpickled: load only checkpoints this program wrote."""
        with open(path, "rb") as f:
            snaps = pickle.load(f)
        if len(snaps) != len(self.rx):
            raise ValueError(f"checkpoint has {len(snaps)} groups, the "
                             f"receiver {len(self.rx)}")
        for r, d in zip(self.rx, snaps):
            r._restore(d)

    def close(self) -> None:
        for r in self.rx:
            r.close()
        self.hub.close()

    @property
    def stop_requested(self) -> bool:
        return any(r.stop_requested for r in self.rx)

    def request_stop(self) -> None:
        for r in self.rx:
            r.request_stop()

    def _emit(self) -> None:
        """The merged epochs, timed as the first group's ``obs.epoch``
        outside its blocks (stage ``other``)."""
        with self.rx[0].spans("obs.epoch"):
            self.hub.emit_epochs(
                [ci for r in self.rx for ci in r.collect_obs_inputs()])

    def step_block(self) -> None:
        """One block of every group, then the epochs all of them cover."""
        for r in self.rx:
            r.step_block()
        self._emit()

    def flush(self) -> None:
        for r in self.rx:
            r.flush()
        self._emit()

    def run_seconds(self, seconds: float | None = None,
                    progress=None) -> dict:
        """Step every group until one reaches the end of its stream (whole
        file by default) or a :meth:`request_stop`; returns summary
        statistics, with ``stage_wall`` and the span table (``spans``)
        summed over the groups and ``groups`` holding each group's."""
        t_start = time.time()
        ends = [r.end_sample(seconds) for r in self.rx]
        nblocks = 0
        while not self.stop_requested and \
                all(r.can_step(e) for r, e in zip(self.rx, ends)):
            self.step_block()
            nblocks += 1
            if progress:
                progress(self.rx[0].base / self.rx[0].spec.f_sf)
        self.flush()
        return self._finish(t_start, nblocks)

    def run_live(self, seconds: float | None = None, poll_s: float = 0.02,
                 progress=None) -> dict:
        """Live lockstep (:meth:`Receiver.run_live` for every group): step
        all groups once every producer has written their next blocks;
        stop when a stream ends, after ``seconds`` or on
        :meth:`request_stop`."""
        return _run_live(self, self.rx, seconds, poll_s, progress)

    def _finish(self, t_start: float, nblocks: int) -> dict:
        wall = time.time() - t_start
        samples = sum(r.base for r in self.rx)
        groups = [r._summary(t_start, nblocks) for r in self.rx]
        return dict(
            samples=samples,
            seconds=self.rx[0].base / self.rx[0].spec.f_sf,
            wall=wall, msps=samples / 1e6 / max(wall, 1e-9),
            blocks=nblocks,
            locked=[p for g in groups for p in g["locked"]],
            decoded=[p for g in groups for p in g["decoded"]],
            epochs=self.hub.epochs_written, ephs=self.hub.ephs_written,
            stage_wall={k: sum(g["stage_wall"][k] for g in groups)
                        for k in groups[0]["stage_wall"]},
            spans=merge([g["spans"] for g in groups]), groups=groups)


class DualReceiver(MultiReceiver):
    """Both RF paths of a dual front end (FE1 + FE2), one group per path:
    the named two-path case of :class:`MultiReceiver`."""

    def __init__(self, cfg: ReceiverConfig, frontends: list, *, device,
                 nsteps_per_block: int = 400, mesh=None):
        ftypes = sorted({c.ftype for c in cfg.channels})
        if len(ftypes) < 2:
            raise ValueError("DualReceiver needs channels on two FTYPEs")
        parts = [(ft, fe, [c for c in cfg.channels if c.ftype == ft])
                 for ft, fe in zip(ftypes, frontends)]
        super().__init__(cfg, parts, device=device,
                         nsteps_per_block=nsteps_per_block, mesh=mesh)


def build_receiver(cfg: ReceiverConfig, frontends, *, device,
                   nsteps_per_block: int = 400, pipeline: bool = True,
                   mesh=None):
    """The receiver for ``cfg``: channels grouped by (RF path, loop
    cadence); a single group gets a plain :class:`Receiver`, several a
    :class:`MultiReceiver`, each with ``pipeline`` and ``mesh``.

    ``frontends``: a {ftype: frontend} dict, or a list paired with the
    configured FTYPEs in sorted order (a single frontend is accepted)."""
    if isinstance(frontends, dict):
        fmap = dict(frontends)
    else:
        if not isinstance(frontends, (list, tuple)):
            frontends = [frontends]
        fts = sorted({c.ftype for c in cfg.channels})[:len(frontends)]
        fmap = dict(zip(fts, frontends))
    parts = []
    for ft in sorted(fmap):
        by_loop = {}
        for c in cfg.channels:
            if c.ftype == ft:
                by_loop.setdefault(loop_interval(c.ctype), []).append(c)
        parts += [(ft, fmap[ft], grp) for _, grp in sorted(by_loop.items())]
    if not parts:
        raise ValueError("no channels on the given front ends")
    if len(parts) == 1:
        ft, fe, grp = parts[0]
        return Receiver(cfg, fe, device=device, ftype=ft,
                        nsteps_per_block=nsteps_per_block, channels=grp,
                        pipeline=pipeline, mesh=mesh)
    return MultiReceiver(cfg, parts, device=device,
                         nsteps_per_block=nsteps_per_block,
                         pipeline=pipeline, mesh=mesh)
