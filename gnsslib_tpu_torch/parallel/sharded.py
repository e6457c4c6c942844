"""Channel- and Doppler-sharded tracking and acquisition (port of
:mod:`gnsslib_tpu.parallel.sharded`).

Each shard of a :class:`~.mesh.Mesh` runs the unchanged single-device
engine on its contiguous slice of the channel axis: a
:class:`~..track.loop.Tracker`, :class:`~..track.fast.FastTracker` or
:class:`~..acquire.search.Acquirer` of the parent's constants for those
channels (``shard``), on the shard's device, with block programs of its
own (on a card, each shard's block is its own CUDA graph replay).  There
are no collectives in the compute path: channels are independent, and the
IF block is the same for every shard (the reference's shared ring
buffer).  The receiver's global :class:`~..track.state.TrackState` stays on
its device: a block hands each shard its channel rows (views on the same
device, a copy only to another device) and joins the shards' new rows;
the shards' telemetry is joined on the host in channel order (the
observable fan-in of src/sdrsync.c:51-62).

Across processes (:mod:`.distributed`) each process runs only its own
shards; the telemetry and the acquisition decisions are all-gathered on
the host, so that every process holds every channel's, while the rows of
another process's channels in a process's global state stay as they were
(nothing on the host reads them: :meth:`Receiver._snapshot` refuses).
The JAX package pads the channel axis to equal shards for ``shard_map``;
shards here are simply uneven, and the outputs are the same.
"""
from __future__ import annotations

import torch

from ..acquire.search import Acquirer, AcqResult
from ..spans import wait
from ..track.fast import FastTracker
from ..track.loop import Tracker, TrackOutputs
from ..track.program import CARRY_FIELDS
from ..track.state import STATE_FIELDS, TrackState
from . import distributed
from .mesh import Mesh


# the dtypes of the decision vectors (codei, freqi, cn0, peakr, confirmed)
_DECISION_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32,
                   torch.bool)


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")


def _rows(state: TrackState, a: int, b: int, device) -> TrackState:
    """Channels [a, b) of ``state`` on ``device`` (views when it is the
    state's device)."""
    return TrackState(**{k: getattr(state, k)[a:b].to(device)
                         for k in STATE_FIELDS})


class _ChannelShards:
    """What the channel-sharded trackers share: the mesh's channel ranges,
    this process's shard engines, the block split and join, and the
    telemetry's fan-in (``eng``: the wrapped engine, whose telemetry
    layout the shards' is)."""

    def _setup(self, trk: Tracker, eng, mesh: Mesh, axis: str,
               make) -> None:
        _check_axis(mesh, axis)
        self.trk = trk
        self._eng = eng
        self.mesh = mesh
        self.axis = axis
        self.C = trk.C
        self.device = trk.device
        self.cfg = trk.cfg
        self.ranges = mesh.ranges(trk.C)
        # (start, stop, engine) of this process's shards
        self.shards = [(a, b, make(a, b, mesh.devices[i]))
                       for i, a, b in mesh.local(trk.C)]
        self._counts = [sum(b - a for i, a, b in self.ranges
                            if mesh.owners[i] == p)
                        for p in range(mesh.nproc)]
        self._dispatched = 0             # blocks started, numbering handles

    # pass-throughs -------------------------------------------------------- #
    def init_state(self) -> TrackState:
        return self.trk.init_state()

    def rebase(self, state, advance):
        return self.trk.rebase(state, advance)

    # sharded execution ---------------------------------------------------- #
    def program(self, nsteps: int, block_shape) -> list:
        """Every local shard's block program (built, on a card captured,
        on first use)."""
        return [e.program(nsteps, block_shape) for _, _, e in self.shards]

    def _prepare(self) -> None:
        """Hook run before a block's shards (the fast path syncs corr)."""

    def run_block_start(self, state: TrackState, block, nsteps: int):
        """Queue the block on every local shard: (the joined new state,
        the handle: the block's number, ``nsteps`` and the shards'
        handles).  Another process's channels keep their rows."""
        self._prepare()
        local = {a: (b, e) for a, b, e in self.shards}
        dev = state.loc.device
        pieces, handles = [], []
        for _, a, b in self.ranges:
            if a not in local:
                pieces.append((a, b, None))
                continue
            e = local[a][1]
            st, h = e.run_block_start(_rows(state, a, b, e.device),
                                      block.to(e.device), nsteps)
            pieces.append((a, b, st))
            handles.append(h)
        joined = {k: torch.cat([getattr(state, k)[a:b] if s is None
                                else getattr(s, k).to(dev)
                                for a, b, s in pieces])
                  for k in CARRY_FIELDS}
        self._dispatched += 1
        return state.replace(**joined), (self._dispatched, nsteps, handles)

    def _gather(self, handle, kind: str):
        """The shards' (packf, packi) on the host once each has run,
        joined along the channel axis (dim 1) in channel order, every
        process's (each process must collect the same block: its number
        is in the tag).  A process that runs none of the channels gives
        none."""
        n, nsteps, handles = handle
        for h in handles:
            wait(h)
        if handles:
            packf = torch.cat([h[0] for h in handles], dim=1)
            packi = torch.cat([h[1] for h in handles], dim=1)
        else:
            nf, ni = self._eng.pack_widths()
            steps = self._eng._count(nsteps)
            packf = torch.zeros((steps, 0, nf), dtype=torch.float32)
            packi = torch.zeros((steps, 0, ni), dtype=torch.int32)
        return tuple(distributed.allgather(
            [packf, packi], self._counts, 1,
            f"{kind} of {self.C} channels, block {n}"))

    def run_block(self, state: TrackState, block, nsteps: int):
        state, handle = self.run_block_start(state, block, nsteps)
        return state, self.run_block_collect(handle)


class ShardedTracker(_ChannelShards):
    """Wraps a :class:`Tracker`: one shard tracker per local shard of the
    mesh's channel axis, the sample block replicated, telemetry joined in
    channel order."""

    def __init__(self, tracker: Tracker, mesh: Mesh, axis: str = "ch"):
        self._setup(tracker, tracker, mesh, axis,
                    lambda a, b, dev: tracker.shard(slice(a, b), dev))

    def start_channels(self, state, idx, loc, dcarr):
        return self.trk.start_channels(state, idx, loc, dcarr)

    def set_bit_sync(self, state, ch, sync_offset):
        return self.trk.set_bit_sync(state, ch, sync_offset)

    def run_block_collect(self, handle) -> TrackOutputs:
        return self.trk.run_block_collect(self._gather(handle, "track"))


class ShardedFastTracker(_ChannelShards):
    """Channel-sharded steady-state fast path: wraps a
    :class:`FastTracker` as :class:`ShardedTracker` wraps the per-period
    loop.  Each shard runs the wrapped engine's correlator backend
    (``fast.corr``, read at every block: never downgraded, and the
    caller's engine is never written) on its own C_shard x L windows; the
    pipelined ``run_block_start``/``run_block_collect`` API is kept."""

    def __init__(self, fast: FastTracker, mesh: Mesh, axis: str = "ch"):
        self.fast = fast
        self.L = fast.L
        self._setup(fast.trk, fast, mesh, axis,
                    lambda a, b, dev: fast.shard(
                        slice(a, b), fast.trk.shard(slice(a, b), dev)))

    def _prepare(self) -> None:
        for _, _, e in self.shards:
            e.corr = self.fast.corr

    def program(self, nsteps: int, block_shape) -> list:
        self._prepare()
        return super().program(nsteps, block_shape)

    def run_block_start(self, state: TrackState, block, nsteps: int):
        if nsteps % self.L:
            raise ValueError(f"nsteps must be a multiple of L={self.L}")
        return super().run_block_start(state, block, nsteps)

    def run_block_collect(self, handle) -> TrackOutputs:
        return self.fast.run_block_collect(self._gather(handle, "fast"))


class ShardedAcquirer:
    """Mesh-sharded acquisition over the (channels x Doppler) cold-start
    grid of SURVEY.md §2.4, with the JAX package's choice of axis:

    * ``C >= shards`` (or several processes): channel mode, each shard
      searches its channels over the full Doppler grid (no collectives;
      across processes the decisions are all-gathered);
    * ``C < shards`` in one process: Doppler mode, the power stage of each
      shard covers its contiguous slice of the grid, the (C, 2, F,
      nsamp_d) surface is joined on the receiver's device, and the
      unchanged decision stage runs once on it (src/sdrcmn.c:738-773:
      nfreq x intg rounds, shardable along either axis).

    Every channel is searched at each call (the JAX mesh receiver's
    search); with ``diag`` the power surface comes back on the
    acquirer's device in one process."""

    def __init__(self, acq: Acquirer, mesh: Mesh, axis: str = "ch",
                 mode: str | None = None):
        _check_axis(mesh, axis)
        self.acq = acq
        self.mesh = mesh
        self.axis = axis
        if mode is None:
            mode = "freq" if acq.C < mesh.size and mesh.nproc == 1 else "ch"
        if mode not in ("ch", "freq"):
            raise ValueError(f"mode={mode!r}: expected 'ch' or 'freq'")
        if mode == "freq" and mesh.nproc > 1:
            raise ValueError("freq mode joins every shard's surface in one "
                             "process; a multi-process mesh takes mode='ch'")
        self.mode = mode
        if mode == "freq":
            d_cps = acq._consts["d_cps"]
            self.ranges = mesh.ranges(acq.nfreq)
            self.shards = []
            for i, a, b in self.ranges:
                dev = mesh.devices[i]
                consts = {k: v.to(dev) for k, v in acq._consts.items()}
                consts["d_cps"] = d_cps[a:b].to(dev)
                self.shards.append((a, b, dev, consts))
            return
        self.ranges = mesh.ranges(acq.C)
        self.shards = [(a, b, acq.shard(slice(a, b), mesh.devices[i]))
                       for i, a, b in mesh.local(acq.C)]
        self._counts = [sum(b - a for i, a, b in self.ranges
                            if mesh.owners[i] == p)
                        for p in range(mesh.nproc)]
        self._searches = 0

    def _search(self, rounds: torch.Tensor, diag: bool) -> AcqResult:
        acq = self.acq
        P = None
        if self.mode == "freq":
            Ph = torch.cat([acq._power_impl(rounds.to(dev), consts).to(
                acq.device) for _, _, dev, consts in self.shards], dim=2)
            P, *vecs = acq._decide_impl(rounds, acq._consts, Ph)
            vecs = [v.cpu() for v in vecs]
        else:
            outs = [s._search_rounds(rounds.to(s.device), s._consts)
                    for _, _, s in self.shards]
            if diag and self.mesh.nproc == 1:
                P = torch.cat([o[0].to(acq.device) for o in outs])
            # a process that runs none of the channels gives none
            vecs = [torch.cat([o[k].cpu() for o in outs]) if outs
                    else torch.zeros(0, dtype=dt)
                    for k, dt in enumerate(_DECISION_DTYPES, 1)]
            self._searches += 1
            vecs = distributed.allgather(
                vecs, self._counts, 0,
                f"search of {acq.C} channels, {self._searches}")
        res = acq.postprocess(*[v.numpy() for v in vecs])
        res.P = P if diag else None
        return res

    def search_dev(self, block: torch.Tensor,
                   diag: bool = False) -> AcqResult:
        """Search every channel in a device block (the first
        (intg+1)*nsamp samples are read)."""
        return self._search(self.acq._rounds_from_flat(block), diag)

    def search(self, data) -> AcqResult:
        """Full acquisition over (intg+1) ms of host samples."""
        rounds = torch.from_numpy(self.acq.stack_rounds(data)).to(
            self.acq.device)
        return self._search(rounds, False)
