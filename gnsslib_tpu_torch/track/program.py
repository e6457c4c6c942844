"""One tracking block as one program over static buffers (the port's
counterpart of the JAX package's jitted block programs, ``Tracker._run``
and ``FastTracker._run``).

On a CUDA card a :class:`BlockProgram` is a CUDA graph captured from the
tracker's eager block body and replayed once per block; on the CPU the
same body runs eagerly over the same buffers, with the capture left out.
A program owns

* a static input state (a :class:`TrackState` of its own tensors) and a
  static sample block, into which :meth:`BlockProgram.load` copies the
  caller's state and block (one device-to-device copy of the block; the
  device cache's block stays the caller's, so acquisition reads it in
  stream order as before);
* the body: the engine's ``state_to_carry`` and eager ``run_steps`` (the
  plain version of the program, unchanged), which writes the block's end
  state back into the static state and its telemetry into static
  ``packf``/``packi`` buffers;
* on a card, the graph that one eager warm-up and one capture of the body
  give.  The warm-up fills what must not be filled inside a capture: the
  kernel libraries, the tap offsets' uploads, the cuBLAS handle.

:meth:`BlockProgram.take` hands back clones, so the state and telemetry a
caller holds never alias the program's buffers: the next block's load and
replay may overwrite them while earlier blocks are still in flight.  The
copies in and out are ~40 small launches per block, where the eager loop
makes ~250 per steady super-step and ~90 per pull-in period.

Launch counts: a capture records kernel nodes and launches nothing, so a
program takes the capture's increments back out of the wrappers' counters
(:mod:`gnsslib_tpu_torch.ops.kernels`) and adds them again on every
replay; a counter still counts the kernel's launches on the card.
:data:`CAPTURES` tallies the captures themselves.

A failed capture or replay raises; nothing falls back to the eager loop.
"""
from __future__ import annotations

import gc
import time
import weakref

import torch

from ..ops import kernels
from .state import STATE_FIELDS, TrackState

# the state fields a block changes (the others, dcarr_acq, flagsync,
# sync_offset and active, are set by the host between blocks)
CARRY_FIELDS = ("loc", "cnt", "remcode", "remcarr", "carr_nco", "carr_err",
                "freq_err", "code_nco", "code_err", "sum_i", "sum_q",
                "oldsum_i", "oldsum_q", "prev_i", "prev_q")


class CaptureStats:
    """Process-wide tally of block-program captures, beside the wrappers'
    launch counters: how many, the seconds spent recording bodies and
    instantiating graphs, and the device memory their pools reserved."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.captures = 0
        self.capture_s = 0.0
        self.instantiate_s = 0.0
        self.pool_bytes = 0


CAPTURES = CaptureStats()


def as_block(block: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Check a sample block — float32 (n,) real or (n, 2) stacked I/Q on
    the tracker's device — and return it contiguous."""
    if block.device != device:
        raise ValueError(f"block is on {block.device}, tracker on {device}")
    if block.dtype != torch.float32:
        raise TypeError(f"block must be float32, got {block.dtype}")
    return block.contiguous()


class BlockProgram:
    """``count`` loop steps of ``engine`` (periods of a :class:`Tracker`,
    super-steps of a :class:`FastTracker`) on blocks of ``block_shape``,
    over static buffers; captured on a card at construction.

    ``replays`` counts the blocks run; on a card ``launches`` holds the
    kernel launches of one replay ({counter name: {attribute: n}}),
    ``capture_s``/``instantiate_s`` the seconds spent recording the body
    and instantiating the graph, and ``pool_bytes`` the device memory the
    graph's private pool reserved."""

    def __init__(self, engine, count: int, block_shape):
        # a weak reference: the engine holds its programs, and a cycle
        # would leave a dropped engine's graph to the cyclic collector,
        # which may run inside another program's capture, where
        # destroying a graph is not permitted
        self.eng = weakref.proxy(engine)
        self.count = int(count)
        self.device = engine.device
        self._state = TrackState.init(engine.C, engine.cfg.ntaps,
                                      self.device)
        self._block = torch.zeros(tuple(block_shape), dtype=torch.float32,
                                  device=self.device)
        self._packf = self._packi = None
        self.graph = None
        self.launches = {}
        self.replays = 0
        self.capture_s = self.instantiate_s = 0.0
        self.pool_bytes = 0
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                self._capture()

    def _run(self, count: int):
        return self.eng.run_steps(self.eng.state_to_carry(self._state),
                                  self._block, count)

    def _body(self) -> None:
        carry, packf, packi = self._run(self.count)
        for k in CARRY_FIELDS:
            getattr(self._state, k).copy_(carry[k])
        if self._packf is None:                 # CPU: sized on first use
            self._packf = torch.empty_like(packf)
            self._packi = torch.empty_like(packi)
        self._packf.copy_(packf)
        self._packi.copy_(packi)

    def _capture(self) -> None:
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):           # the eager warm-up
            _, pf, pi = self._run(min(self.count, 2))
        cur.wait_stream(side)
        self._packf = torch.empty((self.count,) + tuple(pf.shape[1:]),
                                  dtype=pf.dtype, device=dev)
        self._packi = torch.empty((self.count,) + tuple(pi.shape[1:]),
                                  dtype=pi.dtype, device=dev)
        before = kernels.snapshot()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        # no cyclic collection inside the capture (torch.cuda.graph runs
        # one just before it): a graph or stream it would free there
        # invalidates the capture
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                reserved = torch.cuda.memory_reserved(dev)
                t0 = time.perf_counter()
                self._body()
                t1 = time.perf_counter()
        finally:
            if collecting:
                gc.enable()
        self.instantiate_s = time.perf_counter() - t1
        self.capture_s = t1 - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = kernels.since(before)
        kernels.restore(before)
        self.graph = graph
        CAPTURES.captures += 1
        CAPTURES.capture_s += self.capture_s
        CAPTURES.instantiate_s += self.instantiate_s
        CAPTURES.pool_bytes += self.pool_bytes

    # ------------------------------------------------------------------ #
    def load(self, state: TrackState, block: torch.Tensor) -> None:
        """Copy ``state`` and ``block`` into the static buffers."""
        if state.loc.device != self.device:
            raise ValueError(f"state is on {state.loc.device}, program on "
                             f"{self.device}")
        if block.shape != self._block.shape:
            raise ValueError(f"block shape {tuple(block.shape)} != the "
                             f"program's {tuple(self._block.shape)}")
        for k in STATE_FIELDS:
            getattr(self._state, k).copy_(getattr(state, k))
        self._block.copy_(block)

    def replay(self) -> None:
        """Run the body once on the static buffers: the graph's replay on
        a card (with its launches counted), the eager body on the CPU."""
        if self.graph is None:
            self._body()
        else:
            with torch.cuda.device(self.device):
                self.graph.replay()
            kernels.add(self.launches)
        self.replays += 1

    def outputs(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Clones of the last replay's (packf, packi)."""
        return self._packf.clone(), self._packi.clone()

    def take(self, template: TrackState):
        """(``template`` with the block's changed fields, as clones of the
        static state, and :meth:`outputs`)."""
        state = template.replace(**{k: getattr(self._state, k).clone()
                                    for k in CARRY_FIELDS})
        return state, self.outputs()

    def start(self, state: TrackState, block: torch.Tensor):
        """One block: load, replay, take -> (new_state, (packf, packi))."""
        self.load(state, block)
        self.replay()
        return self.take(state)


class BlockRunner:
    """The block entry points the trackers share.  An engine provides
    ``device``, ``C``, ``cfg``, ``state_to_carry``, ``carry_to_state``,
    ``run_steps(carry, block, count)``, ``run_block_collect(handle)`` and a
    ``programs`` dict, and may override :meth:`_count` and :meth:`_key`."""

    def _count(self, nsteps: int) -> int:
        """The ``run_steps`` count of ``nsteps`` code periods."""
        return int(nsteps)

    def _key(self) -> tuple:
        """What besides the count and block shape selects a program."""
        return ()

    def program(self, nsteps: int, block_shape) -> BlockProgram:
        """The program of ``nsteps``-period blocks of ``block_shape``:
        built (on a card: captured) on first use, reused after."""
        count = self._count(nsteps)
        key = self._key() + (count, tuple(block_shape))
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = BlockProgram(self, count,
                                                     block_shape)
        return prog

    def run_block(self, state: TrackState, block, nsteps: int):
        """Advance every active channel ``nsteps`` code periods through
        ``block`` -> (new_state, TrackOutputs)."""
        new_state, handle = self.run_block_start(state, block, nsteps)
        return new_state, self.run_block_collect(handle)

    def run_block_start(self, state: TrackState, block, nsteps: int):
        """Queue a block on the device without reading telemetry back:
        returns (new_state, handle) for ``run_block_collect``, so the
        receiver can queue later blocks before collecting this one.  Runs
        the block program (a graph replay on a card)."""
        block = as_block(block, self.device)
        return self.program(nsteps, block.shape).start(state, block)

    def run_block_eager(self, state: TrackState, block, nsteps: int):
        """The plain version of :meth:`run_block_start`: the eager loop on
        the caller's tensors, no static buffers, no graph."""
        block = as_block(block, self.device)
        carry, packf, packi = self.run_steps(self.state_to_carry(state),
                                             block, self._count(nsteps))
        return self.carry_to_state(carry, state), (packf, packi)
