"""Host spans of the receiver's block loop and device times by CUDA events.

Each :class:`~.receiver.Receiver` owns one :class:`SpanTable`
(``rx.spans``).  A span is a named region of the receiver's host work,
opened with ``with table("nav"):``; it records its count, its total host
seconds (``time.perf_counter``) and the span it ran in (its parent), so a
span's self time is its total minus what its children cover.  Totals are
kept per stage:

* ``acquire``, ``pullin``, ``steady``: the stage of the ``step_block``
  call the span ran in, decided when that call ends (a pipelined collect
  runs under the ``step_block`` that executes it).  The ``step_block``
  span itself is each stage's top level, and its totals are the
  receiver's ``stage_wall``;
* ``other``: work outside any ``step_block`` of the group (the final
  :meth:`~.receiver.Receiver.flush`, a multi-group receiver's merged
  epochs);
* ``build``: the receiver's construction and the split of its block
  programs' warm-up, capture and instantiation (``build.*``).

Device times (``dev.*``) come from a pair of CUDA events around the work
(:class:`DeviceTimer`), read once the work's results are on the host, so
reading them waits for nothing; they exist only on a card.  The same end
event is what a collect waits on (:func:`wait`): a handle's results are
copied to the host in stream order before it (:func:`host_copy`), so the
host waits for that work alone and never for the whole stream.  A
``*.ready`` count (``track.ready``, ``acq.ready``) beside each ``*.wait``
span counts the collects whose work had already run when they began:
every collect on the CPU, on a card the share the host did not wait for.

While a ``torch.profiler`` records, each span also opens a
``record_function`` range ``gnss.<name>``, so a trace carries the spans on
the kernels' clock.  A block's ranges carry its dispatch number after a
``#`` (``gnss.step_block#12``, ``gnss.track.collect#10``): the trace's
export drops a range's argument string.  With no profiler, a span costs
two ``perf_counter`` calls and a few adds into slots allocated with it.
"""
from __future__ import annotations

import time

import torch
from torch.autograd import profiler as _autograd_profiler

STAGES = ("acquire", "pullin", "steady", "other", "build")
_INDEX = {s: i for i, s in enumerate(STAGES)}
_OTHER = _INDEX["other"]
_OPEN = len(STAGES)        # the open step_block's slot, folded at its end
_SLOTS = len(STAGES) + 1
PREFIX = "gnss."
STEP = "step_block"
READY = ".ready"
# what SBAS channels add: each FEC predecode with its preamble and CRC-24Q
# check (a child of ``nav``), each message's NovAtel frame and send (a
# child of ``track.collect``), and the counts of messages sent and of
# preamble matches whose CRC failed
FEC = "nav.fec"
SBAS_SEND = "sbas.send"
SBAS_COUNTERS = ("sbas.frames", "sbas.crc_fail")

_perf = time.perf_counter


class Span:
    """One named span of a :class:`SpanTable`, entered again by name (never
    inside itself): counts, totals, children's totals and parent per stage
    slot."""

    __slots__ = ("name", "tab", "n", "s", "child", "parent", "t0", "up",
                 "num", "rf")

    def __init__(self, tab: "SpanTable", name: str | None):
        self.name = name
        self.tab = tab
        self.n = [0] * _SLOTS
        self.s = [0.0] * _SLOTS
        self.child = [0.0] * _SLOTS
        self.parent = [None] * _SLOTS
        self.t0 = 0.0
        self.up = None
        self.num = None
        self.rf = None

    def at(self, num: int) -> "Span":
        """This span, its next profiler range labelled with block ``num``."""
        self.num = num
        return self

    def __enter__(self) -> "Span":
        tab = self.tab
        self.up = tab.open
        tab.open = self
        if _autograd_profiler._is_profiler_enabled:
            label = PREFIX + self.name
            if self.num is not None:
                label += f"#{self.num}"
            self.rf = torch.profiler.record_function(label)
            self.rf.__enter__()
        self.t0 = _perf()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        dt = _perf() - self.t0
        tab = self.tab
        k = tab.slot
        self.n[k] += 1
        self.s[k] += dt
        up = self.up
        up.child[k] += dt
        self.parent[k] = up.name
        tab.open = up
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        return False


class _Step:
    """The ``step_block`` span of a table: on exit its slot folds into the
    stage the block ran (``tab.stage``), and its wall into ``stage_wall``."""

    __slots__ = ("tab",)

    def __init__(self, tab: "SpanTable"):
        self.tab = tab

    def __enter__(self) -> "_Step":
        tab = self.tab
        tab.slot = _OPEN
        tab.stage = None
        tab.step_span.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        tab = self.tab
        sp = tab.step_span
        sp.__exit__(*exc)
        # a block that raised before choosing its stage counts as other
        stage = tab.stage or "other"
        if stage in tab.stage_wall:
            tab.stage_wall[stage] += sp.s[_OPEN]
        tab._fold(_INDEX[stage])
        tab.slot = _OTHER
        return False


class SpanTable:
    """The spans of one receiver (see the module's docstring).

    ``table(name)`` is the span ``name``, made on first use;
    ``step(num)`` is the ``step_block`` span of block ``num``, whose
    stage the caller sets in ``stage`` before it ends; :meth:`add` adds
    a measured time (a device time, a build split) to a stage.
    ``stage_wall`` is the dict of stage walls the receiver exposes;
    :meth:`count` adds to a counter of ``counters``."""

    def __init__(self) -> None:
        self.stage_wall = {"acquire": 0.0, "pullin": 0.0, "steady": 0.0}
        self.counters = {}
        self._spans = {}
        self.root = Span(self, None)
        self.open = self.root
        self.slot = _OTHER
        self.stage = None
        self.step_span = self(STEP)
        self._step = _Step(self)

    def __call__(self, name: str) -> Span:
        sp = self._spans.get(name)
        if sp is None:
            sp = self._spans[name] = Span(self, name)
        return sp

    def step(self, num: int) -> _Step:
        self.step_span.num = num
        return self._step

    def _fold(self, k: int) -> None:
        for sp in self._spans.values():
            if sp.n[_OPEN]:
                sp.n[k] += sp.n[_OPEN]
                sp.s[k] += sp.s[_OPEN]
                sp.parent[k] = sp.parent[_OPEN]
                sp.n[_OPEN] = 0
                sp.s[_OPEN] = 0.0
            if sp.child[_OPEN]:
                sp.child[k] += sp.child[_OPEN]
                sp.child[_OPEN] = 0.0
        self.root.child[_OPEN] = 0.0

    def add(self, name: str, stage: str | None, seconds: float, n: int = 1,
            parent: str | None = None) -> None:
        """Add ``n`` counts and ``seconds`` to span ``name`` in ``stage``
        (None: the current one) with ``parent``, whose children's total
        it joins."""
        k = self.slot if stage is None else _INDEX[stage]
        sp = self(name)
        sp.n[k] += n
        sp.s[k] += seconds
        if sp.parent[k] is None:
            sp.parent[k] = parent
        if parent is not None:
            self(parent).child[k] += seconds

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def table(self) -> dict:
        """{"stages": {stage: {span: {"n", "s", "self_s", "parent"}}},
        "counters": {...}}: plain numbers, every stage with a count."""
        out = {}
        for st, k in _INDEX.items():
            rows = {name: dict(n=sp.n[k], s=sp.s[k],
                               self_s=sp.s[k] - sp.child[k],
                               parent=sp.parent[k])
                    for name, sp in self._spans.items() if sp.n[k]}
            if rows:
                out[st] = rows
        return dict(stages=out, counters=dict(self.counters))


def merge(tables: list) -> dict:
    """Span tables (:meth:`SpanTable.table`) summed: a multi-group
    receiver's."""
    stages, counters = {}, {}
    for t in tables:
        for st, rows in t["stages"].items():
            dst = stages.setdefault(st, {})
            for name, r in rows.items():
                d = dst.setdefault(name, dict(n=0, s=0.0, self_s=0.0,
                                              parent=r["parent"]))
                for key in ("n", "s", "self_s"):
                    d[key] += r[key]
        for key, v in t["counters"].items():
            counters[key] = counters.get(key, 0) + v
    return dict(stages=stages, counters=counters)


def ready_of(rows: dict, name: str) -> tuple[int, int] | None:
    """(ready, collects) of one stage's rows (:meth:`SpanTable.table`)
    when ``name`` is a ``*.ready`` count, the collects being its
    ``*.wait`` span's count; else None."""
    if not name.endswith(READY):
        return None
    wait = rows.get(name[:-len(READY)] + ".wait")
    return rows[name]["n"], (wait["n"] if wait else rows[name]["n"])


def split_line(table: dict, stage: str = "steady") -> str:
    """One line of ``stage``'s spans by total, each with its self time
    where it has children: ms per block where the stage has blocks, else
    ms in all; a ``*.ready`` count as ready/collects; then the SBAS
    counters of the table where it has them (the whole run's)."""
    rows = table["stages"].get(stage)
    if not rows:
        return f"{stage}: nothing"
    nb = rows[STEP]["n"] if STEP in rows else 0
    parts = []
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["s"]):
        ready = ready_of(rows, name)
        if ready is not None:
            parts.append(f"{name} {ready[0]}/{ready[1]}")
            continue
        ms = 1e3 * r["s"] / max(nb, 1)
        self_ms = 1e3 * r["self_s"] / max(nb, 1)
        parts.append(f"{name} {ms:.2f}" if abs(ms - self_ms) < 5e-3 else
                     f"{name} {ms:.2f} (self {self_ms:.2f})")
    head = f"ms per block of {nb}" if nb else "ms"
    parts += [f"{k} {table['counters'][k]}" for k in SBAS_COUNTERS
              if k in table["counters"]]
    return f"{stage}, {head}: " + ", ".join(parts)


class _NullSpan:
    __slots__ = ()

    def at(self, num: int) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


class _NullTable:
    """The table of an engine outside a receiver: records nothing."""

    _span = _NullSpan()

    def __call__(self, name: str) -> _NullSpan:
        return self._span

    def add(self, *args, **kwargs) -> None:
        pass

    def count(self, name: str, n: int = 1) -> None:
        pass


NULL = _NullTable()


class DeviceTimer:
    """A pair of timing CUDA events on ``device``'s current stream around
    work queued there: the first recorded at construction, the second by
    :meth:`stop`; :meth:`seconds` reads the time between them once the
    work has finished, and waits for nothing (None while it has not)."""

    __slots__ = ("a", "b", "stream")

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.current_stream(device)
        self.a = torch.cuda.Event(enable_timing=True)
        self.b = torch.cuda.Event(enable_timing=True)
        self.a.record(self.stream)

    @classmethod
    def start(cls, device: torch.device) -> "DeviceTimer | None":
        """A started timer on a card, None elsewhere."""
        return cls(device) if device.type == "cuda" else None

    def stop(self) -> None:
        self.b.record(self.stream)

    def seconds(self) -> float | None:
        if not self.b.query():
            return None
        return 1e-3 * self.a.elapsed_time(self.b)


class Timed(tuple):
    """A handle of queued device work (a tuple, unpacked as before) that
    carries its :class:`DeviceTimer` in ``timer``."""

    timer = None


def timed(values, timer: DeviceTimer | None) -> tuple:
    """``values`` as a handle: with ``timer`` (stopped here) a
    :class:`Timed`, else a plain tuple."""
    if timer is None:
        return tuple(values)
    timer.stop()
    h = Timed(values)
    h.timer = timer
    return h


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` on the host.  From a card the copy goes into
    page-locked memory and is only queued on the current stream: read it
    after :func:`wait` on a :func:`timed` handle stopped after it.  The
    caching host allocator keeps the buffer from reuse until the copy has
    run, however early the caller drops it."""
    if t.device.type != "cuda":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def wait(handle) -> bool:
    """Wait until a :func:`timed` handle's work has run (its timer's end
    event), not for the work queued after it; returns whether it had run
    already.  A handle with no timer (on the CPU) always has."""
    timer = getattr(handle, "timer", None)
    if timer is None or timer.b.query():
        return True
    timer.b.synchronize()
    return False


def device_seconds(handle) -> float | None:
    """The device seconds a :func:`timed` handle's work took, or None (no
    timer, or the work not finished)."""
    timer = getattr(handle, "timer", None)
    return None if timer is None else timer.seconds()
