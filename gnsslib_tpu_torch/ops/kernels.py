"""What the wrappers of the port's CUDA kernels share: launch counters,
argument checks, the tap-offset progression test, the split of a wide tap
set into launches of the instantiated tap counts, the tap-offset upload
and the ctypes binding.

Every wrapper launches its kernel for CUDA tensors and hands CPU tensors to
its plain PyTorch version; a failed build or launch raises, and nothing
falls back from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .correlator import tap_offsets

# the tap counts 1, 3, ..., 25 every csrc/*.cu instantiates; K1 takes any
# odd count in one launch (its wide kernel), K2-K5 more than 25 in
# launches of at most 25 (tap_plan), K6 at most 25
MAX_TAPS = 25


class LaunchCounts:
    """Plain-int counters of one wrapper: kernel launches it made, and the
    CPU tensors it handed to the plain version.  Every instance is listed
    in :data:`REGISTRY` under its ``name``, so that a program captured in
    a CUDA graph can count each replay's launches (:func:`snapshot`,
    :func:`restore`, :func:`add`)."""

    def __init__(self, name: str) -> None:
        if name in REGISTRY:
            raise ValueError(f"launch counter {name!r} exists")
        self.name = name
        self.reset()
        REGISTRY[name] = self

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0

    def values(self) -> dict:
        """The counters by attribute (``kernel``, ``plain``, ...)."""
        return {k: v for k, v in vars(self).items() if k != "name"}


class V1Counts(LaunchCounts):
    """The counters of a wrapper with two kernels: redesigned-kernel
    launches (``kernel``), launches of its first kernel, which takes the
    arguments the redesign does not (``v1``), and CPU calls of the plain
    version (``plain``)."""

    def reset(self) -> None:
        super().reset()
        self.v1 = 0


REGISTRY: dict[str, LaunchCounts] = {}


def snapshot() -> dict:
    """Every wrapper's counters: {name: {attribute: count}}."""
    return {name: c.values() for name, c in REGISTRY.items()}


def since(before: dict) -> dict:
    """The counts added since ``before`` (a :func:`snapshot`), nonzero
    ones only: {name: {attribute: added}}."""
    out = {}
    for name, now in snapshot().items():
        d = {k: v - before.get(name, {}).get(k, 0) for k, v in now.items()}
        d = {k: v for k, v in d.items() if v}
        if d:
            out[name] = d
    return out


def restore(before: dict) -> None:
    """Set every counter back to a :func:`snapshot`."""
    for name, vals in before.items():
        for k, v in vals.items():
            setattr(REGISTRY[name], k, v)


def add(added: dict) -> None:
    """Add counts of the form :func:`since` returns."""
    for name, vals in added.items():
        c = REGISTRY[name]
        for k, v in vals.items():
            setattr(c, k, getattr(c, k) + v)


def check_offsets(op: str, offsets, smax: int) -> tuple:
    """The tap offsets as a tuple of ints: an odd count, each within
    ``[-smax, smax]`` (any count: K6's kernel route checks its cap)."""
    offsets = tuple(int(o) for o in offsets)
    if len(offsets) % 2 == 0 or max(abs(o) for o in offsets) > smax:
        raise ValueError(f"{op}: need an odd tap count with |offset| <= "
                         f"smax={smax}, got {offsets}")
    return offsets


@functools.lru_cache(maxsize=64)
def tap_groups(ntaps: int) -> tuple:
    """Odd group sizes of at most ``MAX_TAPS`` that add up to the odd
    ``ntaps``: ``(ntaps,)`` up to ``MAX_TAPS``, else the fewest groups (an
    odd number of odd sizes adds up to an odd count) as even as they
    can be, e.g. 33 -> (11, 11, 11), 41 -> (15, 13, 13)."""
    k = -(-ntaps // MAX_TAPS)
    k += 1 - k % 2
    q = ntaps // k
    q -= 1 - q % 2                       # the largest odd size <= ntaps / k
    sizes = [q] * k
    for i in range((ntaps - k * q) // 2):
        sizes[i] += 2
    return tuple(sizes)


@functools.lru_cache(maxsize=64)
def tap_plan(offsets: tuple, d) -> tuple:
    """How a kernel instantiated up to ``MAX_TAPS`` taps computes all of
    ``offsets``: one launch per group of :func:`tap_groups`, as a tuple of
    (the launch's offsets, its smax shift, the output taps it fills).

    ``d`` None (any offsets): runs of ``offsets`` in their order, shift 0.
    ``d`` an int (``offsets == tap_offsets(corrn, d)``, the kernels that
    reuse replica values across a progression): runs of consecutive lags,
    each ``tap_offsets(c, d)`` about its centre offset ``shift``; the
    kernel called with ``smax + shift`` reads the replica bytes of
    ``shift + tap_offsets(c, d)``.  Up to ``MAX_TAPS`` taps the plan is
    the one launch ``(offsets, 0, range(T))``."""
    T = len(offsets)
    plan, t0 = [], 0
    for g in tap_groups(T):
        if d is None:
            plan.append((offsets[t0:t0 + g], 0, tuple(range(t0, t0 + g))))
        else:
            c = (g - 1) // 2
            shift = (t0 + c - (T - 1) // 2) * d   # t0: the run's first lag
            offs = tuple(int(o) for o in tap_offsets(c, d))
            plan.append((offs, shift,
                         tuple(offsets.index(shift + o) for o in offs)))
        t0 += g
    return tuple(plan)


def run_plan(plan: tuple, out: torch.Tensor, smax: int, launch) -> None:
    """Fill ``out`` (B, 2T) f32, tap t's pair in columns 2t and 2t+1, by
    ``launch(offsets, smax, dst)`` for each group of ``plan``
    (:func:`tap_plan`): one launch straight into ``out`` for a plan of one
    group, else each group into a scratch (B, 2G) and its pairs copied to
    their taps."""
    if len(plan) == 1:
        launch(plan[0][0], smax, out)
        return
    B, T = out.shape[0], out.shape[1] // 2
    taps = out.view(B, T, 2)
    for offs, shift, cols in plan:
        dst = torch.empty((B, 2 * len(offs)), dtype=out.dtype,
                          device=out.device)
        launch(offs, smax + shift, dst)
        taps.index_copy_(1, device_index(cols, out.device),
                         dst.view(B, len(offs), 2))


@functools.lru_cache(maxsize=64)
def progression(offsets: tuple):
    """The step d when ``offsets`` is ``tap_offsets((T - 1) // 2, d)`` with
    d >= 1 (d = 1 for the single tap ``(0,)``), else None: the offsets the
    kernels that reuse replica values across taps take (K1, K3-K5)."""
    c = (len(offsets) - 1) // 2
    d = offsets[2] if c else 1
    if d >= 1 and offsets == tuple(int(o) for o in tap_offsets(c, d)):
        return d
    return None


def check_tensors(op: str, device: torch.device, want) -> None:
    """Raise unless each ``(name, tensor, dtype, shape or None)`` of
    ``want`` is a contiguous tensor of that dtype (and shape) on
    ``device``."""
    for name, t, dtype, shape in want:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{op}: {name} must be a tensor")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, expected "
                             f"{device}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{op}: {name} shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def route(op: str, device: torch.device) -> str:
    """``"plain"`` for the CPU, ``"kernel"`` for CUDA; raises otherwise."""
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda":
        return "kernel"
    raise ValueError(f"{op}: unsupported device {device}")


@functools.lru_cache(maxsize=64)
def device_offsets(offsets: tuple, device: torch.device) -> torch.Tensor:
    """The tap offsets as an int32 tensor on ``device``, uploaded once."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=64)
def device_index(index: tuple, device: torch.device) -> torch.Tensor:
    """An int64 index tensor on ``device``, uploaded once (so that a
    launch captured in a CUDA graph after its warm-up uploads nothing)."""
    return torch.tensor(index, dtype=torch.int64, device=device)


def bind(name: str, fn: str, argtypes) -> ctypes.CDLL:
    """Build (first use) and load ``csrc/<name>.cu``, and declare its
    launch function ``fn`` (returns a cudaError_t as int) and
    ``<name>_error_string``."""
    from .. import cuda_build
    lib = cuda_build.load(name)
    getattr(lib, fn).argtypes = list(argtypes)
    getattr(lib, fn).restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def raise_on(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {err})")


def stream_of(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a Python int."""
    return torch.cuda.current_stream(device).cuda_stream
