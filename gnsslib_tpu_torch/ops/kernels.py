"""What the wrappers of the port's CUDA kernels share: launch counters,
argument checks, the tap-offset progression test, the tap-offset upload
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

MAX_TAPS = 25      # templated tap counts 1, 3, ..., 25 in every csrc/*.cu


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
    """The tap offsets as a tuple of ints: an odd count of at most
    ``MAX_TAPS``, each within ``[-smax, smax]``."""
    offsets = tuple(int(o) for o in offsets)
    if len(offsets) % 2 == 0 or len(offsets) > MAX_TAPS or \
            max(abs(o) for o in offsets) > smax:
        raise ValueError(f"{op}: need an odd tap count <= {MAX_TAPS} "
                         f"with |offset| <= smax={smax}, got {offsets}")
    return offsets


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
