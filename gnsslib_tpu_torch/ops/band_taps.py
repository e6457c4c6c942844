"""All-tap correlation of one steady-state super-step (kernel K1).

Counterpart of ``FastTracker._taps_band`` in :mod:`gnsslib_tpu.track.fast`
and the Pallas kernel it calls, ``gram_usum_band_impl``
(gnsslib_tpu/ops/pallas_gram.py).  For every window b of the super-step:

    ph(i)    = frac(frac(ftot_b * i) + rem_b)
    cos_t[b] = sum_{i < n_b} x[wstart_b + i] cos(2 pi ph(i))
                             * rc[b, i + smax + o_t]
    sin_t[b] = the same with sin; I/Q input mixes (xr + j xi) e^{+j 2 pi ph}

returned as (B, 2T) float32 interleaved [cos_t, sin_t], plus an ``ok`` flag
that is False when an ACTIVE window's samples [wstart, wstart + n) leave
the block.  Inactive and out-of-block windows give zeros.

:func:`band_taps` launches a hand-written CUDA kernel of
``csrc/band_taps.cu`` for CUDA tensors and uses the plain PyTorch version,
:func:`band_taps_plain`, only for tensors on the CPU.  Offsets of the form
``tap_offsets(corrn, d)`` (all the receiver makes) go to the cluster
kernel (``COUNTS.kernel``), any other offsets to the v1 kernel
(``COUNTS.v1``); the choice follows the offsets, never a failure.  There is
no fallback from a kernel to the plain version or from one kernel to the
other.  Any odd tap count is one launch: past the 25 taps the source
instantiates, both kernels loop over groups of 13 taps inside the launch
(``band_taps_wide_kernel``, ``band_taps_v1_wide_kernel``), so a
super-step at CORRN 13-32 is still one K1 launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .carrier import TWO_PI
from .kernels import (V1Counts, bind, check_offsets, check_tensors,
                      device_offsets, progression, raise_on, route,
                      stream_of)
from .nco import frac


COUNTS = V1Counts("band_taps")


def band_taps_plain(block, rc, wstart, n, rem, ftot, active, offsets,
                    smax: int):
    """The band correlator's math in plain PyTorch (any device)."""
    dev = block.device
    B, nxt = rc.shape
    nwin = nxt - 2 * smax
    nblock = block.shape[0]
    i = torch.arange(nwin, device=dev)
    n_ = torch.clamp(n.long(), max=nwin)
    w0 = wstart.long()
    inside = (w0 >= 0) & (w0 + torch.clamp(n_, min=0) <= nblock)
    ok = torch.all(~active | inside)
    keep = (i[None, :] < n_[:, None]) & (active & inside)[:, None]
    x = block[torch.clamp(w0[:, None] + i[None, :], 0, nblock - 1)]
    ph = frac(frac(ftot[:, None] * i.to(torch.float32)[None, :])
              + rem[:, None])
    ang = TWO_PI * ph
    c, s = torch.cos(ang), torch.sin(ang)
    if block.dim() == 2:
        xr, xi = x[..., 0], x[..., 1]
        wc, ws = xr * c - xi * s, xr * s + xi * c
    else:
        wc, ws = x * c, x * s
    wc = torch.where(keep, wc, 0.0)
    ws = torch.where(keep, ws, 0.0)
    rcf = rc.to(torch.float32)
    cols = []
    for o in offsets:
        rep = rcf[:, smax + int(o):smax + int(o) + nwin]
        cols += [(wc * rep).sum(dim=1), (ws * rep).sum(dim=1)]
    return torch.stack(cols, dim=1), ok


def _check(block, rc, wstart, n, rem, ftot, active, offsets, smax):
    offsets = check_offsets("band_taps", offsets, smax)
    B = rc.shape[0] if isinstance(rc, torch.Tensor) and rc.dim() == 2 else -1
    check_tensors("band_taps", block.device, [
        ("block", block, torch.float32, None),
        ("rc", rc, torch.int8, None),
        ("wstart", wstart, torch.int32, (B,)),
        ("n", n, torch.int32, (B,)),
        ("rem", rem, torch.float32, (B,)),
        ("ftot", ftot, torch.float32, (B,)),
        ("active", active, torch.bool, (B,)),
    ])
    if rc.dim() != 2 or rc.shape[1] <= 2 * smax:
        raise ValueError(f"band_taps: rc must be (B, next > 2*smax), got "
                         f"{tuple(rc.shape)} with smax={smax}")
    if not (block.dim() == 1 or (block.dim() == 2 and block.shape[1] == 2)):
        raise ValueError("band_taps: block must be (n,) real or (n, 2) I/Q")
    return offsets


def band_taps(block, rc, wstart, n, rem, ftot, active, offsets, smax: int):
    """All-tap sums of a super-step's windows -> ((B, 2T) f32, ok).

    block:   (nblock,) f32 real samples or (nblock, 2) f32 I/Q
    rc:      (B, next) int8 replica rows (row b covers sample offsets
             [-smax, next - smax) of window b)
    wstart:  (B,) int32 window start within the block
    n:       (B,) int32 valid samples per window
    rem:     (B,) f32 carrier phase at the window start (cycles)
    ftot:    (B,) f32 carrier rate (cycles/sample, mod 1)
    active:  (B,) bool — the window's channel is tracking
    offsets: T host ints, the tap offsets (|o| <= smax), T odd
    Returns (B, 2T) f32 [cos_0, sin_0, cos_1, ...] and a 0-dim bool tensor
    on the block's device.
    """
    offsets = _check(block, rc, wstart, n, rem, ftot, active, offsets, smax)
    if route("band_taps", block.device) == "plain":
        COUNTS.plain += 1
        return band_taps_plain(block, rc, wstart, n, rem, ftot, active,
                               offsets, smax)
    B, T = rc.shape[0], len(offsets)
    out = torch.empty((B, 2 * T), dtype=torch.float32, device=block.device)
    ok = torch.ones(1, dtype=torch.int32, device=block.device)
    launch(block, rc, wstart, n, rem, ftot, active, offsets, smax, out, ok)
    return out, ok[0] != 0


def launch(block, rc, wstart, n, rem, ftot, active, offsets, smax: int,
           out, ok) -> None:
    """Launch K1 on the current CUDA stream into ``out`` (B, 2T) f32 and
    ``ok`` (1,) int32 (set to 1 beforehand), with no argument checks:
    :func:`band_taps` checks, allocates and calls this.  Offsets of the
    form ``tap_offsets(corrn, d)`` launch the cluster kernel; any other
    offsets launch the v1 kernel.  Raises if the launch is refused."""
    offsets = tuple(int(o) for o in offsets)
    d = progression(offsets)
    if d is None:
        launch_v1(block, rc, wstart, n, rem, ftot, active, offsets, smax,
                  out, ok)
        return
    lib = _library()
    B, nxt = rc.shape
    with torch.cuda.device(block.device):
        err = lib.band_taps_launch(
            block.data_ptr(), block.shape[0], int(block.dim() == 2),
            rc.data_ptr(), nxt, nxt - 2 * smax,
            wstart.data_ptr(), n.data_ptr(), rem.data_ptr(),
            ftot.data_ptr(), active.data_ptr(), len(offsets), int(smax), d,
            B, out.data_ptr(), ok.data_ptr(), stream_of(block.device))
    raise_on(lib, "band_taps", err)
    COUNTS.kernel += 1


def launch_v1(block, rc, wstart, n, rem, ftot, active, offsets,
              smax: int, out, ok) -> None:
    """Launch the v1 kernel (``band_taps_v1_launch``: one block per
    window, any offsets) as :func:`launch` does; counts ``COUNTS.v1``."""
    lib = _library()
    B, nxt = rc.shape
    offs = device_offsets(tuple(int(o) for o in offsets), block.device)
    with torch.cuda.device(block.device):
        err = lib.band_taps_v1_launch(
            block.data_ptr(), block.shape[0], int(block.dim() == 2),
            rc.data_ptr(), nxt, nxt - 2 * smax,
            wstart.data_ptr(), n.data_ptr(), rem.data_ptr(),
            ftot.data_ptr(), active.data_ptr(), offs.data_ptr(),
            offs.shape[0], int(smax), B, out.data_ptr(), ok.data_ptr(),
            stream_of(block.device))
    raise_on(lib, "band_taps", err)
    COUNTS.v1 += 1


def samples_per_thread() -> int:
    """Samples each thread of the cluster kernel takes (its ``kJ``)."""
    return int(_library().band_taps_samples_per_thread())


def ctas_per_window() -> int:
    """CTAs, one thread-block cluster, per window of the cluster kernel
    (its ``kCluster``: the fastest of 1, 2, 4 and 8 on the card, PERF.md)."""
    return int(_library().band_taps_ctas_per_window())


_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the arguments of csrc/band_taps.cu's band_taps_launch (the cluster
# kernel) and band_taps_v1_launch (the v1 kernel)
LAUNCH_ARGTYPES = [_VP, _I64, _I32, _VP, _I32, _I32, _VP, _VP, _VP, _VP, _VP,
                   _I32, _I32, _I32, _I32, _VP, _VP, _VP]
V1_ARGTYPES = [_VP, _I64, _I32, _VP, _I32, _I32, _VP, _VP, _VP, _VP, _VP, _VP,
               _I32, _I32, _I32, _VP, _VP, _VP]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/band_taps.cu``."""
    lib = bind("band_taps", "band_taps_launch", LAUNCH_ARGTYPES)
    lib.band_taps_v1_launch.argtypes = V1_ARGTYPES
    lib.band_taps_v1_launch.restype = _I32
    lib.band_taps_samples_per_thread.restype = _I32
    lib.band_taps_ctas_per_window.restype = _I32
    return lib


def load_kernel() -> None:
    """Build and load the kernel library now (set-up time), instead of at
    the first CUDA launch."""
    _library()
