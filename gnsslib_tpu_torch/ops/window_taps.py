"""All-tap correlation of fetched windows, direct phase (kernels K3-K5).

Counterparts of the Pallas kernels of :mod:`gnsslib_tpu.ops.pallas_corr`:

* :func:`correlate_windows`   — K5, ``correlate_windows_impl`` (f32);
* :func:`correlate_windows8`  — K4, ``correlate_windows8_impl`` (f32);
* :func:`correlate_windows16` — K3, ``correlate_windows16_impl`` (bf16
  windows, int8 replica rows, mixed samples rounded to bf16, products
  summed in f32).

For every window b, already fetched out of the sample block:

    ph(i)    = frac(frac(ftot_b * i) + rem_b)
    cos_t[b] = sum_{i < n_b} w_b[i] cos(2 pi ph(i)) * rc[b, i + smax + o_t]
    sin_t[b] = the same with sin; I/Q windows mix (wr + j wi) e^{+j 2 pi ph}

returned as (B, 2T) float32 interleaved [cos_t, sin_t].  One CUDA source
(``csrc/window_taps.cu``) serves all three; K4 and K5 share its float32
instantiation but keep their own wrappers and launch counters.  Each
wrapper launches a kernel for CUDA tensors and uses
:func:`window_taps_plain` only for tensors on the CPU.  Offsets of the
form ``tap_offsets(corrn, d)`` (all the receiver and the profiler make) go
to the cluster kernel (``COUNTS*.kernel``), any other offsets to the v1
kernel (``COUNTS*.v1``); the choice follows the offsets, never a failure,
and there is no fallback from a kernel to the plain version or from one
kernel to the other.  Both kernels are instantiated up to 25 taps: more
taps launch the kernel once per group of ``kernels.tap_plan`` (the cluster
kernel: runs of consecutive lags, each about its own centre; v1: runs of
the offsets), each group's columns copied into place, and every launch is
counted.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .carrier import TWO_PI
from .kernels import (V1Counts, bind, check_offsets, check_tensors,
                      device_offsets, progression, raise_on, route,
                      run_plan, stream_of, tap_plan)
from .nco import frac


COUNTS5 = V1Counts("correlate_windows")        # K5
COUNTS8 = V1Counts("correlate_windows8")       # K4
COUNTS16 = V1Counts("correlate_windows16")     # K3

_F32, _BF16 = 0, 1            # the kernel kinds of window_taps_launch


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def window_taps_plain(windows, rc, rem, ftot, n, offsets, smax: int):
    """The windows' tap sums in plain PyTorch (any device).  bf16
    ``windows`` take K3's rounding: the mixed samples are rounded to bf16;
    the tap products (exact in f32) are summed in f32."""
    bf16 = windows.dtype == torch.bfloat16
    nwin = windows.shape[1]
    i = torch.arange(nwin, device=windows.device, dtype=torch.float32)
    ph = frac(frac(ftot[:, None] * i[None, :]) + rem[:, None])
    ang = TWO_PI * ph
    c, s = torch.cos(ang), torch.sin(ang)
    w = windows.to(torch.float32)
    if windows.dim() == 3:
        wr, wi = w[..., 0], w[..., 1]
        wc, ws = wr * c - wi * s, wr * s + wi * c
    else:
        wc, ws = w * c, w * s
    keep = i[None, :] < n.to(torch.float32)[:, None]
    wc = torch.where(keep, wc, 0.0)
    ws = torch.where(keep, ws, 0.0)
    if bf16:
        wc, ws = _bf16_round(wc), _bf16_round(ws)
    rcf = rc.to(torch.float32)
    cols = []
    for o in offsets:
        rep = rcf[:, smax + int(o):smax + int(o) + nwin]
        cols += [(wc * rep).sum(dim=1), (ws * rep).sum(dim=1)]
    return torch.stack(cols, dim=1)


def _check(op, windows, rc, rem, ftot, n, offsets, smax, wdtype, rdtype):
    offsets = check_offsets(op, offsets, smax)
    ok_rank = isinstance(windows, torch.Tensor) and (
        windows.dim() == 2 or (windows.dim() == 3 and windows.shape[2] == 2))
    if not ok_rank:
        raise ValueError(f"{op}: windows must be (B, nwin) real or "
                         f"(B, nwin, 2) I/Q")
    B, nwin = windows.shape[:2]
    check_tensors(op, windows.device, [
        ("windows", windows, wdtype, None),
        ("rc", rc, rdtype, None),
        ("rem", rem, torch.float32, (B,)),
        ("ftot", ftot, torch.float32, (B,)),
        ("n", n, torch.int32, (B,)),
    ])
    if rc.dim() != 2 or rc.shape[0] != B or rc.shape[1] < nwin + 2 * smax:
        raise ValueError(f"{op}: rc must be (B={B}, next >= nwin + 2*smax = "
                         f"{nwin + 2 * smax}), got {tuple(rc.shape)}")
    return offsets


def _run(op, counts, kind, windows, rc, rem, ftot, n, offsets, smax):
    wdtype = torch.bfloat16 if kind == _BF16 else torch.float32
    rdtype = torch.int8 if kind == _BF16 else torch.float32
    offsets = _check(op, windows, rc, rem, ftot, n, offsets, smax, wdtype,
                     rdtype)
    if route(op, windows.device) == "plain":
        counts.plain += 1
        return window_taps_plain(windows, rc, rem, ftot, n, offsets, smax)
    out = torch.empty((windows.shape[0], 2 * len(offsets)),
                      dtype=torch.float32, device=windows.device)
    launch(kind, windows, rc, rem, ftot, n, offsets, smax, out, counts)
    return out


def correlate_windows(windows, rc, rem, ftot, n, offsets, smax: int):
    """K5: all-tap sums of f32 windows -> (B, 2T) f32.

    windows: (B, nwin) f32 real or (B, nwin, 2) f32 I/Q samples
    rc:      (B, next) f32 replica rows, next >= nwin + 2*smax
    rem:     (B,) f32 carrier phase at the window start (cycles)
    ftot:    (B,) f32 total carrier rate (cycles/sample)
    n:       (B,) int32 valid samples per window
    offsets: T host ints (|o| <= smax), T odd
    """
    return _run("correlate_windows", COUNTS5, _F32, windows, rc, rem, ftot,
                n, offsets, smax)


def correlate_windows8(windows, rc, rem, ftot, n, offsets, smax: int):
    """K4: the same function and arguments as :func:`correlate_windows`
    (the TPU kernel's 8 windows per grid cell have no counterpart)."""
    return _run("correlate_windows8", COUNTS8, _F32, windows, rc, rem, ftot,
                n, offsets, smax)


def correlate_windows16(windows, rc, rem, ftot, n, offsets, smax: int):
    """K3: bf16 ``windows`` (B, nwin[, 2]) and int8 ``rc`` (B, next); the
    mixed samples are rounded to bf16, the tap products summed in f32.
    Other arguments as :func:`correlate_windows`."""
    return _run("correlate_windows16", COUNTS16, _BF16, windows, rc, rem,
                ftot, n, offsets, smax)


def launch(kind: int, windows, rc, rem, ftot, n, offsets, smax: int,
           out, counts=None) -> None:
    """Launch a kernel of ``kind`` (0: f32, 1: bf16/int8) on the current
    CUDA stream into ``out`` (B, 2T) f32, with no argument checks: the
    wrappers check, allocate and call this.  Offsets of the form
    ``tap_offsets(corrn, d)`` launch the cluster kernel, any other
    offsets the v1 kernel, once per group of ``tap_plan``; each launch
    adds one to ``counts`` (``kernel`` or ``v1``; the wrappers pass
    theirs, None counts nothing).  Raises if a launch is refused."""
    offsets = tuple(int(o) for o in offsets)
    d = progression(offsets)
    if d is None:
        launch_v1(kind, windows, rc, rem, ftot, n, offsets, smax, out,
                  counts)
        return
    lib = _library()

    def one(offs, sm, dst):
        # offs = tap_offsets(c, d) about the group's centre: smax ``sm``
        # carries the centre's shift
        with torch.cuda.device(windows.device):
            err = lib.window_taps_launch(
                kind, int(windows.dim() == 3), windows.data_ptr(),
                windows.shape[1], rc.data_ptr(), rc.shape[1],
                rem.data_ptr(), ftot.data_ptr(), n.data_ptr(), len(offs),
                int(sm), d, windows.shape[0], dst.data_ptr(),
                stream_of(windows.device))
        raise_on(lib, "window_taps", err)
        if counts is not None:
            counts.kernel += 1
    run_plan(tap_plan(offsets, d), out, smax, one)


def launch_v1(kind: int, windows, rc, rem, ftot, n, offsets, smax: int,
              out, counts=None) -> None:
    """Launch the v1 kernel (``window_taps_v1_launch``: one block per
    window, any offsets) as :func:`launch` does."""
    lib = _library()

    def one(group, sm, dst):
        offs = device_offsets(group, windows.device)
        with torch.cuda.device(windows.device):
            err = lib.window_taps_v1_launch(
                kind, int(windows.dim() == 3), windows.data_ptr(),
                windows.shape[1], rc.data_ptr(), rc.shape[1],
                rem.data_ptr(), ftot.data_ptr(), n.data_ptr(),
                offs.data_ptr(), offs.shape[0], int(sm), windows.shape[0],
                dst.data_ptr(), stream_of(windows.device))
        raise_on(lib, "window_taps", err)
        if counts is not None:
            counts.v1 += 1
    run_plan(tap_plan(tuple(int(o) for o in offsets), None), out, smax, one)


def samples_per_thread() -> int:
    """Samples in each thread's chain of the cluster kernel (its ``kJ``)."""
    return int(_library().window_taps_samples_per_thread())


def ctas_per_window() -> int:
    """CTAs, one thread-block cluster, per window of the cluster kernel
    (its ``kCluster``, chosen by measurement: PERF.md)."""
    return int(_library().window_taps_ctas_per_window())


_VP, _I32 = ctypes.c_void_p, ctypes.c_int
# the arguments of csrc/window_taps.cu's window_taps_launch (the cluster
# kernel) and window_taps_v1_launch (the v1 kernel)
LAUNCH_ARGTYPES = [_I32, _I32, _VP, _I32, _VP, _I32, _VP, _VP, _VP, _I32,
                   _I32, _I32, _I32, _VP, _VP]
V1_ARGTYPES = [_I32, _I32, _VP, _I32, _VP, _I32, _VP, _VP, _VP, _VP, _I32,
               _I32, _I32, _VP, _VP]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/window_taps.cu``."""
    lib = bind("window_taps", "window_taps_launch", LAUNCH_ARGTYPES)
    lib.window_taps_v1_launch.argtypes = V1_ARGTYPES
    lib.window_taps_v1_launch.restype = _I32
    lib.window_taps_samples_per_thread.restype = _I32
    lib.window_taps_ctas_per_window.restype = _I32
    return lib


def load_kernel() -> None:
    """Build and load the kernel library now (set-up time)."""
    _library()
