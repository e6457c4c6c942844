"""The correlator ablation (kernel K6): K4's body and three variants of it,
each with one cost removed.

Counterpart of the Pallas kernel of the JAX package's
``tools/profile_kernel.py`` (``make`` and the bodies ``k_full``,
``k_nosin``, ``k_onetap``, ``k_aligned``).  For every window b:

    ph(i)    = frac(frac(ftot_b * i) + rem_b)
    cos_t[b] = sum_{i < n_b} win_b[i] cos(2 pi ph(i)) * rc[b, i + lag_t]
    sin_t[b] = the same with sin

returned as (B, 2T) float32 interleaved [cos_t, sin_t], with per variant:

* ``full``    lag_t = smax + o_t (K4);
* ``nosin``   cos -> 1 - ph^2, sin -> ph (no transcendental);
* ``onetap``  tap 0 only, its pair repeated for every tap (no tap loop);
* ``aligned`` lag_t = 128 t (no unaligned offsets).

``n`` is float32, as the TPU tool passes it (its mask is ``i < n``).
:func:`ablation_taps` launches a hand-written CUDA kernel
(``csrc/ablation_taps.cu``) for CUDA tensors and uses the variant's plain
PyTorch version only for tensors on the CPU.  The kernel ablates the
port's K4 body, the window cluster kernel (``csrc/window_cluster.cuh``):
lags that :func:`plan` finds in a progression (all the TPU tool's) launch
it (``COUNTS[v].kernel``), any others the first K6 kernel (``COUNTS[v].v1``);
the choice follows the lags, never a failure, and there is no fallback
from a kernel to the plain version or from one kernel to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .carrier import TWO_PI
from .kernels import (MAX_TAPS, V1Counts, bind, check_offsets,
                      check_tensors, device_offsets, raise_on, route,
                      stream_of)
from .nco import frac

VARIANTS = ("full", "nosin", "onetap", "aligned")   # kernel variant codes 0-3
COUNTS = {v: V1Counts(f"ablation_taps[{v}]") for v in VARIANTS}
ALIGN = 128                     # the aligned variant's tap stride (samples)


def lags(variant: str, offsets, smax: int) -> tuple:
    """The replica offset each tap reads for ``variant``."""
    if variant == "aligned":
        return tuple(ALIGN * t for t in range(len(offsets)))
    return tuple(smax + int(o) for o in offsets)


@functools.lru_cache(maxsize=64)
def plan(variant: str, offsets: tuple, smax: int):
    """The cluster kernel's plan for ``variant``: (base, d, cols) when the
    variant's lags, sorted, are base + m*d with d >= 1 (d = 1 for one tap),
    else None (the v1 kernel).  ``cols[m]`` is the output tap of lag m.
    ``onetap`` computes tap 0's lag alone, as (that lag, the d of all its
    lags, (0,)), and the kernel writes its pair to every tap, so its chains
    run at ``full``'s d."""
    lg = lags(variant, offsets, smax)
    order = sorted(range(len(lg)), key=lambda t: lg[t])
    first = lg[order[0]]
    d = lg[order[1]] - first if len(lg) > 1 else 1
    if d < 1 or any(lg[t] != first + m * d for m, t in enumerate(order)):
        return None
    if variant == "onetap":
        return lg[0], d, (0,)
    return first, d, tuple(order)


def sources(cols: tuple, ntaps: int) -> tuple:
    """The kernel's column map: for each output tap, the lag (index into
    the plan's lags) whose pair it takes; lag 0 where no lag names the tap
    (onetap's plan names tap 0 alone, so its pair goes to every tap)."""
    src = [0] * ntaps
    for m, c in enumerate(cols):
        src[c] = m
    return tuple(src)


def _mix(variant: str, win, rem, ftot, n):
    nwin = win.shape[1]
    i = torch.arange(nwin, device=win.device, dtype=torch.float32)
    ph = frac(frac(ftot[:, None] * i[None, :]) + rem[:, None])
    if variant == "nosin":
        c, s = 1.0 - ph * ph, ph
    else:
        ang = TWO_PI * ph
        c, s = torch.cos(ang), torch.sin(ang)
    keep = i[None, :] < n[:, None]
    return (torch.where(keep, win * c, 0.0), torch.where(keep, win * s, 0.0))


def _taps(wc, ws, rc, lag_list):
    nwin = wc.shape[1]
    cols = []
    for lag in lag_list:
        rep = rc[:, lag:lag + nwin]
        cols += [(wc * rep).sum(dim=1), (ws * rep).sum(dim=1)]
    return torch.stack(cols, dim=1)


def full_plain(win, rc, rem, ftot, n, offsets, smax: int):
    """``k_full`` in plain PyTorch (any device)."""
    wc, ws = _mix("full", win, rem, ftot, n)
    return _taps(wc, ws, rc, lags("full", offsets, smax))


def nosin_plain(win, rc, rem, ftot, n, offsets, smax: int):
    """``k_nosin``: the carrier as 1 - ph^2 and ph."""
    wc, ws = _mix("nosin", win, rem, ftot, n)
    return _taps(wc, ws, rc, lags("nosin", offsets, smax))


def onetap_plain(win, rc, rem, ftot, n, offsets, smax: int):
    """``k_onetap``: tap 0's pair, repeated for every tap."""
    wc, ws = _mix("onetap", win, rem, ftot, n)
    return _taps(wc, ws, rc, lags("onetap", offsets, smax)[:1]).repeat(
        1, len(offsets))


def aligned_plain(win, rc, rem, ftot, n, offsets, smax: int):
    """``k_aligned``: tap t read at offset 128 t."""
    wc, ws = _mix("aligned", win, rem, ftot, n)
    return _taps(wc, ws, rc, lags("aligned", offsets, smax))


PLAIN = {"full": full_plain, "nosin": nosin_plain, "onetap": onetap_plain,
         "aligned": aligned_plain}


def _check(win, rc, rem, ftot, n, offsets, smax, variant):
    op = f"ablation_taps[{variant}]"
    if variant not in VARIANTS:
        raise ValueError(f"ablation_taps: variant must be one of {VARIANTS}, "
                         f"got {variant!r}")
    offsets = check_offsets(op, offsets, smax)
    if not isinstance(win, torch.Tensor) or win.dim() != 2:
        raise ValueError(f"{op}: win must be a (B, nwin) tensor")
    B, nwin = win.shape
    check_tensors(op, win.device, [
        ("win", win, torch.float32, None),
        ("rc", rc, torch.float32, None),
        ("rem", rem, torch.float32, (B,)),
        ("ftot", ftot, torch.float32, (B,)),
        ("n", n, torch.float32, (B,)),
    ])
    need = nwin + max(lags(variant, offsets, smax))
    if rc.dim() != 2 or rc.shape[0] != B or rc.shape[1] < need:
        raise ValueError(f"{op}: rc must be (B={B}, W >= {need}), got "
                         f"{tuple(rc.shape)}")
    return op, offsets


def ablation_taps(win, rc, rem, ftot, n, offsets, smax: int,
                  variant: str = "full"):
    """K6: the ablation ``variant``'s tap sums -> (B, 2T) float32.

    win:     (B, nwin) float32 window samples
    rc:      (B, W) float32 replica rows, W >= nwin + the largest lag
    rem:     (B,) float32 carrier phase at the window start (cycles)
    ftot:    (B,) float32 carrier rate (cycles/sample)
    n:       (B,) float32 valid-sample bound (samples i < n count)
    offsets: T host ints (|o| <= smax), T odd; the kernel takes at most
             25 (the one geometry its tool runs has 13), the plain
             version any
    variant: "full", "nosin", "onetap" or "aligned"
    """
    op, offsets = _check(win, rc, rem, ftot, n, offsets, smax, variant)
    if route(op, win.device) == "plain":
        COUNTS[variant].plain += 1
        return PLAIN[variant](win, rc, rem, ftot, n, offsets, smax)
    if len(offsets) > MAX_TAPS:
        raise ValueError(f"{op}: the kernel takes at most {MAX_TAPS} taps, "
                         f"got {len(offsets)}")
    out = torch.empty((win.shape[0], 2 * len(offsets)), dtype=torch.float32,
                      device=win.device)
    which = launch(variant, win, rc, rem, ftot, n, offsets, smax, out)
    setattr(COUNTS[variant], which, getattr(COUNTS[variant], which) + 1)
    return out


def launch(variant: str, win, rc, rem, ftot, n, offsets, smax: int,
           out) -> str:
    """Launch ``variant`` on the current CUDA stream into ``out`` (B, 2T)
    float32, with no argument checks and no count: :func:`ablation_taps`
    checks, allocates, counts and calls this.  Lags that :func:`plan`
    plans launch the cluster kernel, any others the v1 kernel; returns
    which (``"kernel"`` or ``"v1"``, the counter to add to).  Raises if
    the launch is refused."""
    offsets = tuple(int(o) for o in offsets)
    p = plan(variant, offsets, smax)
    if p is None:
        launch_v1(variant, win, rc, rem, ftot, n, offsets, smax, out)
        return "v1"
    base, d, cols = p
    lib = _library()
    src = device_offsets(sources(cols, len(offsets)), win.device)
    with torch.cuda.device(win.device):
        err = lib.ablation_taps_launch(
            VARIANTS.index(variant), win.data_ptr(), win.shape[1],
            rc.data_ptr(), rc.shape[1], rem.data_ptr(), ftot.data_ptr(),
            n.data_ptr(), len(offsets), base, d, src.data_ptr(),
            win.shape[0], out.data_ptr(), stream_of(win.device))
    raise_on(lib, "ablation_taps", err)
    return "kernel"


def launch_v1(variant: str, win, rc, rem, ftot, n, offsets, smax: int,
              out) -> None:
    """Launch the v1 kernel (``ablation_taps_v1_launch``: one block per
    window, any lags) as :func:`launch` does, with no count."""
    lib = _library()
    lg = device_offsets(lags(variant, offsets, smax), win.device)
    with torch.cuda.device(win.device):
        err = lib.ablation_taps_v1_launch(
            VARIANTS.index(variant), win.data_ptr(), win.shape[1],
            rc.data_ptr(), rc.shape[1], rem.data_ptr(), ftot.data_ptr(),
            n.data_ptr(), lg.data_ptr(), lg.shape[0], win.shape[0],
            out.data_ptr(), stream_of(win.device))
    raise_on(lib, "ablation_taps", err)


def samples_per_thread() -> int:
    """Samples in each thread's chain of the cluster kernel (its ``kJ``,
    the window cluster kernel's)."""
    return int(_library().ablation_taps_samples_per_thread())


def ctas_per_window() -> int:
    """CTAs, one thread-block cluster, per window of the cluster kernel
    (its ``kCluster``, the window cluster kernel's)."""
    return int(_library().ablation_taps_ctas_per_window())


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/ablation_taps.cu``."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib = bind("ablation_taps", "ablation_taps_launch", [
        i32, vp, i32, vp, i32, vp, vp, vp, i32, i32, i32, vp, i32, vp, vp])
    lib.ablation_taps_v1_launch.argtypes = [
        i32, vp, i32, vp, i32, vp, vp, vp, vp, i32, i32, vp, vp]
    lib.ablation_taps_v1_launch.restype = i32
    lib.ablation_taps_samples_per_thread.restype = i32
    lib.ablation_taps_ctas_per_window.restype = i32
    return lib


def load_kernel() -> None:
    """Build and load the kernel library now (set-up time)."""
    _library()
