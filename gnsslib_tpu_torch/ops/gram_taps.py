"""All-tap correlation of fetched window rows with the factored carrier
(kernel K2).

Counterpart of ``FastTracker._taps_fused`` in :mod:`gnsslib_tpu.track.fast`
and the Pallas kernel it calls, ``gram_usum_impl``
(gnsslib_tpu/ops/pallas_gram.py).  Window b arrives as K rows of 128
samples, masked to its valid length; with i = 128 k + j the carrier angle
splits into the row-start angle theta_k and the in-row ramp phi_j:

    theta_k = 2 pi frac(frac(ftot_b * 128 k) + rem_b),  phi_j = 2 pi ftot_b j
    a + j b = (xr + j xi) e^{j theta_k}
    wc = bf16(a cos phi_j - b sin phi_j),  ws = bf16(b cos phi_j + a sin phi_j)
    cos_t[b] = sum_i wc(i) rc[b, i + smax + o_t]   (rc past its end counts 0)
    sin_t[b] = sum_i ws(i) rc[b, i + smax + o_t]

returned as (B, 2T) float32 interleaved [cos_t, sin_t] — what
``_taps_fused`` returns.  The bf16 rounding of wc/ws is the TPU kernel's;
its split 64-lane layout, its bf16 rounding of each Gram entry and its
one-hot diagonal extractor are not reproduced (sums stay f32).

:func:`gram_taps` launches a kernel of ``csrc/gram_taps.cu`` for CUDA
tensors and uses :func:`gram_taps_plain` only for tensors on the CPU.  The
kernel is the TPU kernel's Gram on the tensor cores, restricted to the tap
band: per window ``U[j, l] = sum_k wc[k, j] r[128 k + l]`` over 8 m-tiles
of 16 lanes j, each reading only the n-tiles of 8 lag columns that
:func:`tile_plan` lists, then ``cos_t = sum_j U[j, j + smax + o_t]``
(``COUNTS.kernel``).  Geometries beyond its largest instantiation (smax >
``MAX_SMAX`` or more than ``MAX_ROWS`` rows; ``tile_plan`` returns None)
launch the v1 kernel (``COUNTS.v1``); the choice follows the geometry,
never a failure, and nothing falls back to the plain version.  Both
kernels are instantiated up to 25 taps: more taps launch the kernel once
per run of at most 25 offsets (``kernels.tap_plan``), each run's columns
copied into place, and every launch is counted.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .carrier import TWO_PI
from .kernels import (V1Counts, bind, check_offsets, check_tensors,
                      device_offsets, raise_on, route, run_plan, stream_of,
                      tap_plan)
from .nco import frac

COUNTS = V1Counts("gram_taps")
LANES = 128                  # samples per window row
M_TILE, N_TILE, K_STEP = 16, 8, 16    # mma.m16n8k16: lanes j, lags l, rows k
MAX_SMAX = 36                # the kernel's largest band (11 n-tiles)
MAX_ROWS = 256               # the kernel's most rows per window


@functools.lru_cache(maxsize=64)
def tile_plan(K: int, smax: int):
    """The banded-Gram kernel's tiles for windows of ``K`` rows and taps
    within ``[-smax, smax]``: for each of the 128 / 16 m-tiles (lanes
    ``[16 m, 16 m + 16)``), the first lag columns of the n-tiles it reads,
    ``16 m + 8 n`` for n < ceil((16 + 2 smax) / 8), so that it covers the
    lags ``j + [0, 2 smax]`` of its lanes; None when the kernel does not
    take the geometry (then :func:`launch` sends it to the v1 kernel)."""
    if smax > MAX_SMAX or K > MAX_ROWS:
        return None
    nn = -(-(M_TILE + 2 * smax) // N_TILE)
    return tuple(tuple(M_TILE * m + N_TILE * n for n in range(nn))
                 for m in range(LANES // M_TILE))


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def mixed_rows(win_i, win_q, rem, ftot):
    """The mixed rows (wc, ws), each (B, K, 128) f32 holding bf16 values:
    the A operands of the banded-Gram kernel."""
    K = win_i.shape[1]
    dev = win_i.device
    kk = torch.arange(K, device=dev, dtype=torch.float32) * float(LANES)
    th = TWO_PI * frac(frac(ftot[:, None] * kk[None, :]) + rem[:, None])
    ck, sk = torch.cos(th)[..., None], torch.sin(th)[..., None]   # (B, K, 1)
    jj = torch.arange(LANES, device=dev, dtype=torch.float32)
    phj = TWO_PI * (ftot[:, None] * jj[None, :])
    cj, sj = torch.cos(phj)[:, None, :], torch.sin(phj)[:, None, :]
    wr = win_i.to(torch.float32)
    if win_q is not None:
        wi = win_q.to(torch.float32)
        a, b = wr * ck - wi * sk, wr * sk + wi * ck
    else:
        a, b = wr * ck, wr * sk
    return _bf16_round(a * cj - b * sj), _bf16_round(b * cj + a * sj)


def gram_taps_plain(win_i, win_q, rc, rem, ftot, offsets, smax: int):
    """The factored-carrier tap sums in plain PyTorch (any device)."""
    B, K, _ = win_i.shape
    dev = win_i.device
    wc, ws = (w.reshape(B, K * LANES)
              for w in mixed_rows(win_i, win_q, rem, ftot))
    span = K * LANES + 2 * smax
    rcf = torch.zeros((B, span), dtype=torch.float32, device=dev)
    m = min(span, rc.shape[1])
    rcf[:, :m] = rc[:, :m].to(torch.float32)
    cols = []
    for o in offsets:
        rep = rcf[:, smax + int(o):smax + int(o) + K * LANES]
        cols += [(wc * rep).sum(dim=1), (ws * rep).sum(dim=1)]
    return torch.stack(cols, dim=1)


def _check(win_i, win_q, rc, rem, ftot, offsets, smax):
    op = "gram_taps"
    offsets = check_offsets(op, offsets, smax)
    if not (isinstance(win_i, torch.Tensor) and win_i.dim() == 3
            and win_i.shape[2] == LANES):
        raise ValueError(f"{op}: win_i must be (B, K, {LANES})")
    B = win_i.shape[0]
    want = [("win_i", win_i, torch.bfloat16, None),
            ("rc", rc, torch.int8, None),
            ("rem", rem, torch.float32, (B,)),
            ("ftot", ftot, torch.float32, (B,))]
    if win_q is not None:
        want.append(("win_q", win_q, torch.bfloat16, tuple(win_i.shape)))
    check_tensors(op, win_i.device, want)
    if rc.dim() != 2 or rc.shape[0] != B or rc.shape[1] <= 2 * smax:
        raise ValueError(f"{op}: rc must be (B={B}, next > 2*smax), got "
                         f"{tuple(rc.shape)}")
    return offsets


def gram_taps(win_i, win_q, rc, rem, ftot, offsets, smax: int):
    """K2: all-tap sums of masked window rows -> (B, 2T) f32.

    win_i:   (B, K, 128) bf16 window rows, masked to the valid length
             (real samples, or the I component)
    win_q:   (B, K, 128) bf16 Q component, or None for real signals
    rc:      (B, next) int8 replica rows (row b covers sample offsets
             [-smax, next - smax) of window b)
    rem:     (B,) f32 carrier phase at the window start (cycles)
    ftot:    (B,) f32 total carrier rate (cycles/sample)
    offsets: T host ints (|o| <= smax), T odd
    """
    offsets = _check(win_i, win_q, rc, rem, ftot, offsets, smax)
    if route("gram_taps", win_i.device) == "plain":
        COUNTS.plain += 1
        return gram_taps_plain(win_i, win_q, rc, rem, ftot, offsets, smax)
    out = torch.empty((win_i.shape[0], 2 * len(offsets)),
                      dtype=torch.float32, device=win_i.device)
    launch(win_i, win_q, rc, rem, ftot, offsets, smax, out, COUNTS)
    return out


def launch(win_i, win_q, rc, rem, ftot, offsets, smax: int, out,
           counts=None) -> None:
    """Launch a kernel on the current CUDA stream into ``out`` (B, 2T)
    f32, with no argument checks: :func:`gram_taps` checks, allocates and
    calls this.  The banded-Gram kernel takes what :func:`tile_plan`
    plans, the v1 kernel anything else, launched once per group of
    ``tap_plan(offsets, None)``; each launch adds one to ``counts``
    (``kernel`` or ``v1``; the wrapper passes ``COUNTS``, None counts
    nothing).  Raises if a launch is refused."""
    plan = tile_plan(win_i.shape[1], smax)
    if plan is None:
        launch_v1(win_i, win_q, rc, rem, ftot, offsets, smax, out, counts)
        return
    run_plan(tap_plan(tuple(int(o) for o in offsets), None), out, smax,
             lambda offs, sm, dst: _launch(
                 "gram_taps_launch", counts, "kernel", win_i, win_q, rc,
                 rem, ftot, offs, sm, dst, len(plan[0])))


def launch_v1(win_i, win_q, rc, rem, ftot, offsets, smax: int, out,
              counts=None) -> None:
    """Launch the v1 kernel (``gram_taps_v1_launch``: one block per
    window, f32 FMAs, any band) as :func:`launch` does."""
    run_plan(tap_plan(tuple(int(o) for o in offsets), None), out, smax,
             lambda offs, sm, dst: _launch(
                 "gram_taps_v1_launch", counts, "v1", win_i, win_q, rc,
                 rem, ftot, offs, sm, dst))


def _launch(fn: str, counts, which: str, win_i, win_q, rc, rem, ftot,
            offsets, smax: int, out, *tiles) -> None:
    """Call the library's entry point ``fn`` (``tiles``: the banded-Gram
    kernel's n-tiles per m-tile, after smax), raise on its error, and add
    the launch to ``counts.<which>`` (unless ``counts`` is None)."""
    lib = _library()
    offs = device_offsets(tuple(int(o) for o in offsets), win_i.device)
    iq = win_q is not None
    with torch.cuda.device(win_i.device):
        err = getattr(lib, fn)(
            int(iq), win_i.data_ptr(), win_q.data_ptr() if iq else None,
            win_i.shape[1], rc.data_ptr(), rc.shape[1], rem.data_ptr(),
            ftot.data_ptr(), offs.data_ptr(), offs.shape[0], int(smax),
            *tiles, win_i.shape[0], out.data_ptr(), stream_of(win_i.device))
    raise_on(lib, "gram_taps", err)
    if counts is not None:
        setattr(counts, which, getattr(counts, which) + 1)


def ctas_per_window() -> int:
    """CTAs, one thread-block cluster, per window of the banded-Gram
    kernel (its ``kCluster``)."""
    return int(_library().gram_taps_ctas_per_window())


_VP, _I32 = ctypes.c_void_p, ctypes.c_int
# the arguments of csrc/gram_taps.cu's gram_taps_launch (the banded-Gram
# kernel) and gram_taps_v1_launch (the v1 kernel)
LAUNCH_ARGTYPES = [_I32, _VP, _VP, _I32, _VP, _I32, _VP, _VP, _VP, _I32,
                   _I32, _I32, _I32, _VP, _VP]
V1_ARGTYPES = [_I32, _VP, _VP, _I32, _VP, _I32, _VP, _VP, _VP, _I32, _I32,
               _I32, _VP, _VP]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/gram_taps.cu``."""
    lib = bind("gram_taps", "gram_taps_launch", LAUNCH_ARGTYPES)
    lib.gram_taps_v1_launch.argtypes = V1_ARGTYPES
    lib.gram_taps_v1_launch.restype = _I32
    lib.gram_taps_ctas_per_window.restype = _I32
    return lib


def load_kernel() -> None:
    """Build and load the kernel library now (set-up time)."""
    _library()
