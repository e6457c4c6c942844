"""Time the window correlator (K3, and the float32 instantiation of K4/K5)
on the card against variants of its source: its build steps, cluster
sizes and other constants, and variants that each take one
cost away, at the receiver's shapes.

    python -m gnsslib_tpu_torch.tools.profile_window [--kind bf16|f32|all]
        [--iq] [--rounds N]

The inputs are those of ``chip_smoke.py`` phase 3 (:func:`inputs`): the
32-channel L1CA super-step's 320 fetched windows of 16376 samples at
16.368 Msps with ``TrackConfig(6, 3, 6)`` (13 taps 3 samples apart,
16412-element replica rows), 8-bit-valued samples, +-1 replica rows,
valid lengths around n_nom.  K3 (``bf16``) takes bf16 windows and int8
rows, the f32 instantiation (``f32``, K4 and K5) f32 windows and rows.
Each variant is ``csrc/window_taps.cu`` (with its headers inlined, the
cluster kernel's body ``csrc/window_cluster.cuh`` among them) with a few
lines replaced, built
for 13 taps only by nvcc (all variants in parallel, helpers of
:mod:`.profile_band`) into ``build/gnsslib_tpu_torch/profile_window/``,
and timed by :func:`.profile_band.graph_ms`: launches replayed from one
CUDA graph, inputs rotated over copies beyond the L2 cache:

    v1        the port's first kernel (window_taps_v1_launch of the
              library the wrappers load): one block per window
    reuse     build step 1: the cluster kernel's chains of kJ = 33 samples
              d apart reuse each replica value across the taps; one CTA
              per window, the replica staged one value per thread, the
              window read through L1, the carrier by sincosf as in v1
    async     step 1 + step 2: the replica and the window staged by
              16-byte cp.async, all in flight before one wait
    cluster   + step 3: S = 2 CTAs per window in one thread-block cluster
    kernel    + step 4: the carrier by sincospif; the kernel the wrappers
              launch
    S1 S2 S4  the kernel with 1, 2 or 4 CTAs per window
    l1win     the kernel with the window read through L1, not staged
    J17 J65   the kernel with chains of 17 or 65 samples
    B4        the kernel capped at 64 registers (4 CTAs per SM), not 80
    i2f pack  K3's int8 and bf16 conversions by other instructions (an
              integer add and a float subtraction; one packed rounding of
              the cos/sin pair)
    nocarrier the carrier replaced by two multiply-adds
    nostage   no staging copies (the chains read whatever shared memory
              holds)
    nocompute no chain loop: the staging and the reduction only
    empty     neither: the window's scalars, the reduction of zeros, the
              cluster barriers and the row written
    launch    returns at once: the launch and CTA scheduling floor

The variants of SAME compute the function and are held against
``window_taps_plain`` before they are timed (1e-5 of the largest window
L1 norm for f32, 1e-4 for K3, phase 3's tolerances).  Differences
between lines say what each step or part costs; the parts overlap in
time, so they need not add up.  For K3 the tool also counts the mixed
samples whose bf16 rounding the kernel's carrier can flip against the
plain version's (sincospif modelled by the float64 carrier rounded to
f32).  Each variant's registers and spills are ptxas's.  The tool needs
the card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import sys
import time

import numpy as np
import torch

from .. import cuda_build
from ..constants import CodeType, DType
from ..ops import window_taps as wt
from ..ops.carrier import TWO_PI
from ..ops.kernels import progression, stream_of
from ..ops.nco import frac
from ..track import TrackConfig, Tracker
from .profile_band import (TAPS13, TAPS_ALL, apply_variant, compile_sources,
                           copies_for, graph_ms)

F_SF, F_IF = 16.368e6, 4.092e6          # the receiver runs' sampling and IF
B = 320                                  # 32 channels x 10 windows
KINDS = {"f32": 0, "bf16": 1}            # window_taps_launch's kinds
OUT = cuda_build.BUILD_DIR / "profile_window"

_SINCOSPIF = "  sincospif(2.f * (frac_f(__fmul_rn(f, fi)) + r0), sn, cs);\n"
_SINCOSF = [(_SINCOSPIF, "  sincosf(__fmul_rn(kTwoPi, frac_f(frac_f("
                         "__fmul_rn(f, fi)) + r0)), sn, cs);\n")]
_STAGE = ("  for (int v = threadIdx.x; v < (head + count + 15) >> 4; "
          "v += blockDim.x) {")
_RSTAGE = ("    const int rhead = stage_async(smem, a.rc, a.rc_bytes, rfirst, "
           "rcount);\n")
_BY_VALUE = [(_RSTAGE,
              "    for (int t = tid; t < nrep; t += blockDim.x) {\n"
              "      const long long k = rfirst / (long long)sizeof(R) + t;\n"
              "      reinterpret_cast<R*>(smem)[t] =\n"
              "          k < a.rc_bytes / (long long)sizeof(R)\n"
              "              ? static_cast<const R*>(a.rc)[k] : (R)0;\n"
              "    }\n"
              "    const int rhead = 0;\n")]
_L1WIN = [("    const W* x = reinterpret_cast<const W*>(           // the "
           "segment's samples\n"
           "        wsm + stage_async(wsm, a.win, a.win_bytes, wfirst,\n"
           "                          lim * F * (int)sizeof(W)));\n",
           "    const W* x = static_cast<const W*>(a.win) + wfirst / "
           "(long long)sizeof(W);\n"),
          ("  shm += staged_bytes(a.seg * F * (int)sizeof(W));\n", "")]
_CHAIN = "      if (s0 < lim)\n        chain_taps<"
_ENTRY = "  float* o = a.out + (size_t)b * width;\n"
_CLUSTER = "constexpr int kCluster = 2;"
_KJ = "constexpr int kJ = 33;"
_NOSTAGE = [(_STAGE, _STAGE.replace("v < (head", "v < 0 * (head"))]
_NOCHAIN = [(_CHAIN, _CHAIN.replace("s0 < lim", "s0 < 0"))]


def _set(line: str, value) -> list:
    """Replace the constant of ``line`` ("constexpr T name = v;")."""
    return [(line, line.rsplit("=", 1)[0] + f"= {value};")]


VARIANTS = {
    "reuse": _BY_VALUE + _L1WIN + _set(_CLUSTER, 1) + _SINCOSF,
    "async": _set(_CLUSTER, 1) + _SINCOSF,
    "cluster": _SINCOSF,
    "kernel": [],
    **{f"S{c}": _set(_CLUSTER, c) for c in (1, 2, 4)},
    "l1win": _L1WIN,
    **{f"J{j}": _set(_KJ, j) for j in (17, 65)},
    "B4": [("__launch_bounds__(kThreads, NT <= 13 ? 3 : 1)",
            "__launch_bounds__(kThreads, NT <= 13 ? 4 : 1)")],
    "i2f": [("__device__ __forceinline__ float as_float(int8_t x) { return "
             "(float)x; }",
             "__device__ __forceinline__ float as_float(int8_t x) {\n"
             "  return __int_as_float(0x4B400000 + x) - 12582912.f;\n}")],
    "pack": [("  a = bf16_round(a);\n  b = bf16_round(b);\n",
              "  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);\n"
              "  a = __low2float(h);\n  b = __high2float(h);\n")],
    "nocarrier": [(_SINCOSPIF, "  *sn = fmaf(f, fi, r0);\n"
                               "  *cs = fmaf(r0, fi, f);\n")],
    "nostage": _NOSTAGE,
    "nocompute": _NOCHAIN,
    "empty": _NOSTAGE + _NOCHAIN,
    "launch": [(_ENTRY, _ENTRY + "  if (a.d > 0) return;\n")],
}
# the variants that compute the function (the others take work away);
# v1 is the wrappers' library's own entry point
SAME = ("v1", "reuse", "async", "cluster", "kernel", "S1", "S2", "S4",
        "l1win", "J17", "J65", "B4", "i2f", "pack")


def inputs(device, kind: str, iq: bool, seed: int = 17, corr=(6, 3, 6)):
    """Phase 3's fetched windows for ``kind`` ("bf16": K3, "f32": K4/K5):
    (trk, the largest window L1 norm over its valid samples, host arrays
    (windows, rc, rem, ftot, n) as float32/int8/int32 numpy, the same as
    tensors on ``device`` in the kind's types).  ``corr`` (CORRN, CORRD,
    CORRP) gives another tap geometry's windows and rows."""
    trk = Tracker(TrackConfig(*corr), [1], [CodeType.L1CA], F_SF, F_IF,
                  DType.IQ if iq else DType.REAL, device=device)
    rng = np.random.default_rng(seed + iq)
    nn = trk.n_nom
    win = rng.integers(-128, 128, (B, trk.nwin, 2) if iq else (B, trk.nwin)
                       ).astype(np.float32)
    rc = rng.choice(np.asarray([-1, 1], np.int8), (B, trk.next))
    rem = rng.uniform(0, 1, B).astype(np.float32)
    ftot = (0.25 + rng.uniform(-4e-4, 4e-4, B)).astype(np.float32)
    n = rng.integers(nn - 2, nn + 3, B).astype(np.int32)
    a = np.abs(win).reshape(B, trk.nwin, -1).sum(-1)
    l1 = max(float(a[b, :k].sum()) for b, k in enumerate(n))
    host = (win, rc, rem, ftot, n)
    args = [torch.from_numpy(x).to(device) for x in host]
    if kind == "bf16":
        args[0] = args[0].to(torch.bfloat16)
    else:
        args[1] = args[1].to(torch.float32)
    return trk, l1, host, args


def tolerance(kind: str, l1: float) -> float:
    """Phase 3's tolerance: each tap sums n products bounded by |x_i|
    (|replica| = 1); f32 rounding in either summation order and an ulp of
    the carrier stay below 1e-5 of the L1 norm; K3's bf16 rounding flips
    move a tap by at most 2^-7 |x_i| each: 1e-4."""
    return (1e-4 if kind == "bf16" else 1e-5) * l1


def variant_source(name: str) -> str:
    """``csrc/window_taps.cu`` (with ``csrc/stage_async.cuh`` inlined) with
    variant ``name``'s replacements, built for 13 taps only; raises if a
    replaced line is not in the source."""
    return apply_variant(cuda_build.source("window_taps"),
                         VARIANTS[name] + [(TAPS_ALL, TAPS13)],
                         f"profile_window: variant {name}")


_LIBS = {}          # variant -> (loaded library, ptxas output), per process


def build(names) -> dict:
    """Build every variant of ``names`` not built yet (one nvcc each, in
    parallel) and load it: {name: ctypes library}."""
    todo = {n: variant_source(n) for n in names if n not in _LIBS}
    for name, (lib, text) in compile_sources(todo, OUT,
                                             "profile_window").items():
        lib.window_taps_launch.argtypes = wt.LAUNCH_ARGTYPES
        lib.window_taps_launch.restype = ctypes.c_int
        _LIBS[name] = (lib, text)
    return {name: _LIBS[name][0] for name in names}


def registers(name: str, kind: str, iq: bool) -> str:
    """ptxas's registers and spills of variant ``name``'s cluster kernel
    (13 taps, ``kind``, ``iq``), from its build output."""
    want = f"ILi13ELb{int(iq)}E"
    entry, found = "", {}
    for ln in _LIBS[name][1].splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif "window_taps_cluster_kernel" in entry and want in entry and \
                ("bfloat16" in entry) == (kind == "bf16"):
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m:
                found["spill"] = int(m[1])
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                found["regs"] = int(m[1])
    return f"{found.get('regs', '?')} regs, {found.get('spill', '?')} B spill"


def launcher(lib, kind: str, offsets, smax: int, out):
    """``fn(args)``: launch ``lib``'s cluster kernel on ``args`` (windows,
    rc, rem, ftot, n) into ``out`` as :func:`window_taps.launch` does."""
    offsets = tuple(int(o) for o in offsets)
    d = progression(offsets)
    k = KINDS[kind]

    def fn(a):
        w, rc, rem, ftot, n = a
        err = lib.window_taps_launch(
            k, int(w.dim() == 3), w.data_ptr(), w.shape[1], rc.data_ptr(),
            rc.shape[1], rem.data_ptr(), ftot.data_ptr(), n.data_ptr(),
            len(offsets), smax, d, w.shape[0], out.data_ptr(),
            stream_of(out.device))
        if err:
            raise RuntimeError(f"profile_window: launch failed (cudaError "
                               f"{err})")
    return fn


def bf16_flips(host, trk) -> tuple:
    """(mixed values whose bf16 rounding differs between the plain
    version's carrier cos/sin(f32(2 pi) * ph) and the float64 carrier
    rounded to f32 (a model of sincospif), mixed values in all) over the
    valid samples of ``host``'s windows, on the card."""
    dev = torch.device("cuda")
    win, _, rem, ftot, n = (torch.from_numpy(a).to(dev) for a in host)
    i = torch.arange(trk.nwin, device=dev, dtype=torch.float32)
    ph = frac(frac(ftot[:, None] * i[None, :]) + rem[:, None])
    ang64 = 2 * np.pi * ph.double()
    carriers = [(torch.cos(TWO_PI * ph), torch.sin(TWO_PI * ph)),
                (torch.cos(ang64).float(), torch.sin(ang64).float())]
    mixed = []
    for c, s in carriers:
        if win.dim() == 3:
            wr, wi = win[..., 0], win[..., 1]
            mixed.append((wr * c - wi * s, wr * s + wi * c))
        else:
            mixed.append((win * c, win * s))
    keep = i[None, :] < n[:, None]
    flips = sum(int(((a.to(torch.bfloat16) != b.to(torch.bfloat16)) & keep)
                    .sum()) for a, b in zip(*mixed))
    return flips, 2 * int(keep.sum())


def profile(kind: str = "bf16", iq: bool = False, rounds: int = 5,
            log=print) -> dict:
    """Build (once per process) and time every variant for one
    instantiation; returns {variant: {"ms", "err" (SAME only), "regs"}}."""
    dev = torch.device("cuda")
    t0 = time.time()
    build(VARIANTS)
    built = time.time() - t0
    trk, l1, host, args = inputs(dev, kind, iq)
    offsets, smax = trk.offsets, trk.smax
    nbytes = sum(a.numel() * a.element_size() for a in args)
    copies = [[a.clone() for a in args] for _ in range(copies_for(nbytes))]
    zp = wt.window_taps_plain(*args, offsets, smax)
    out = torch.empty_like(zp)
    tol = tolerance(kind, l1)
    k = KINDS[kind]
    fns = {"v1": lambda a: wt.launch_v1(k, *a, offsets, smax, out)}
    fns.update({name: launcher(lib, kind, offsets, smax, out)
                for name, (lib, _) in _LIBS.items() if name in VARIANTS})
    res = {}
    for name in SAME:
        fns[name](args)
        torch.cuda.synchronize()
        err = float((out - zp).abs().max())
        if not err <= tol:
            raise AssertionError(f"profile_window: {kind} "
                                 f"{'iq' if iq else 'real'} variant {name} "
                                 f"vs plain: max_abs_err {err} > {tol}")
        res[name] = {"err": err}
    tag = f"{kind} {'iq' if iq else 'real'}"
    log(f"# {torch.cuda.get_device_name(dev)}: K3-K5 variants built in "
        f"{built:.1f} s; {tag}, B={B} nwin={trk.nwin} next={trk.next} "
        f"taps={len(offsets)}; {', '.join(SAME)} match the plain version "
        f"(tol {tol:.4g}); device ms per launch (CUDA graph, inputs beyond "
        f"L2 over {len(copies)} copies)")
    if kind == "bf16":
        flips, total = bf16_flips(host, trk)
        log(f"# {tag}: the carrier flips the bf16 rounding of {flips} of "
            f"{total} mixed values ({flips / total:.3g}); max_abs_err vs "
            f"plain: kernel {res['kernel']['err']:.4g}, with sincosf "
            f"(cluster) {res['cluster']['err']:.4g}")
    for name, fn in fns.items():
        rec = res.setdefault(name, {})
        rec["ms"] = graph_ms(lambda c, fn=fn: fn(copies[c]), len(copies),
                             rounds=rounds)
        rec["regs"] = "" if name == "v1" else registers(name, kind, iq)
    for name, rec in res.items():
        gap = rec["ms"] - res["kernel"]["ms"]
        log(f"{name:10s} {rec['ms']:8.4f} ms  ({gap:+.4f} vs kernel)  "
            f"{rec['regs']}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch.tools.profile_window",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", choices=("bf16", "f32", "all"), default="all",
                    help="K3 (bf16), the f32 instantiation, or both "
                         "(default)")
    ap.add_argument("--iq", action="store_true",
                    help="I/Q windows only (default: real and I/Q)")
    ap.add_argument("--rounds", type=int, default=5,
                    help="graph replays per variant (default 5)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_window: no CUDA card", file=sys.stderr)
        return 2
    kinds = ("bf16", "f32") if a.kind == "all" else (a.kind,)
    for kind in kinds:
        for iq in ((True,) if a.iq else (False, True)):
            profile(kind, iq, a.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
