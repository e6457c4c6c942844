"""Time the fused backend's correlator (K2) on the card against variants of
its source: its build steps, cluster sizes and variants that each take one
cost away, at the receiver's shapes.

    python -m gnsslib_tpu_torch.tools.profile_gram [--iq] [--rounds N]

The inputs are those of ``chip_smoke.py`` phase 3 (:func:`inputs`): the
32-channel L1CA super-step's 320 windows of 16376 samples at 16.368 Msps
with ``TrackConfig(6, 3, 6)`` (13 taps 3 samples apart, 16412-byte int8
replica rows), 8-bit-valued samples fetched and masked into (320, 128,
128) bf16 rows as the fused backend fetches them (two arrays for I/Q).
Each variant is ``csrc/gram_taps.cu`` (with ``csrc/stage_async.cuh``
inlined) with a few lines replaced, built for the main path's 7 n-tiles
only by nvcc (all variants in parallel, helpers of :mod:`.profile_band`)
into ``build/gnsslib_tpu_torch/profile_gram/``, and timed by
:func:`.profile_band.graph_ms`: launches replayed from one CUDA graph,
inputs rotated over copies beyond the L2 cache:

    v1        the port's first kernel (gram_taps_v1_launch of the library
              the wrapper loads): one block per window, f32 FMAs
    mma       build step 1: the banded Gram on the tensor cores, one CTA
              per window (S = 1), the rows and the replica staged by plain
              loads and stores
    async     step 1 + step 2: the staging by 16-byte cp.async, all in
              flight before one wait
    kernel    + step 3: S = 2 CTAs per window in one thread-block cluster;
              the kernel the wrapper launches (step 4, the deterministic
              extraction, is in every variant)
    S1 S2 S4  the kernel with 1, 2 or 4 CTAs per window (S1 is async's
              source and S2 the kernel's, built and timed again)
    B3        the kernel capped at 80 registers (3 CTAs per SM), not 128
    nomix     the raw rows as the A operands: no carrier mix
    noangles  no sincosf: theta_k and phi_j replaced by the window's scalars
    noconvert no int8 -> bf16 conversion of the staged replica into B
    noband    no band of U written to shared memory (the store is behind a
              condition that never holds), no diagonal sums
    nostage   no staging copies (the steps read whatever shared memory
              holds)
    nocompute no k-steps (no mix, no ldmatrix, no mma): the staging, the
              replica's conversion and the extraction of zeros
    empty     neither: the window's scalars and angles, the conversion,
              the extraction, the cluster barriers and the row written
    launch    returns at once: the launch and CTA scheduling floor

The variants of SAME compute the function and are held against
``gram_taps_plain`` before they are timed (1e-4 of the largest window L1
norm, phase 3's tolerance).  Differences between lines say what each step
or part costs; the parts overlap in time, so they need not add up.  Each
variant's registers and spills are ptxas's.  The tool needs the card and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import sys
import time

import torch

from .. import cuda_build
from ..ops import gram_taps as gt
from ..ops.kernels import device_offsets, stream_of
from ..track import FastTracker
from .profile_band import (TAPS13, TAPS_ALL, apply_variant, compile_sources,
                           copies_for, graph_ms)
from .profile_window import inputs as window_inputs

OUT = cuda_build.BUILD_DIR / "profile_gram"
TILES = 7                                # the main path's n-tiles (smax 18)

_TILES_ALL = ("#define TILE_CASES(X) X(2) X(3) X(4) X(5) X(6) X(7) X(8) "
              "X(9) X(10) X(11)")
_CLUSTER = "constexpr int kCluster = 2;"
_RSTAGE = "    rhead = stage_async(raw, a.rc, a.rc_bytes, rfirst, rcount);\n"
_WCOPY = "      cp_async16(d, s, 16);\n"
_PLAIN = [(_RSTAGE,
           "    for (int t = threadIdx.x; t < rcount; t += blockDim.x)\n"
           "      raw[t] = reinterpret_cast<const unsigned char*>(a.rc)"
           "[rfirst + t];\n"),
          (_WCOPY, "      *reinterpret_cast<uint4*>(d) =\n"
                   "          *reinterpret_cast<const uint4*>(s);\n")]
_STAGE = ("  for (int v = threadIdx.x; v < (head + count + 15) >> 4; "
          "v += blockDim.x) {")
_ROWS = "  for (int v = threadIdx.x; v < kr * 16; v += blockDim.x) {"
_NOSTAGE = [(_STAGE, _STAGE.replace("v < (head", "v < 0 * (head")),
            (_ROWS, _ROWS.replace("v < kr * 16", "v < 0 * kr"))]
_STEPS = "  for (int kb = 0; kb < kv; kb += 16) {"
_NOSTEPS = [(_STEPS, _STEPS.replace("kb < kv", "kb < 0 * kv"))]
_MIX = ("        mix<IQ>(xr, xi, ck[k + e], sk[k + e], cj[r & 1], sj[r & 1], "
        "wc[e],\n                ws[e]);\n")
_ENTRY = "  const int nd = 2 * a.smax + 1;                   // band lags\n"
_PHI = ("      sincosf(__fmul_rn(kTwoPi, __fmul_rn(f, (float)t)), &sjs[t], "
        "&cjs[t]);\n")
_THETA = "      sincosf(__fmul_rn(kTwoPi, ph), &sk[k], &ck[k]);\n"
_CONVERT = "  for (int v = tid; v < kr * kQuads; v += blockDim.x) {"
_BAND = ("        if (d >= 0 && d < nd) ub[(cs * 16 + jj) * nd + d] = "
         "acc[cs][n][e];\n")
_TAPSUMS = "  for (int t = lane; t < 2 * a.ntaps; t += 32) {"


def _set(line: str, value) -> list:
    """Replace the constant of ``line`` ("constexpr T name = v;")."""
    return [(line, line.rsplit("=", 1)[0] + f"= {value};")]


VARIANTS = {
    "mma": _PLAIN + _set(_CLUSTER, 1),
    "async": _set(_CLUSTER, 1),
    "kernel": [],
    **{f"S{c}": _set(_CLUSTER, c) for c in (1, 2, 4)},
    "B3": [("__launch_bounds__(kThreads, 2)\ngram_taps_mma_kernel",
            "__launch_bounds__(kThreads, 3)\ngram_taps_mma_kernel")],
    "nomix": [(_MIX, "        wc[e] = xr;\n        ws[e] = xr - xi;\n")],
    "noangles": [(_PHI, "      sjs[t] = f;\n      cjs[t] = r0;\n"),
                 (_THETA, "      sk[k] = ph;\n      ck[k] = r0;\n")],
    "noconvert": [(_CONVERT, _CONVERT.replace("v < kr", "v < 0 * kr"))],
    "noband": [(_BAND, _BAND.replace("d < nd)", "d < nd && nd < 0)")),
               (_TAPSUMS, _TAPSUMS.replace("t < 2", "t < 0 * 2"))],
    "nostage": _NOSTAGE,
    "nocompute": _NOSTEPS,
    "empty": _NOSTAGE + _NOSTEPS,
    "launch": [(_ENTRY, _ENTRY + "  if (nd > 0) return;\n")],
}
# the variants that compute the function (the others take work away); v1
# is the wrapper's library's own entry point
SAME = ("v1", "mma", "async", "kernel", "S1", "S2", "S4", "B3")


def inputs(device, iq: bool, seed: int = 23, corr=(6, 3, 6)):
    """Phase 3's K2 inputs: K3's windows (``profile_window.inputs``, at
    ``corr``) fetched into masked (B, 128, 128) bf16 rows by the fused
    backend's fetch.  Returns (trk, the largest window L1 norm, the valid
    lengths as numpy int32, [win_i, win_q or None, rc, rem, ftot] on
    ``device``)."""
    trk, l1, (win, rc, rem, ftot, n), _ = window_inputs(device, "f32", iq,
                                                        seed=seed, corr=corr)
    fast = FastTracker(trk)
    w = torch.from_numpy(win.reshape((-1,) + win.shape[2:])).to(device)
    starts = torch.arange(len(n), dtype=torch.int32,
                          device=device) * trk.nwin
    rows = fast._fetch_windows(fast._block_rows(w), starts, rowform=True,
                               nvalid=torch.from_numpy(n).to(device))
    wi, wq = rows if iq else (rows, None)
    return trk, l1, n, [wi, wq] + [torch.from_numpy(a).to(device)
                                   for a in (rc, rem, ftot)]


def tolerance(l1: float) -> float:
    """Phase 3's tolerance: the mixed samples keep the plain version's
    bf16 values (the same precise carrier and products), so only the
    summation order differs; 1e-4 of the largest window L1 norm, K3's
    bound, which also covers a flipped bf16 rounding."""
    return 1e-4 * l1


def variant_source(name: str) -> str:
    """``csrc/gram_taps.cu`` with variant ``name``'s replacements, built
    for 7 n-tiles (and v1 for 13 taps) only; raises if a replaced line is
    not in the source."""
    return apply_variant(cuda_build.source("gram_taps"),
                         VARIANTS[name] + [(TAPS_ALL, TAPS13), (
                             _TILES_ALL,
                             f"#define TILE_CASES(X) X({TILES})")],
                         f"profile_gram: variant {name}")


_LIBS = {}          # variant -> (loaded library, ptxas output), per process


def build(names) -> dict:
    """Build every variant of ``names`` not built yet (one nvcc each, in
    parallel) and load it: {name: ctypes library}."""
    todo = {n: variant_source(n) for n in names if n not in _LIBS}
    for name, (lib, text) in compile_sources(todo, OUT,
                                             "profile_gram").items():
        lib.gram_taps_launch.argtypes = gt.LAUNCH_ARGTYPES
        lib.gram_taps_launch.restype = ctypes.c_int
        _LIBS[name] = (lib, text)
    return {name: _LIBS[name][0] for name in names}


def registers(text: str, iq: bool, kernel: str = "gram_taps_mma_kernel",
              inst: str = f"ILi{TILES}E") -> str:
    """ptxas's registers and spills of ``kernel``'s instantiation ``inst``
    (real or ``iq``) in the compiler output ``text``."""
    want = f"{kernel}{inst}Lb{int(iq)}E"
    entry, found = "", {}
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif want in entry:
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m:
                found["spill"] = int(m[1])
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                found["regs"] = int(m[1])
    return f"{found.get('regs', '?')} regs, {found.get('spill', '?')} B spill"


def launcher(lib, offsets, smax: int, out):
    """``fn(args)``: launch ``lib``'s banded-Gram kernel on ``args``
    (win_i, win_q, rc, rem, ftot) into ``out`` as
    :func:`gram_taps.launch` does."""
    offsets = tuple(int(o) for o in offsets)
    offs = device_offsets(offsets, out.device)

    def fn(a):
        wi, wq, rc, rem, ftot = a
        tiles = len(gt.tile_plan(wi.shape[1], smax)[0])
        err = lib.gram_taps_launch(
            int(wq is not None), wi.data_ptr(),
            None if wq is None else wq.data_ptr(), wi.shape[1],
            rc.data_ptr(), rc.shape[1], rem.data_ptr(), ftot.data_ptr(),
            offs.data_ptr(), len(offsets), smax, tiles, wi.shape[0],
            out.data_ptr(), stream_of(out.device))
        if err:
            raise RuntimeError(f"profile_gram: launch failed (cudaError "
                               f"{err})")
    return fn


def profile(iq: bool = False, rounds: int = 5, log=print) -> dict:
    """Build (once per process) and time every variant, real or ``iq``;
    returns {variant: {"ms", "err" (SAME only), "regs"}}."""
    dev = torch.device("cuda")
    t0 = time.time()
    build(VARIANTS)
    built = time.time() - t0
    trk, l1, _, args = inputs(dev, iq)
    offsets, smax = trk.offsets, trk.smax
    if len(gt.tile_plan(args[0].shape[1], smax)[0]) != TILES:
        raise AssertionError(f"profile_gram: smax {smax} is not the "
                             f"{TILES}-tile geometry")
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if a is not None)
    copies = [[None if a is None else a.clone() for a in args]
              for _ in range(copies_for(nbytes))]
    zp = gt.gram_taps_plain(*args, offsets, smax)
    out = torch.empty_like(zp)
    tol = tolerance(l1)
    fns = {"v1": lambda a: gt.launch_v1(*a, offsets, smax, out)}
    fns.update({name: launcher(lib, offsets, smax, out)
                for name, (lib, _) in _LIBS.items() if name in VARIANTS})
    res = {}
    for name in SAME:
        fns[name](args)
        torch.cuda.synchronize()
        err = float((out - zp).abs().max())
        if not err <= tol:
            raise AssertionError(f"profile_gram: {'iq' if iq else 'real'} "
                                 f"variant {name} vs plain: max_abs_err "
                                 f"{err} > {tol}")
        res[name] = {"err": err}
    tag = "iq" if iq else "real"
    log(f"# {torch.cuda.get_device_name(dev)}: K2 variants built in "
        f"{built:.1f} s; {tag}, B={args[0].shape[0]} rows="
        f"{args[0].shape[1]}x128 next={trk.next} taps={len(offsets)} "
        f"n-tiles={TILES}; {', '.join(SAME)} match the plain version (tol "
        f"{tol:.4g}); device ms per launch (CUDA graph, inputs beyond L2 "
        f"over {len(copies)} copies)")
    for name, fn in fns.items():
        rec = res.setdefault(name, {})
        rec["ms"] = graph_ms(lambda c, fn=fn: fn(copies[c]), len(copies),
                             rounds=rounds)
        rec["regs"] = "" if name == "v1" else registers(_LIBS[name][1], iq)
    for name, rec in res.items():
        gap = rec["ms"] - res["kernel"]["ms"]
        log(f"{name:10s} {rec['ms']:8.4f} ms  ({gap:+.4f} vs kernel)  "
            f"{rec['regs']}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch.tools.profile_gram",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iq", action="store_true",
                    help="I/Q rows only (default: real and I/Q)")
    ap.add_argument("--rounds", type=int, default=5,
                    help="graph replays per variant (default 5)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_gram: no CUDA card", file=sys.stderr)
        return 2
    for iq in ((True,) if a.iq else (False, True)):
        profile(iq, a.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
