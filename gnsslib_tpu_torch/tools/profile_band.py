"""Time the band correlator (K1) on the card against variants of its
source: its build steps and cluster sizes, and variants that each take one
cost away, at the receiver's shapes.

    python -m gnsslib_tpu_torch.tools.profile_band [--iq] [--rounds N]

The inputs are those of ``chip_smoke.py`` phase 3 (:func:`inputs`): one
super-step of 32 channels x 10 windows at 16.368 Msps with
``TrackConfig(6, 3, 6)`` (13 taps 3 samples apart, 16376-sample windows,
16412-byte replica rows), 8-bit-valued samples, +-1 replica rows, about
three channels in four active.  Each variant is ``csrc/band_taps.cu``
with a few lines replaced, built for 13 taps only by nvcc (all variants
in parallel) into ``build/gnsslib_tpu_torch/profile_band/``, and timed by
:func:`graph_ms`: launches replayed from one CUDA graph, inputs rotated
over copies beyond the L2 cache, so the time is the kernel's own:

    kernel     the cluster kernel as the receiver launches it (step 3)
    step1      build step 1: clusters of S CTAs per window, the replica
               bytes staged one per thread, one sample per thread (kJ = 1:
               per sample and tap one byte load and one conversion)
    step2      step 1 + each replica byte converted once per thread and
               reused across the taps (kJ = 33), still staged one byte per
               thread (step 3 adds the 16-byte asynchronous staging)
    S1 S4 S8   the kernel with 1, 4 or 8 CTAs per window (it has 2)
    iq64       the kernel with I/Q input held to 64 registers, as real
               input is (4 CTAs per SM; the kernel gives I/Q 80, 3 CTAs)
    iq128      the kernel with I/Q input given 128 registers (2 CTAs)
    nocarrier  the carrier's sincospif replaced by two multiply-adds
    nostage    no staging copies (the chain loop reads whatever shared
               memory holds for the replica)
    nocompute  no chain loop: the staging and the reduction only
    empty      neither: the window's scalars, the reduction of zeros, the
               cluster barriers and the row written
    launch     returns at once: the launch and CTA scheduling floor

The variants of SAME compute K1's function and are held against
``band_taps_plain`` (1e-5 of the largest window L1 norm) before they are
timed.  Differences between lines say what each step or part costs; the
parts overlap in time, so they need not add up.  Each line carries
ptxas's registers, stack frame and spill stores of the variant's 13-tap
instantiation for the input kind.  The tool needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time

import numpy as np
import torch

from .. import cuda_build
from ..constants import CodeType, DType
from ..ops import band_taps as bt
from ..ops.kernels import progression, stream_of
from ..track import TrackConfig, Tracker

F_SF, F_IF = 16.368e6, 4.092e6          # the receiver runs' sampling and IF
CHANNELS, WINDOWS = 32, 10               # one steady super-step
L2_BYTES = 50e6
OUT = cuda_build.BUILD_DIR / "profile_band"

_CARRIER = "  sincospif(2.f * (frac_f(__fmul_rn(f, fi)) + r0), sn, cs);\n"
_STAGE = "  for (int v = threadIdx.x; v < (head + count + 15) >> 4; v += blockDim.x) {"
_CHAIN = "    if (s0 < lim)\n      chain_taps<"
_ENTRY = "  float* o = a.out + (size_t)b * NV;\n"
_ASYNC = ("  rep += stage_async(smem, a.rc, a.rc_len, rfirst, nrep);\n"
          "  cp_async_wait_all();\n")
_BYTES = [(_ASYNC, "  for (int t = threadIdx.x; t < nrep; t += blockDim.x) {\n"
                   "    const long long k = rfirst + t;\n"
                   "    smem[t] = k >= 0 && k < a.rc_len ? a.rc[k] : 0;\n"
                   "  }\n")]
_KJ = "constexpr int kJ = 33;"
_CLUSTER = "constexpr int kCluster = 2;"
_NOSTAGE = [(_STAGE, _STAGE.replace("v < (head", "v < 0 * (head"))]
_NOCHAIN = [(_CHAIN, _CHAIN.replace("s0 < lim", "s0 < 0"))]
_BOUND = "NT <= 13 ? (IQ ? 3 : 4) : 2)"
VARIANTS = {
    "kernel": [],
    "step1": _BYTES + [(_KJ, "constexpr int kJ = 1;")],
    "step2": _BYTES,
    **{f"S{c}": [(_CLUSTER, f"constexpr int kCluster = {c};")]
       for c in (1, 4, 8)},
    "iq64": [(_BOUND, "NT <= 13 ? 4 : 2)")],
    "iq128": [(_BOUND, "NT <= 13 ? (IQ ? 2 : 4) : 2)")],
    "nocarrier": [(_CARRIER, "  *sn = fmaf(f, fi, r0);\n"
                             "  *cs = fmaf(r0, fi, f);\n")],
    "nostage": _NOSTAGE,
    "nocompute": _NOCHAIN,
    "empty": _NOSTAGE + _NOCHAIN,
    "launch": [(_ENTRY, _ENTRY + "  if (a.d > 0) return;\n")],
}
# the variants that compute K1's function (the others take work away)
SAME = ("kernel", "step1", "step2", "S1", "S4", "S8", "iq64", "iq128")
# the tap counts of a source's entry points, and of a variant's (13 only)
TAPS_ALL = ("#define TAP_CASES(X) X(1) X(3) X(5) X(7) X(9) X(11) X(13) "
            "X(15) X(17) \\\n                     X(19) X(21) X(23) X(25)")
TAPS13 = "#define TAP_CASES(X) X(13)"


def inputs(device, iq: bool, corr=(6, 3, 6), sf: float = F_SF,
           fif: float = F_IF, windows: int = WINDOWS,
           channels: int = CHANNELS):
    """Phase 3's super-step: (trk, host arrays (block, rc, wstart, n, rem,
    ftot, active), the same as tensors on ``device``).  ``corr`` (CORRN,
    CORRD, CORRP), ``sf``, ``fif``, ``windows`` (per channel) and
    ``channels`` give another front end's or channel count's super-step;
    the carrier spans the same +-6.5 kHz of Doppler at any rate."""
    trk = Tracker(TrackConfig(*corr), [1], [CodeType.L1CA], sf, fif,
                  DType.IQ if iq else DType.REAL, device=device)
    rng = np.random.default_rng(7 + iq)
    C, L, nn = channels, windows, trk.n_nom
    B = C * L
    nblock = (L + 2) * nn + trk.next
    block = rng.integers(-128, 128, (nblock, 2) if iq else nblock
                         ).astype(np.float32)
    wstart = (rng.integers(0, nn, C)[:, None] + 64
              + np.arange(L)[None, :] * nn).reshape(B).astype(np.int32)
    n = rng.integers(nn - 2, nn + 3, B).astype(np.int32)
    rem = rng.uniform(0, 1, B).astype(np.float32)
    ftot = (fif / sf + rng.uniform(-4e-4, 4e-4, B) * (F_SF / sf)
            ).astype(np.float32)
    rc = rng.choice(np.asarray([-1, 1], np.int8), (B, trk.next))
    act = np.repeat(rng.uniform(size=C) < 0.75, L)
    host = (block, rc, wstart, n, rem, ftot, act)
    return trk, host, [torch.from_numpy(a).to(device) for a in host]


def copies_for(nbytes: float) -> int:
    """Input copies whose total is at least twice the L2 cache."""
    return max(2, int(np.ceil(2 * L2_BYTES / nbytes)))


def graph_ms(fn_k, ncopy: int, reps: int = 60, rounds: int = 5) -> float:
    """Device milliseconds per ``fn_k(k)`` (call k reads input copy
    ``k % ncopy``): ``reps`` calls captured in one CUDA graph, the graph
    replayed between CUDA events ``rounds`` times, the median per call.
    The host takes no part in the replay, so this is the kernel's own time
    plus the graph's gap between back-to-back launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up outside the capture
        fn_k(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in range(reps):
            fn_k(r % ncopy)
    graph.replay()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def apply_variant(src: str, replacements, label: str) -> str:
    """``src`` with each (old, new) of ``replacements`` applied; raises if
    an old line is not exactly once in it."""
    for old, new in replacements:
        if src.count(old) != 1:
            raise RuntimeError(f"{label}: the line {old!r} is not once in "
                               f"the source")
        src = src.replace(old, new)
    return src


def variant_source(name: str) -> str:
    """``csrc/band_taps.cu`` (with ``csrc/launch.cuh`` inlined) with
    variant ``name``'s replacements, built for 13 taps only; raises if a
    replaced line is not in the source."""
    return apply_variant(cuda_build.source("band_taps"),
                         VARIANTS[name] + [(TAPS_ALL, TAPS13)],
                         f"profile_band: variant {name}")


def compile_sources(sources: dict, out, tool: str) -> dict:
    """Compile each ``{name: CUDA source text}`` into ``out/lib<name>.so``
    (one nvcc each, all started together, ``-Xptxas -v``) and load it:
    {name: (ctypes library, compiler output)}.  Raises after all have
    ended if any failed."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name, src in sources.items():
            (out / f"{name}.cu").write_text(src)
            procs[name] = subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                 str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        text, failed = {}, []
        for name, proc in procs.items():
            o, e = proc.communicate()
            text[name] = o + e
            if proc.returncode != 0:
                failed.append(f"{tool}: nvcc failed for {name}:\n"
                              f"{e[-4000:]}")
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {name: (ctypes.CDLL(str(out / f"lib{name}.so")), text[name])
            for name in sources}


_LIBS = {}          # variant -> (loaded library, ptxas output), per process


def build(names) -> dict:
    """Build every variant of ``names`` not built yet (one nvcc each, in
    parallel) and load it: {name: ctypes library}."""
    todo = {n: variant_source(n) for n in names if n not in _LIBS}
    for name, (lib, text) in compile_sources(todo, OUT,
                                             "profile_band").items():
        lib.band_taps_launch.argtypes = bt.LAUNCH_ARGTYPES
        lib.band_taps_launch.restype = ctypes.c_int
        lib.band_taps_ctas_per_window.restype = ctypes.c_int
        _LIBS[name] = (lib, text)
    return {name: _LIBS[name][0] for name in names}


def usage(text: str, iq: bool, ntaps: int = 13, entry: str = "cluster"
          ) -> dict:
    """ptxas's resource lines (``-Xptxas -v`` output ``text``) of the
    ``entry`` kernel's (``cluster`` or ``v1``) instantiation for ``ntaps``
    taps and ``iq``: {"regs", "stack", "spill_stores", "spill_loads"}
    (bytes; absent keys were not printed)."""
    want = f"band_taps_{entry}_kernelILi{ntaps}ELb{int(iq)}E"
    found, inside = {}, False
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            inside = want in ln
        elif inside:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m:
                found.update(stack=int(m[1]), spill_stores=int(m[2]),
                             spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                found["regs"] = int(m[1])
    return found


def usage_text(u: dict) -> str:
    return (f"{u.get('regs', '?')} regs, {u.get('stack', '?')} B stack, "
            f"{u.get('spill_stores', '?')} B spill")


def launcher(lib, offsets, smax: int, out, ok):
    """``fn(args)``: launch ``lib``'s cluster kernel on ``args`` (block,
    rc, wstart, n, rem, ftot, active) into ``out`` and ``ok`` as
    :func:`gnsslib_tpu_torch.ops.band_taps.launch` does."""
    offsets = tuple(int(o) for o in offsets)
    d = progression(offsets)
    dev = out.device

    def fn(a):
        block, rc, wstart, n, rem, ftot, act = a
        err = lib.band_taps_launch(
            block.data_ptr(), block.shape[0], int(block.dim() == 2),
            rc.data_ptr(), rc.shape[1], rc.shape[1] - 2 * smax,
            wstart.data_ptr(), n.data_ptr(), rem.data_ptr(), ftot.data_ptr(),
            act.data_ptr(), len(offsets), smax, d, rc.shape[0],
            out.data_ptr(), ok.data_ptr(), stream_of(dev))
        if err:
            raise RuntimeError(f"profile_band: launch failed (cudaError "
                               f"{err})")
    return fn


def tolerance(host, nwin: int) -> float:
    """1e-5 of the largest window L1 norm of ``host``'s (block, rc,
    wstart, n): each tap sums n products bounded by |x_i| (|replica| <= 1),
    and f32 rounding in either summation order stays below that."""
    block, _, wstart, n = host[:4]
    return 1e-5 * max([1.0] + [float(np.abs(block[w:w + k]).sum())
                               for w, k in zip(wstart, np.clip(n, 0, nwin))])


def profile(iq: bool = False, rounds: int = 5, log=print) -> dict:
    """Build and time every variant; returns {variant: ms per launch}."""
    dev = torch.device("cuda")
    t0 = time.time()
    libs = build(VARIANTS)
    trk, host, args = inputs(dev, iq)
    nbytes = sum(a.numel() * a.element_size() for a in args)
    copies = [[a.clone() for a in args] for _ in range(copies_for(nbytes))]
    zp, _ = bt.band_taps_plain(*args, trk.offsets, trk.smax)
    out = torch.empty_like(zp)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    tol = tolerance(host, trk.nwin)
    for name in SAME:
        launcher(libs[name], trk.offsets, trk.smax, out, ok)(args)
        err = float((out - zp).abs().max())
        if not (err <= tol and int(ok[0]) == 1):
            raise AssertionError(f"profile_band: variant {name} vs plain: "
                                 f"max_abs_err {err} > {tol} or ok flag "
                                 f"{int(ok[0])}")
    log(f"# {torch.cuda.get_device_name(dev)}: K1 variants built in "
        f"{time.time() - t0:.1f} s; {'iq' if iq else 'real'} input, "
        f"{int(host[6].sum())} of {len(host[6])} windows active, S="
        f"{libs['kernel'].band_taps_ctas_per_window()}; {', '.join(SAME)} "
        f"match the plain version (tol {tol:.4g}); device ms per launch "
        f"(CUDA graph, inputs beyond L2)")
    res = {}
    for name, lib in libs.items():
        fn = launcher(lib, trk.offsets, trk.smax, out, ok)
        res[name] = graph_ms(lambda k: fn(copies[k]), len(copies),
                             rounds=rounds)
        log(f"{name:10s} {res[name]:8.4f} ms  ({res[name] - res['kernel']:+.4f}"
            f" vs kernel; {usage_text(usage(_LIBS[name][1], iq))})")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch.tools.profile_band",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iq", action="store_true",
                    help="I/Q samples instead of real ones")
    ap.add_argument("--rounds", type=int, default=5,
                    help="graph replays per variant (default 5)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_band: no CUDA card", file=sys.stderr)
        return 2
    profile(a.iq, a.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
