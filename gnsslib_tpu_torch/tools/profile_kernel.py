"""Time the correlator ablation (K6) on the card: K4's body and three
variants, each with one cost removed (port of the JAX package's
``tools/profile_kernel.py``).

    python -m gnsslib_tpu_torch.tools.profile_kernel [--device cuda|cpu]
        [--scan] [--reps N]

The shapes are the TPU tool's: B = 320 windows of nwin = 16493 samples,
float32 replica rows of W = nwin + 2*36 + 1664 = 18229 samples, 13 taps at
``range(-18, 19, 3)``; the inputs come from ``numpy.random.default_rng(0)``
as the TPU tool makes them.  Per variant (full, nosin, onetap, aligned)
it prints the milliseconds per wrapper call (CUDA events over back-to-back
calls on the same inputs) and, on the card, the device time per launch
of the cluster kernel the wrapper launches and of the v1 kernel
(``ablation_taps_v1_launch``), each replayed from one CUDA graph with the
inputs rotated over copies beyond the L2 cache
(:func:`.profile_band.graph_ms`).  ``--scan`` adds the counterpart of the TPU
tool's ``scan_test``: 100 iterations, each launching the variant on
``rem + c * 1e-9`` and feeding ``c += sum(taps) * 1e-30`` to the next, run
once eagerly and once replayed from one captured CUDA graph; the gap
between the two is the launch overhead per iteration.  The tool runs on
the card unless ``--device cpu`` is given (the plain versions; no graph);
it fails when the card is asked for and absent.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops import ablation_taps as ab
from .profile_band import copies_for, graph_ms

B, NWIN, SMAX = 320, 16493, 36
OFFSETS = tuple(range(-18, 19, 3))      # 13 taps, CORRD = 3 spacing
ITERS = 100                             # iterations of the scan test


def inputs(device, B: int = B, nwin: int = NWIN, smax: int = SMAX):
    """(win, rc, rem, ftot, n) on ``device``, made as the TPU tool makes
    them; W = nwin + 2*smax + 1664."""
    W = nwin + 2 * smax + 1664
    rng = np.random.default_rng(0)
    win = rng.integers(-8, 8, (B, nwin)).astype(np.float32)
    rc = rng.choice([-1.0, 1.0], (B, W)).astype(np.float32)
    rem = rng.random(B).astype(np.float32)
    ftot = (0.25 + 0.01 * rng.random(B).astype(np.float32)).astype(np.float32)
    n = np.full(B, nwin - 80, np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (win, rc, rem, ftot, n))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device, reps: int) -> float:
    """Milliseconds per ``fn()`` over ``reps`` back-to-back calls after
    one warm-up call: CUDA events on the card, the host clock on the
    CPU."""
    fn()
    _sync(device)
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _scan_body(args, variant: str, iters: int, c):
    win, rc, rem, ftot, n = args
    for _ in range(iters):
        z = ab.ablation_taps(win, rc, rem + c * 1e-9, ftot, n, OFFSETS, SMAX,
                             variant)
        c = c + z.sum() * 1e-30
    return c


def scan(args, variant: str, device, iters: int = ITERS, reps: int = 3):
    """(eager ms/iter, graph ms/iter or None on the CPU) of ``iters``
    chained launches of ``variant``."""
    c0 = torch.zeros((), dtype=torch.float32, device=device)
    eager = _time(lambda: _scan_body(args, variant, iters, c0), device,
                  reps) / iters
    if device.type != "cuda":
        return eager, None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):       # warm-up before capture
        _scan_body(args, variant, 2, c0)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c_out = _scan_body(args, variant, iters, c0)
    graph.replay()
    _sync(device)
    if not torch.isfinite(c_out).item():
        raise RuntimeError(f"scan {variant}: the graph's sum is not finite")
    return eager, _time(graph.replay, device, reps) / iters


def replay_ms(args, variant: str, rounds: int = 5) -> tuple:
    """(cluster kernel, v1 kernel) device ms per launch of ``variant`` on
    ``args``: launches replayed from one CUDA graph, inputs rotated over
    copies beyond the L2 cache.  Launches by :func:`ablation_taps.launch`
    and :func:`ablation_taps.launch_v1`, which count nothing."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    copies = [[a.clone() for a in args] for _ in range(copies_for(nbytes))]
    out = torch.empty((args[0].shape[0], 2 * len(OFFSETS)),
                      dtype=torch.float32, device=args[0].device)
    return tuple(
        graph_ms(lambda c, fn=fn: fn(variant, *copies[c], OFFSETS, SMAX, out),
                 len(copies), rounds=rounds)
        for fn in (ab.launch, ab.launch_v1))


def profile(device="cuda", reps: int = 10, scan_test: bool = True,
            B: int = B, nwin: int = NWIN, iters: int = ITERS,
            log=print) -> dict:
    """Time every variant; returns {variant: {"ms" (per wrapper call),
    "graph_ms", "v1_graph_ms" (device ms per launch of the cluster and the
    v1 kernel by graph replay; None on the CPU), "eager_ms_per_iter",
    "graph_ms_per_iter" (None without ``scan_test`` or on the CPU),
    "launches" (cluster-kernel launches of the wrapper calls this call
    made, graph capture included, replays not), "v1" (the wrapper's v1
    launches), "plain" (plain-version calls)}}.  Raises on the first
    variant that fails."""
    device = torch.device(device)
    args = inputs(device, B, nwin)
    W = args[1].shape[1]
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    log(f"# {where}: B={B} nwin={nwin} W={W} taps={len(OFFSETS)}")
    out = {}
    for v in ab.VARIANTS:
        before = ab.COUNTS[v].values()
        z = ab.ablation_taps(*args, OFFSETS, SMAX, v)
        _sync(device)
        if not torch.isfinite(z).all():
            raise RuntimeError(f"{v}: non-finite taps")
        ms = _time(lambda: ab.ablation_taps(*args, OFFSETS, SMAX, v), device,
                   reps)
        rec = {"ms": ms, "graph_ms": None, "v1_graph_ms": None,
               "eager_ms_per_iter": None, "graph_ms_per_iter": None}
        line = f"{v:8s} {ms:8.4f} ms per {B}-window wrapper call"
        if device.type == "cuda":
            rec["graph_ms"], rec["v1_graph_ms"] = replay_ms(args, v)
            line += (f"; device ms per launch (graph replay, beyond L2): "
                     f"kernel {rec['graph_ms']:.4f}, v1 "
                     f"{rec['v1_graph_ms']:.4f}")
        if scan_test:
            rec["eager_ms_per_iter"], rec["graph_ms_per_iter"] = scan(
                args, v, device, iters)
            line += (f"; scan of {iters}: eager "
                     f"{rec['eager_ms_per_iter']:.4f} ms/iter")
            if rec["graph_ms_per_iter"] is not None:
                line += f", CUDA graph {rec['graph_ms_per_iter']:.4f} ms/iter"
        after = ab.COUNTS[v].values()
        rec["launches"] = after["kernel"] - before["kernel"]
        rec["v1"] = after["v1"] - before["v1"]
        rec["plain"] = after["plain"] - before["plain"]
        log(line)
        out[v] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch.tools.profile_kernel",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--scan", action="store_true",
                    help="add the chained eager vs CUDA-graph scan test")
    ap.add_argument("--reps", type=int, default=10,
                    help="timed launches per variant (default 10)")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("profile_kernel: no CUDA card (use --device cpu for the plain "
              "versions on the CPU)", file=sys.stderr)
        return 2
    profile(a.device, a.reps, a.scan)
    return 0


if __name__ == "__main__":
    sys.exit(main())
