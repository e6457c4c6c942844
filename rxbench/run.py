"""The benchmark's entry point.

    python3 -m rxbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on one CUDA card and prints one JSON
object as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit (also the last lines of standard error).
Exits non-zero, printing no result, without a card, or when a module of
JAX or of the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process, one host thread for the math libraries: the receiver's host
# work is small arrays, and idle pool threads only contend with the main
# thread and the CUDA runtime's threads for the machine's few cores
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1"}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_process: float | None = None,
             bench: dict | None = None, base: str | None = None,
             max_jobs: int | None = None, log=print) -> dict:
    """One run of cell ``name``; returns the result object.  ``device``
    "cpu" drives the same run on the CPU, and ``bench``, ``base`` and
    ``max_jobs`` name another benchmark file's cell, the directory of its
    pieces and a cap on the window's jobs (tests only: the entry point
    refuses to run without a card)."""
    import numpy as np
    import torch
    from . import catalog, devtrace, harness
    t_process = T_PROCESS if t_process is None else t_process
    base = base or catalog.HERE
    cell = catalog.cell(name, bench, base)
    limits = cell.limits
    run = harness.Run(cell, seed, device)
    cuda = device == "cuda"
    try:
        t = time.time()
        run.make_captures()
        t_caps = time.time() - t
        warm = run.warm()
        tracer = harness.Tracer(cell.mix.get("trace"), trace and cuda,
                                run.workdir)
        tracer.warm_up()
        from gnsslib_tpu_torch import native
        log(f"set-up: imports and card {t - t_process:.3f} s, captures "
            f"{t_caps:.3f} s, warm job {warm['t_end'] - warm['t0']:.3f} s; "
            f"native host decoders {native.available()}")
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - t_process
        log(f"card before the window: {harness.card_line()}"
            if cuda else "card: none (CPU run)")
        w0, w1 = run.window(seconds, tracer, max_jobs)
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        log(f"card after the window: {harness.card_line()}"
            if cuda else "card: none (CPU run)")
        summary = None
        path = tracer.export()
        if path is not None:
            summary = devtrace.reduce_trace(path, rename=_stage_of(run))
        numbers = run.judge()
    finally:
        run.close()
    jobs = run.jobs
    failed = sum(j["error"] is not None or any(
        j.get("numbers", {}).get(k, 0) > limits[k] for k in limits)
        for j in jobs)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = (bool(jobs) and all(j["error"] is None for j in jobs)
               and all(numbers[k] <= limits[k] for k in limits))
    for j in jobs:
        first = j["t_first_epoch"] and j["t_first_epoch"] - j["t0"]
        walls = [(round(g["precompiled"], 3),
                  {k: round(v, 3) for k, v in g["stage_wall"].items()})
                 for g in j.get("groups", [])]
        log(f"job {j['index']}: {j['seconds']:.2f} s of signal in "
            f"{j['t_end'] - j['t0']:.3f} s, completed {j['completed']}, "
            f"first epoch {first}, build and stages {walls}, "
            f"collect after {j.get('gc_s', 0.0):.3f} s, "
            f"numbers {j.get('numbers')}")
    metrics = {}
    if not trace:
        samples = sum(j["samples"] for j in jobs)
        e2e = {"rx_msps": samples / 1e6 / max(w1 - w0, 1e-9),
               "setup_s": setup_s}
        firsts = [j["t_first_epoch"] - j["t0"] for j in jobs
                  if j["t_first_epoch"] is not None]
        if firsts:
            e2e["first_epoch_s"] = float(np.mean(firsts))
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = dict(jobs=jobs, blocks=run.blocks, trace=summary)
        for m in cell.per_layer:
            v = catalog.reader(m["name"], base)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(jobs), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
        log(f"trace: {summary['kernels']} kernels, K1 launches "
            f"{summary['k1_launches']}, idle by host span "
            f"{summary['idle_by_span']}")
    out["checks"] = checks
    return out


def _stage_of(run):
    """Names a traced ``block.<i>`` span by its block's stage (steady when
    every group ran its steady program, else the earliest stage)."""
    def rename(span: str) -> str:
        if not span.startswith("block."):
            return span
        st = run.blocks[int(span.split(".")[1])]["stages"]
        for s in ("acquire", "pullin"):
            if s in st:
                return f"{s}_block"
        return "steady_block"
    return rename


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rxbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    os.environ.update(THREADS)
    try:
        import torch
    except ImportError as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    from . import catalog
    torch.set_num_threads(1)
    cell = catalog.cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: the cell needs {cell.chips} CUDA card(s); torch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), log=log)
    bad = __import__("rxbench.harness", fromlist=["x"]).forbidden_modules()
    if bad:
        print(f"error: modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
