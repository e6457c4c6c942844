"""Readings of the compared numbers over many seeds in one process, and of
the control: the plain reference put in the receiver's place and worked
out in float32, the precision below the float64 in which the receiver
states its observables and times (RINEX pseudoranges to the millimetre):
the chips a satellite has sent since the nav stream's start, the count
the tracker keeps, rounded to float32.
The limits in ``rxbench/limits/<cell>.json`` are set from these.

    python3 -m rxbench.readings --workload <cell> --seconds <s> \\
        --seeds 11,12,... [--control 3] [--k1 bf16,prompt0,late0] \\
        [--acq dflip] [--out readings.jsonl]

Each seed runs the cell's window as a benchmark run does (its captures,
its jobs, at the cell's own size); the first ``--control`` seeds also give
the control's numbers for the same jobs, and the window's numbers once
more for each ``--k1`` fault planted under the steady tracker's
correlator (:data:`K1_FAULTS`), and for each ``--acq`` fault planted on
the acquisition's decisions (:data:`ACQ_FAULTS`) over one job of each
capture.  One JSON line per seed.  The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def control_numbers(run) -> dict:
    """The control's numbers over ``run``'s judged jobs: each job's
    acquisition decisions and pseudoranges worked out from the truth in
    float32 and judged against the float64 reference."""
    from . import truth
    tot = dict(acq_bad=0, obs_miss=0, pr_err_m=0.0)
    f_sf = run.spec.f_sf
    for rec in run.jobs:
        if rec["error"] is not None:
            continue
        sk = run.captures[rec["index"] % len(run.captures)][0]
        ctl = dict(rec)
        ctl["acq"] = [(p, k, round(truth.code_boundary(
            sk.by_prn(k, p), at, f_sf, np.float32)) if sk.by_prn(k, p)
            else c, d, at) for p, k, c, d, at in rec["acq"]]
        ctl["rinex_obs"] = truth.control_observables(rec, sk, np.float32)
        bad, _, _ = truth.judge_acq(ctl, sk, f_sf)
        miss, pr = truth.judge_obs(ctl, sk)
        tot["acq_bad"] += bad
        tot["obs_miss"] += miss
        tot["pr_err_m"] = max(tot["pr_err_m"], pr)
    return tot


K1_FAULTS = {
    # K1's sums rounded to bfloat16, the precision below their float32
    "bf16": lambda z, offs: z.to(torch.bfloat16).to(z.dtype),
    # the prompt tap's sums left out
    "prompt0": lambda z, offs: _zero(z, [offs.index(0)]),
    # every late tap's sums left out
    "late0": lambda z, offs: _zero(z, [i for i, o in enumerate(offs)
                                       if o > 0]),
}


def _zero(z, taps):
    z = z.clone()
    for i in taps:
        z[:, 2 * i:2 * i + 2] = 0.0
    return z


def planted_k1(kind: str):
    """Plants ``K1_FAULTS[kind]`` on the correlator that the steady
    tracker calls (the receivers built after this capture it into their
    graphs); returns the function that takes it out."""
    from gnsslib_tpu_torch.track import fast
    real = fast.band_taps
    fault = K1_FAULTS[kind]

    def band_taps(block, rc, wstart, n, rem, ftot, active, offsets, smax):
        z2, ok = real(block, rc, wstart, n, rem, ftot, active, offsets,
                      smax)
        return fault(z2, [int(o) for o in offsets]), ok
    fast.band_taps = band_taps

    def restore():
        fast.band_taps = real
    return restore


def _flip_doppler(res):
    """The decisions' Doppler taken with the wrong sign (the image of the
    carrier about the IF)."""
    res.dcarr = -res.dcarr
    return res


ACQ_FAULTS = {"dflip": _flip_doppler}


def planted_acq(kind: str):
    """Plants ``ACQ_FAULTS[kind]`` on the search's decisions as the
    acquisition hands them to the receiver; returns the function that
    takes it out."""
    from gnsslib_tpu_torch.acquire.search import Acquirer
    real = Acquirer.postprocess
    fault = ACQ_FAULTS[kind]

    def postprocess(self, *a, **k):
        return fault(real(self, *a, **k))
    Acquirer.postprocess = postprocess

    def restore():
        Acquirer.postprocess = real
    return restore


def _window(cell, seed, device, seconds, warm: bool, max_jobs=None):
    from . import harness
    run = harness.Run(cell, seed, device)
    try:
        run.make_captures()
        if warm:
            run.warm()
        run.window(seconds, harness.Tracer(None, False, run.workdir),
                   max_jobs)
        run.numbers = run.judge()
    except BaseException:
        run.close()
        raise
    return run


def _jobs(run) -> list:
    return [dict(index=j["index"], seconds=j["seconds"],
                 completed=j["completed"], error=j["error"],
                 numbers=j.get("numbers")) for j in run.jobs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rxbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--k1", default="")
    ap.add_argument("--acq", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    from . import catalog, harness
    if a.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    cell = catalog.cell(a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    out = open(a.out, "a") if a.out else None
    faults = [k for k in (a.k1 or "").split(",") if k]
    acq_faults = [k for k in (a.acq or "").split(",") if k]
    for i, seed in enumerate(seeds):
        t0 = time.time()
        run = _window(cell, seed, a.device, a.seconds, i == 0)
        try:
            row = dict(workload=a.workload, seed=seed, numbers=run.numbers,
                       jobs=_jobs(run), wall=time.time() - t0)
            if i < a.control:
                row["control"] = control_numbers(run)
        finally:
            run.close()
        for kind in faults if i < a.control else ():
            restore = planted_k1(kind)
            try:
                bad = _window(cell, seed, a.device, a.seconds, False)
            finally:
                restore()
            try:
                row.setdefault("k1", {})[kind] = dict(
                    numbers=bad.numbers, jobs=_jobs(bad))
            finally:
                bad.close()
        for kind in acq_faults if i < a.control else ():
            restore = planted_acq(kind)
            try:
                bad = _window(cell, seed, a.device, a.seconds, False,
                              int(cell.mix["captures"]))
            finally:
                restore()
            try:
                row.setdefault("acq", {})[kind] = dict(
                    numbers=bad.numbers, jobs=_jobs(bad))
            finally:
                bad.close()
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
