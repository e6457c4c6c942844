"""Acquisition throughput of the port: Doppler bins per second for the
32-channel cold-start search (the BASELINE.md secondary metric; port of
the JAX package's ``tools/acq_throughput.py``).

    python -m gnsslib_tpu_torch.tools.acq_throughput [--device cuda|cpu]
        [--iters N] [--intg R]

The reference's workload per channel (BASELINE.md, sdr.h:141-149): 71
Doppler bins x 10 non-coherent 1 ms rounds, each round a carrier mix,
FFT/IFFT and magnitude squared, at the 16.368 Msps envelope.  The port
runs the whole (channels x rounds x bins) grid as one search over a flat
device-resident block (``Acquirer._rounds_from_flat`` and
``_search_rounds``, the counterparts of the JAX ``_search_flat``), 8 of
the 32 PRNs present in the signal.

Prints one JSON line: {"metric": "acq_doppler_bins_per_s", ...}, where a
bin is one (channel, round, Doppler) correlation (the reference's
innermost loop, sdracq.c:57-99), the best of ``--iters`` searches timed
by the host clock to a ``torch.cuda.synchronize`` (``seconds_per_search``)
and by CUDA events (``device_seconds_per_search``), and the PRNs the
search acquired.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import no_card

F_SF = 16.368e6
F_IF = 4.092e6
NCH = 32
NPRESENT = 8


def workload(intg: int = 10, *, device="cuda"):
    """(the 32-channel Acquirer, its flat float32 block on the device):
    ``intg`` + 2 code periods with PRNs 1-8 present."""
    import torch
    from .. import sim
    from ..acquire import Acquirer
    from ..constants import CodeType, DType
    prns = list(range(1, NCH + 1))
    acq = Acquirer(prns, [CodeType.L1CA] * NCH, F_SF, F_IF, DType.REAL,
                   device=device, intg=intg)
    chans = [sim.SimChannel(prn=p, doppler=137.0 * p - 2000.0,
                            code_phase=31.0 * p) for p in prns[:NPRESENT]]
    data = np.asarray(sim.synthesize(
        chans, F_SF, F_IF, DType.REAL, (intg + 2) * acq.nsamp,
        noise_std=2.0, seed=5), np.float32)
    return acq, torch.from_numpy(data).to(acq.device)


def search(acq, block):
    """One search of the whole grid -> (P, codei, freqi, cn0, peakr,
    confirmed) on the device."""
    return acq._search_rounds(acq._rounds_from_flat(block), acq._consts)


def run(iters: int = 10, intg: int = 10, *, device="cuda") -> dict:
    import torch
    acq, block = workload(intg, device=device)
    cuda = acq.device.type == "cuda"
    bins = NCH * acq.nfreq * intg            # (channel, round, bin) grid
    out = search(acq, block)                 # warm: FFT plans, allocator
    best = best_ev = None
    for _ in range(iters):
        if cuda:
            torch.cuda.synchronize(acq.device)
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
        t0 = time.perf_counter()
        out = search(acq, block)
        if cuda:
            ev1.record()
            torch.cuda.synchronize(acq.device)
            ev = ev0.elapsed_time(ev1) / 1e3
            best_ev = ev if best_ev is None else min(best_ev, ev)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    res = acq.postprocess(*[v.cpu().numpy() for v in out[1:]])
    # the reference must finish the grid well inside the 1 s of buffered
    # signal to keep up: bins per 1 s is its real-time envelope
    return dict(
        metric="acq_doppler_bins_per_s", value=round(bins / best, 1),
        unit="bins/s", vs_baseline=round(bins / best / float(bins), 2),
        bins=bins, nfreq=acq.nfreq, intg=intg, channels=NCH,
        seconds_per_search=round(best, 4),
        device_seconds_per_search=(round(best_ev, 5) if cuda else None),
        acquired=[int(p) for p in np.flatnonzero(res.acquired) + 1],
        device=acq.device.type)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch.tools.acq_throughput",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--intg", type=int, default=10,
                    help="non-coherent rounds (reference NINT=10)")
    a = ap.parse_args(argv)
    if no_card(a.device, "acq_throughput"):
        return 2
    print(json.dumps(run(a.iters, a.intg, device=a.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
