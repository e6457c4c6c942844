"""A 256-channel session of the port's real ``Receiver`` (port of the JAX
package's ``tools/receiver_256ch.py``).

    python -m gnsslib_tpu_torch.tools.receiver_256ch [--device cuda|cpu]

The receiver loop (host nav framers, epoch alignment, acquisition
retries included) at 8x the reference's NCH = 32 ceiling
(``bin/gnss-sdrcli.ini:5``): 256 channels as 8 copies of PRNs 1-32 on
the ``receiver_throughput`` capture of 12 satellites, so the steady state
tracks 96 locked channels while 160 keep the ACQSLEEP retry cadence.
RINEX stays off (8 channel sets give duplicate satellites per epoch, a
serving scenario, not one antenna's RINEX file); the epoch aligner and
nav decoders run.  A warm pass first, then a timed pass by a manual
``step_block`` loop.

Prints one JSON line: the steady stream rate (window average and median
block), the aggregate channel-samples per second (stream rate x 256), x
real time against the 32-channel envelope, the block programs' graph
pool and the peak device memory reserved; and a host-stage wall budget on
stderr.  ``GNSSLIB_256CH_NSTEPS`` (400) and ``GNSSLIB_256CH_DEPTH`` (2)
set the steps per block and the pipeline depth.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from . import no_card
from . import receiver_throughput as rxt
from .profile_receiver import instrument

NCOPIES = 8
# the host stages timed in the second pass (see profile_receiver)
STAGES = (
    ("", "_feed_nav_and_obs", "nav+obs(host)"),
    ("", "_emit_epochs", "emit(host)"),
    ("", "_collect", "collect+feed"),
    ("", "_collect_acq", "acq.collect+apply"),
    ("", "_try_acquire", "acq.dispatch"),
    ("fast", "run_block_collect", "fast.collect"),
)


def run(ncopies: int = NCOPIES, nsteps: int | None = None,
        depth: int | None = None, *, device="cuda", capture=None) -> dict:
    """The timed pass's numbers, its stage walls (``stages``, seconds)
    and ``events``."""
    import torch
    from ..track.program import CAPTURES
    nsteps = (int(os.environ.get("GNSSLIB_256CH_NSTEPS", "400"))
              if nsteps is None else nsteps)
    depth = (int(os.environ.get("GNSSLIB_256CH_DEPTH", "2"))
             if depth is None else depth)
    cap = rxt.default_capture() if capture is None else capture
    prns = [cap.prns[i % len(cap.prns)]
            for i in range(ncopies * len(cap.prns))]
    C = len(prns)

    def build():
        return rxt.receiver(cap, device=device, prns=prns,
                            nsteps_per_block=nsteps, pipeline_depth=depth)

    print(f"# building the {C}-channel receiver (pass 1 warms up)...",
          file=sys.stderr, flush=True)
    t0 = time.time()
    rx = build()
    s1 = rx.run_seconds()
    rxt.close(rx)
    print(f"# pass1 {time.time() - t0:.1f}s locked={len(s1['locked'])} "
          f"decoded={len(s1['decoded'])} epochs={s1['epochs']}",
          file=sys.stderr, flush=True)
    del rx
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ncap, pool = CAPTURES.captures, CAPTURES.pool_bytes
    t_build = time.time()
    rx = build()
    build_s = time.time() - t_build
    T = instrument(rx, STAGES)
    s = rxt.steady_loop(rx, depth)
    rxt.close(rx)
    wall = s["wall"]
    out = dict(metric="receiver_256ch", channels=C,
               locked=sum(ch.locked for ch in rx.channels),
               decoded=sum(bool(ch.nav.flagdec) for ch in rx.channels),
               epochs=rx.epochs_written,
               msps_lifecycle=round(rx.base / 1e6 / wall, 2),
               unit="Msamples/s", device=rx.trk.device.type,
               build_s=round(build_s, 2),
               captures=CAPTURES.captures - ncap,
               graph_pool_mb=round((CAPTURES.pool_bytes - pool) / 1e6, 1),
               peak_reserved_gb=(round(torch.cuda.max_memory_reserved()
                                       / 1e9, 2) if cuda else None),
               stage_wall=s["stage_wall"])
    rt_msps = rxt.F_SF / 1e6
    if s.get("msps_steady"):
        msps = s["msps_steady"]
        out["msps_steady_avg"] = round(msps, 2)
        out["aggregate_channel_msps"] = round(msps * C, 1)
        out["aggregate_x_32ch_realtime"] = round(
            msps * ncopies / rt_msps, 2)
    if s.get("msps_steady_p50"):
        p50 = s["msps_steady_p50"]
        out["msps_steady_p50"] = round(p50, 2)
        out["aggregate_p50_channel_msps"] = round(p50 * C, 1)
        out["aggregate_p50_x_32ch"] = round(p50 * ncopies / rt_msps, 2)
    out["stages"] = {k: round(float(np.sum(v)), 3) for k, v in T.items()}
    print("# host-stage budget (sum over run / per block):",
          file=sys.stderr)
    for k in sorted(T, key=lambda k: -sum(T[k])):
        v = np.asarray(T[k])
        print(f"#   {k:18s} {v.sum():7.2f}s x{len(v)}  "
              f"med {np.median(v) * 1e3:7.1f} ms", file=sys.stderr)
    out["events"] = rx.events
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch.tools.receiver_256ch",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    if no_card(a.device, "receiver_256ch"):
        return 2
    rxt.synthesize()
    out = run(device=a.device)
    out.pop("events")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
