"""Per-stage wall-time breakdown of the port's ``Receiver`` loop on the
``receiver_throughput`` capture (port of the JAX package's
``tools/profile_receiver.py``).

    python -m gnsslib_tpu_torch.tools.profile_receiver [--device cuda|cpu]
        [--sequential] [--nsteps N]

A warm pass first, then a second receiver whose stage boundaries are
wrapped to attribute wall time: the device cache's load and block cuts,
acquisition (dispatch and collect of the search), the tracking blocks
(dispatch and collect of the pull-in and steady programs), the host nav
and observable work, epoch emission and the block placement.

On a card a tracking block is one replayed CUDA graph and a search is a
queue of launches: both return once queued, so ``*.dispatch`` is launch
time and the device time lands in ``*.collect``, which copies the
telemetry or decisions to the host and so waits for the device.  A small
dispatch beside a large collect is a busy device, not an idle host.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import no_card
from . import receiver_throughput as rxt

# (object attribute of the receiver or "" for the receiver, method,
# label); the stages nest: acquire holds acq.dispatch, collect+feed holds
# the blocks' collects and nav+obs
STAGES = (
    ("cache", "_load", "cache.load"),
    ("cache", "get", "cache.get"),
    ("", "_try_acquire", "acquire"),
    # not rx._acq_search: replacing the override point would make the
    # receiver take the synchronous path; the Acquirer's own
    # dispatch/collect are timed instead
    ("acq", "search_dev_start", "acq.dispatch"),
    ("acq", "search_dev_collect", "acq.collect"),
    ("fast", "run_block_start", "fast.dispatch"),
    ("fast", "run_block_collect", "fast.collect"),
    ("trk", "run_block_start", "slow.dispatch"),
    ("trk", "run_block_collect", "slow.collect"),
    ("trk", "rebase", "rebase"),
    ("", "_feed_nav_and_obs", "nav+obs(host)"),
    ("", "_emit_epochs", "emit"),
    ("", "_place", "place"),
    ("", "_collect", "collect+feed"),
    ("", "_collect_acq", "acq.collect+apply"),
)


def instrument(rx, stages=STAGES) -> dict:
    """Wrap ``rx``'s stage methods in place; returns {label: [walls]},
    filled as the receiver runs."""
    T = {}

    def timed(obj, name, label):
        fn = getattr(obj, name)

        def wrap(*a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            T.setdefault(label, []).append(time.perf_counter() - t0)
            return r
        setattr(obj, name, wrap)

    for attr, name, label in stages:
        obj = getattr(rx, attr) if attr else rx
        if obj is not None:
            timed(obj, name, label)
    return T


def profile(pipeline: bool = True, nsteps: int = 400, *, device="cuda",
            capture=None) -> tuple:
    """(the timed run's summary, {label: [walls]}, its wall seconds)."""
    cap = rxt.default_capture() if capture is None else capture

    def build():
        return rxt.receiver(cap, device=device, pipeline=pipeline,
                            nsteps_per_block=nsteps)
    rx = build()
    rx.run_seconds()                      # warm pass
    rxt.close(rx)
    rx = build()
    T = instrument(rx)
    t0 = time.time()
    s = rx.run_seconds()
    total = time.time() - t0
    rxt.close(rx)
    s["device"] = rx.trk.device.type
    return s, T, total


def table(T: dict) -> list:
    """The stage table's lines, largest sum first."""
    out = []
    for k in sorted(T, key=lambda k: -sum(T[k])):
        v = np.asarray(T[k])
        tail = " ".join(f"{x:.4f}" for x in v[-3:])
        out.append(f"  {k:18s} {v.sum():7.3f}s  x{len(v):<5d} "
                   f"med {np.median(v):7.4f}  last3 [{tail}]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch.tools.profile_receiver",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--sequential", action="store_true",
                    help="pipeline=False (default: pipelined)")
    ap.add_argument("--nsteps", type=int, default=400,
                    help="code periods per block (default 400)")
    a = ap.parse_args(argv)
    if no_card(a.device, "profile_receiver"):
        return 2
    rxt.synthesize()
    s, T, total = profile(not a.sequential, a.nsteps, device=a.device)
    print(f"mode={'sequential' if a.sequential else 'pipelined'}/"
          f"{a.nsteps} [{s['device']}]  total {total:.2f}s for "
          f"{s['seconds']:.1f}s of signal ({s['msps']:.1f} Msps)  stage "
          f"walls: " + ", ".join(f"{k} {v:.2f}s"
                                 for k, v in s["stage_wall"].items()))
    print("\n".join(table(T)))
    print("note: *.dispatch is launch time (a replayed graph returns at "
          "once); the device time lands in *.collect, which waits for the "
          "block's telemetry.  Stages nest: acquire holds acq.dispatch, "
          "collect+feed holds the collects and nav+obs(host).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
