"""Time to first fix of the port's receiver: every cold-start stage of
the real ``Receiver`` on the ``receiver_throughput`` capture, in one fresh
process (port of the JAX package's ``tools/ttff.py``).

    python -m gnsslib_tpu_torch.tools.ttff [--device cuda|cpu]
        [--seconds S] [--twice] [--stream]

Stages, in wall seconds since t=0 (the clock restarts after the capture
is synthesized, which is reported apart as ``synth_harness_s``):

  attach        the first CUDA context on the card (torch's import is
                timed apart, ``torch_import_s``: the tool imports torch
                before synthesizing, to know whether there is a card)
  build         Receiver construction starts; ``build_s`` is its length:
                tables, the constants' upload, the kernels' load and the
                block programs' CUDA graph captures; ``nvcc_s`` lists the
                kernels nvcc built in this process (a cold build is a
                real TTFF cost on a card)
  precompiled   the block programs are built and captured
  first_block   first step_block returned
  first_lock    first channel accepted by acquisition
  first_sync    first nav bit sync
  steady        every locked channel synced: the steady programs run
  first_epoch   first observable epoch emitted (the RINEX TTFF)
  total_s       the whole run; msps_lifecycle = samples / 1e6 / the run's
                wall

Prints one JSON line.  ``--twice`` runs a second receiver in the same
process (everything warm).  ``--stream`` reads the capture as a live
stream that has ended, through the live cache (``io/devcache.py``
``LiveBlockCache``: each block's new samples read once and uploaded
through a pinned buffer) instead of holding it whole on the device; its
events and epochs equal the resident run's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from . import no_card
from . import receiver_throughput as rxt

# the receiver's milestones, in the order of a run (Receiver.timeline)
MILESTONES = ("precompiled", "first_block", "first_lock", "first_sync",
              "steady", "first_epoch")


class EndedStream:
    """A capture file presented as a live stream that has ended: the
    receiver reads a live front end through the live cache, and ``eof``
    lets it run to the capture's end, past which reads give zeros."""

    is_live = True
    eof = True

    def __init__(self, fe):
        self.fe = fe
        self.spec = fe.spec
        self.nsamples = fe.nsamples

    def read(self, start: int, n: int):
        return self.fe.read(start, n)

    def close(self) -> None:
        self.fe.close()


def run_once(t0: float, *, device="cuda", capture=None,
             stream: bool = False, label: str = "") -> dict:
    """One receiver built and run over the capture; stage times in
    seconds since ``t0``, the run's counts and its ``events``."""
    from .. import cuda_build
    cap = rxt.default_capture() if capture is None else capture
    with tempfile.TemporaryDirectory(prefix="gnsslib_torch_ttff_") as d:
        fe = rxt.frontend(cap)
        if stream:
            fe = EndedStream(fe)
        built = dict(cuda_build.build_info)
        t_build0 = time.time()
        rx = rxt.receiver(cap, fe, device=device, rinexdir=d)
        t_built = time.time()
        s = rx.run_seconds()
        rxt.close(rx)
        t_end = time.time()
    off = rx.timeline["t0"] - t0
    tl = {k: round(rx.timeline[k] + off, 2) for k in MILESTONES
          if k in rx.timeline}
    tl[f"{label}build"] = round(t_build0 - t0, 2)
    run_wall = t_end - rx.timeline["t0"]
    return dict(
        timeline=tl,
        build_s=round(t_built - t_build0, 2),
        nvcc_s={k: round(v[0], 1) for k, v in cuda_build.build_info.items()
                if k not in built},
        total_s=round(t_end - t0, 2),
        run_wall_s=round(run_wall, 2),
        msps_lifecycle=round(s["samples"] / 1e6 / max(run_wall, 1e-9), 2),
        msps_from_proc_start=round(s["samples"] / 1e6
                                   / max(t_end - t0, 1e-9), 2),
        stream_s=round(s["seconds"], 1),
        locked=len(s["locked"]), decoded=len(s["decoded"]),
        epochs=s["epochs"], stage_wall=s["stage_wall"],
        device=rx.trk.device.type, events=rx.events)


def attach(device: str) -> None:
    """The first CUDA context on the card (nothing on the CPU)."""
    import torch
    if device == "cuda":
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gnsslib_tpu_torch.tools.ttff",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seconds", type=float, default=None,
                    help="capture length (default: receiver_throughput's "
                    "20 s, or GNSSLIB_RXBENCH_SECONDS)")
    ap.add_argument("--twice", action="store_true",
                    help="run a second receiver in-process (warm)")
    ap.add_argument("--stream", action="store_true",
                    help="read the capture as an ended live stream through "
                    "the live cache instead of holding it on the device")
    a = ap.parse_args(argv)
    if a.seconds is not None:
        os.environ["GNSSLIB_RXBENCH_SECONDS"] = str(a.seconds)
    t_imp = time.time()
    import torch  # noqa: F401  (timed: the first import in this process)
    torch_import_s = round(time.time() - t_imp, 2)
    if no_card(a.device, "ttff"):
        return 2
    t_synth0 = time.time()
    rxt.synthesize()                  # harness cost, reported apart
    synth_s = round(time.time() - t_synth0, 2)
    # the clock restarts after the synthesis harness: on a cold capture
    # cache it costs minutes and must not inflate the stages
    t0 = time.time()
    attach(a.device)
    attach_s = round(time.time() - t0, 2)

    r1 = run_once(t0, device=a.device, stream=a.stream)
    r1.pop("events")
    out = dict(metric="ttff", unit="s",
               mode="stream" if a.stream else "resident",
               synth_harness_s=synth_s, torch_import_s=torch_import_s,
               attach_s=attach_s,
               **{k: v for k, v in r1.items() if k != "timeline"},
               **r1["timeline"])
    if a.twice:
        r2 = run_once(time.time(), device=a.device, stream=a.stream,
                      label="warm_")
        r2.pop("events")
        out["warm"] = dict(**{k: v for k, v in r2.items()
                              if k != "timeline"}, **r2["timeline"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
