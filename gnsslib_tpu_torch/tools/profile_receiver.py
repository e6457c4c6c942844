"""Per-stage wall-time breakdown of the port's ``Receiver`` loop on the
``receiver_throughput`` capture (port of the JAX package's
``tools/profile_receiver.py``).

    python -m gnsslib_tpu_torch.tools.profile_receiver [--device cuda|cpu]
        [--sequential] [--nsteps N] [--ini CONFIG.ini]

``--ini`` profiles the receiver of a configuration instead, as the CLI
builds it (``load_ini``, ``build_receiver`` on its FILE1/FILE2 captures):
a receiver of several channel groups (an SBAS deployment's GPS and SBAS
groups) prints each group's table.

A warm pass first, then a second receiver whose span table
(``Receiver.spans``, :mod:`gnsslib_tpu_torch.spans`) is printed: per
stage of ``step_block`` (acquire, pull-in, steady), outside it (other)
and for the build, each span's count, total, self time (its total less
its children's) and ms per block: the search's dispatch and collect, the
device cache, the tracking block's dispatch and collect (the telemetry's
wait and unpack, nav, the observable history, the epochs), the block
placement; on a card also ``dev.track`` and ``dev.acq``, the device time
of the block programs and the searches by CUDA events.  Beside the
waits, ``track.ready`` and ``acq.ready`` count the collects that found
their work done, of all the collects.  A group with SBAS channels adds
``nav.fec`` (each FEC predecode, with its preamble and CRC check while
the channel searches for a frame), ``sbas.send`` (each message framed and
sent) and the counters ``sbas.frames`` and ``sbas.crc_fail``.

On a card a tracking block is one replayed CUDA graph and a search is a
queue of launches: both return once queued, with their results' copy to
the host queued behind them, so ``*.dispatch`` is launch time and the
device's work shows in ``track.wait`` and ``acq.wait``, which wait for
that block's or search's own end event.  A small wait beside a large
device time, and collects mostly ready, are a host that kept the device
queued.
"""
from __future__ import annotations

import argparse
import sys
import time

from . import no_card
from . import receiver_throughput as rxt
from ..spans import STAGES, STEP, ready_of


def profile(pipeline: bool = True, nsteps: int = 400, *, device="cuda",
            capture=None, ini: str | None = None) -> tuple:
    """(the timed run's summary, with its span table in ``spans`` and,
    for several channel groups, each group's summary in ``groups``, and
    its wall seconds), on ``capture`` or on the configuration ``ini``."""
    cap = rxt.default_capture() if capture is None else capture

    def build():
        if ini is not None:
            return _configured(ini, device, pipeline, nsteps)
        return rxt.receiver(cap, device=device, pipeline=pipeline,
                            nsteps_per_block=nsteps)
    rx = build()
    rx.run_seconds()                      # warm pass
    _close(rx)
    t0 = time.time()
    rx = build()
    s = rx.run_seconds()
    total = time.time() - t0
    _close(rx)
    s["device"] = getattr(rx, "rx", [rx])[0].trk.device.type
    return s, total


def _configured(ini: str, device, pipeline: bool, nsteps: int):
    """The CLI's receiver of configuration ``ini`` on its file captures
    (RINEX and the TCP outputs as the configuration sets them)."""
    from ..io.frontend import FileFrontend
    from ..runtime.config import load_ini
    from ..runtime.receiver import build_receiver
    cfg = load_ini(ini)
    fts = sorted({c.ftype for c in cfg.channels})
    fes = {ft: FileFrontend(cfg.files[ft - 1], cfg.fends[ft - 1])
           for ft in fts}
    return build_receiver(cfg, fes, device=device, pipeline=pipeline,
                          nsteps_per_block=nsteps)


def _close(rx) -> None:
    """Flush and close a receiver and each of its groups' front ends."""
    rx.close()
    for g in getattr(rx, "rx", [rx]):
        g.frontend.close()


def tables(summary: dict) -> list:
    """:func:`table` of a run's summary: of each channel group under a
    header line where the receiver has several, else of the receiver."""
    groups = summary.get("groups")
    if not groups:
        return table(summary["spans"])
    out = []
    for k, g in enumerate(groups):
        out.append(f" group {k}: PRNs {g['locked']} locked, "
                   f"{g['decoded']} decoded")
        out += table(g["spans"])
    return out


def table(spans: dict) -> list:
    """The span table's lines: per stage, its spans by total."""
    out = []
    for st in STAGES:
        rows = spans["stages"].get(st)
        if not rows:
            continue
        nb = rows[STEP]["n"] if STEP in rows else 0
        out.append(f"  [{st}]" + (f" {nb} blocks" if nb else ""))
        for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["s"]):
            ready = ready_of(rows, name)
            if ready is not None:
                out.append(f"    {name:16s} x{ready[0]:<6d} of "
                           f"{ready[1]} collects "
                           f"({100.0 * ready[0] / ready[1]:.1f}%)")
                continue
            per = (f"  {1e3 * r['s'] / nb:8.3f} ms/block" if nb else "")
            out.append(f"    {name:16s} x{r['n']:<6d} {r['s']:8.3f}s  "
                       f"self {r['self_s']:8.3f}s{per}  in "
                       f"{r['parent'] or '-'}")
    for k, v in spans["counters"].items():
        out.append(f"  {k} {v}")
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
    ap.add_argument("--ini", default=None,
                    help="profile this configuration's receiver on its "
                    "captures (default: the throughput capture)")
    a = ap.parse_args(argv)
    if no_card(a.device, "profile_receiver"):
        return 2
    if a.ini is None:
        rxt.synthesize()
    s, total = profile(not a.sequential, a.nsteps, device=a.device,
                       ini=a.ini)
    print(f"mode={'sequential' if a.sequential else 'pipelined'}/"
          f"{a.nsteps} [{s['device']}]  total {total:.2f}s for "
          f"{s['seconds']:.1f}s of signal ({s['msps']:.1f} Msps)  stage "
          f"walls: " + ", ".join(f"{k} {v:.2f}s"
                                 for k, v in s["stage_wall"].items()))
    print("\n".join(tables(s)))
    print("note: *.dispatch is launch time (a replayed graph returns at "
          "once); the device's work shows in track.wait and acq.wait, "
          "which wait for the block's telemetry or the search's "
          "decisions (*.ready: the collects that did not wait), and in "
          "dev.* (CUDA events, on a card).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
