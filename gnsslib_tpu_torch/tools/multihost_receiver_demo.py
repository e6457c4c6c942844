"""Two-process whole-receiver demo (port of the JAX package's
``tools/multihost_receiver_demo.py``, on ``torch.distributed``): the
complete acquisition -> tracking -> nav decode -> observables -> RINEX
pipeline with the channel axis sharded over a global mesh of 2 processes
x 2 shards.

    python -m gnsslib_tpu_torch.tools.multihost_receiver_demo
        [--device cuda|cpu] [--outdir DIR] [--capture PATH]

Every process runs the same :class:`~..runtime.receiver.Receiver` (the
JAX package's multi-controller contract): each runs its shards' block
programs (on the card, both processes on ``cuda:0`` of a one-card
machine), the telemetry and acquisition decisions are all-gathered, and
the deterministic host logic (framers, epoch aligner) replays alike in
both; process 0 alone plays the reference sync thread's role and writes
RINEX (src/sdrsync.c:49-135).  The capture (4 GPS L1CA satellites,
16 s at 4.092 Msps, the JAX demo's construction from the port's own
``sim``) is written once under the temporary directory (``--capture``
names another file of the same signal).

Each process writes ``proc<N>.json`` (locks, decodes, events, epochs,
its K1 launches) into the output directory; with ``--outdir`` the
directory is kept.  Prints ``MULTIHOST RECEIVER OK`` when both processes
locked and decoded every satellite with the same events and process 0
alone wrote RINEX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from . import free_port, no_card, run_workers

NPROC = 2
PER_PROCESS = 2
F_SF, F_IF = 4.092e6, 1.023e6
PRNS = [2, 5, 9, 12]
SECONDS = 16.0          # 6 s bit-sync pad + 2 LNAV frames + margin
TIMEOUT_S = 120.0


def capture_path() -> str:
    return os.path.join(tempfile.gettempdir(), "gnsslib_torch_mh_rx.bin")


def satellites() -> list:
    """The demo's satellites (``sim.SimChannel``): LNAV frames after 6 s
    of padding bits."""
    import numpy as np
    from .. import sim
    chans = []
    for p in PRNS:
        eph = sim.example_eph(prn=p, week=2200, toe_tow=352800.0)
        frames = sim.lnav_bit_stream(eph, 352806.0, nframes=3)
        pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
        chans.append(sim.SimChannel(
            prn=p, doppler=300.0 * p - 1500.0, code_phase=40.0 * p,
            nav_bits=np.concatenate([pad, frames])))
    return chans


def make_capture() -> str:
    """Write the demo's capture once (int8, the JAX demo's construction
    and bytes); returns its path."""
    from .. import sim
    from ..constants import DType
    path = capture_path()
    if os.path.exists(path):
        return path
    chans = satellites()
    noise = sim.noise_std_for_cn0(1.0, 46.0, F_SF, DType.REAL)
    n = int(SECONDS * F_SF)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            step = int(F_SF)
            for t0 in range(0, n, step):
                x = sim.synthesize(chans, F_SF, F_IF, DType.REAL,
                                   min(step, n - t0), noise_std=noise,
                                   seed=77 + t0, t0=t0)
                sim.quantize_int8(x, 16.0).tofile(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def receiver(path: str, device, mesh=None, rinex: bool = False,
             outdir: str = "", **kw):
    """The demo's receiver on ``path`` (``kw``: Receiver options)."""
    from ..constants import DType, FrontendType
    from ..io.frontend import FileFrontend, FrontendSpec
    from ..runtime.config import ChannelConfig, ReceiverConfig
    from ..runtime.receiver import Receiver
    from ..track.state import TrackConfig
    spec = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9, f_sf=F_SF,
                        f_if=F_IF, dtype=DType.REAL)
    cfg = ReceiverConfig(
        channels=[ChannelConfig(prn=p) for p in PRNS], fends=[spec],
        files=[path], track=TrackConfig(corrn=4, corrd=2, corrp=2),
        outms=400, rinex=rinex, rinexpath=outdir)
    return Receiver(cfg, FileFrontend(path, spec), device=device,
                    mesh=mesh, **kw)


def summary(rx) -> dict:
    return dict(locked=sorted(ch.cfg.prn for ch in rx.channels if ch.locked),
                decoded=sorted(ch.cfg.prn for ch in rx.channels
                               if ch.nav.flagdec),
                events=[list(e) for e in rx.events],
                epochs=rx.epochs_written, ephs=rx.ephs_written)


def worker(pid: int, coord: str, outdir: str, device: str,
           capture: str) -> int:
    import torch
    from ..ops import kernels
    from ..parallel import distributed as dd

    if device == "cpu":
        torch.set_num_threads(2)
    dd.init_distributed(coord, NPROC, pid, timeout_s=TIMEOUT_S)
    assert dd.process_count() == NPROC
    if device == "cuda":
        dd.build_kernels()
    mesh = dd.global_mesh(per_process=PER_PROCESS, device=device)
    t0 = time.time()
    rx = receiver(capture, dd.local_device(device), mesh,
                  rinex=dd.is_output_host(), outdir=outdir)
    before = kernels.snapshot()
    rx.run_seconds()
    rx.close()
    k1 = kernels.since(before).get("band_taps", {})
    res = dict(summary(rx), pid=pid, device=rx.trk.device.type,
               k1_launches=k1.get("kernel", 0), k1_plain=k1.get("plain", 0),
               wall=time.time() - t0)
    with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
        json.dump(res, f)
    dd.shutdown()
    return 0


def launch(outdir: str, *, device: str = "cuda",
           capture: str | None = None) -> list:
    """Run the demo's processes on ``capture`` (by default the demo's own,
    written first if absent); returns each process's ``proc<N>.json`` as
    a dict."""
    capture = capture or make_capture()
    coord = f"127.0.0.1:{free_port()}"
    argv = ["gnsslib_tpu_torch.tools.multihost_receiver_demo", "--coord",
            coord, "--outdir", outdir, "--device", device, "--capture",
            capture]
    res = run_workers([argv + ["--pid", str(p)] for p in range(NPROC)],
                      timeout=10 * TIMEOUT_S)
    bad = [(p, rc) for p, (rc, _) in enumerate(res) if rc != 0]
    if bad:
        raise RuntimeError(f"demo processes failed (process, exit code): "
                           f"{bad}")
    out = []
    for p in range(NPROC):
        with open(os.path.join(outdir, f"proc{p}.json")) as f:
            out.append(json.load(f))
    return out


def check(res: list, outdir: str) -> str:
    """The demo's assertions; returns the RINEX obs file's name."""
    assert res[0]["locked"] == res[1]["locked"] == PRNS, res
    assert res[0]["decoded"] == res[1]["decoded"] == PRNS, res
    assert res[0]["events"] == res[1]["events"], "event mismatch"
    assert res[0]["epochs"] > 0
    obs = sorted(p for p in os.listdir(outdir) if p.endswith(".obs"))
    assert len(obs) == 1, f"RINEX obs files {obs} (process 0 alone)"
    return obs[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch.tools.multihost_receiver_demo",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--capture", default=None,
                    help="the capture (default: the demo's own)")
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--coord", default=None)
    a = ap.parse_args(argv)
    if no_card(a.device, "multihost_receiver_demo"):
        return 2
    if a.pid is not None:
        return worker(a.pid, a.coord, a.outdir, a.device, a.capture)
    outdir = a.outdir or tempfile.mkdtemp(prefix="gnsslib_torch_mh_")
    try:
        res = launch(outdir, device=a.device, capture=a.capture)
        obs = check(res, outdir)
        print(f"[demo] {NPROC} processes x {PER_PROCESS} local shards "
              f"({res[0]['device']}), C={len(PRNS)} channels sharded over "
              f"the global mesh; all {PRNS} locked+decoded, "
              f"{res[0]['epochs']} epochs, RINEX {obs}, K1 launches per "
              f"process {[r['k1_launches'] for r in res]} "
              f"-> MULTIHOST RECEIVER OK", flush=True)
        return 0
    finally:
        if a.outdir is None:
            shutil.rmtree(outdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
