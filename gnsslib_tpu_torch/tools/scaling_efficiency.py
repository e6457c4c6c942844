"""Weak-scaling efficiency of the channel-sharded steady state, one
process against several (port of the JAX package's
``tools/scaling_efficiency.py``, on ``torch.distributed``).

    python -m gnsslib_tpu_torch.tools.scaling_efficiency [--device cuda|cpu]
        [--nproc 2] [--devices 2] [--channels 8] [--nsteps 100] [--blocks 6]

The same ``ShardedFastTracker`` program (4.092 Msps, CORR 4/2/2, the band
backend: K1 on the card, its plain version on the CPU) runs as

* 1 process x D shards (the base), and
* ``--nproc`` processes x D shards (scaled; weak scaling: the channels
  per shard stay fixed, the global channel count grows with the
  processes),

each process pinned to its own slice of the host's cores (``taskset``,
where present), and the tool reports channel-samples per second per
shard and their ratio.  On a one-card machine every shard of every
process shares ``cuda:0``: the ratio then measures the processes'
coordination (the all-gather of each block's telemetry over gloo) and
their contention for the one card, not scaling across cards (the JSON's
``layout`` says which it was).  It reports the numbers and asserts no
floor.

Prints one JSON line: ``base_cps_per_dev``, ``scaled_cps_per_dev``
(Mchannel-samples/s per shard), ``efficiency``, ``nproc``,
``devices_per_proc``, ``channels_per_dev``, ``layout``, ``device``, the
K1 launches of each run's process 0, and its split of the timed wall
(base, scaled): ``compute_s``, the shards' blocks (on a card only their
launch), and ``collect_s``, the copies out and the all-gathers (with the
wait for the other processes in them).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import free_port, no_card, run_workers

TIMEOUT_S = 120.0


def worker(pid: int, nproc: int, coord: str | None, devices: int,
           channels: int, nsteps: int, blocks: int, device: str) -> int:
    import numpy as np
    import torch
    from ..constants import CodeType, DType
    from ..ops import kernels
    from ..parallel import ShardedFastTracker
    from ..parallel import distributed as dd
    from ..track import FastTracker, TrackConfig, Tracker

    if device == "cpu":
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0))))
    if nproc > 1:
        dd.init_distributed(coord, nproc, pid, timeout_s=TIMEOUT_S)
        assert dd.process_count() == nproc
    if device == "cuda":
        dd.build_kernels()
    mesh = dd.global_mesh(per_process=devices, device=device)
    dev = dd.local_device(device)
    ndev = mesh.size
    C = ndev * channels                  # weak scaling: fixed per shard

    f_sf, f_if = 4.092e6, 1.023e6
    rng = np.random.default_rng(7)
    trk = Tracker(TrackConfig(corrn=4, corrd=2, corrp=2),
                  [(i % 32) + 1 for i in range(C)], [CodeType.L1CA] * C,
                  f_sf, f_if, DType.REAL, device=dev)
    fast = FastTracker(trk)
    nsamp = trk.n_nom
    block_len = nsteps * nsamp + trk.nwin + 8 * nsteps + 2 * nsamp + 64
    block = torch.from_numpy(rng.integers(-64, 64, size=block_len)
                             .astype(np.float32)).to(dev)
    st = trk.init_state()
    st = trk.start_channels(st, list(range(C)), [0] * C,
                            [100.0 * (i % 5) for i in range(C)])
    for c in range(C):
        st = trk.set_bit_sync(st, c, c % 10)
    sfast = ShardedFastTracker(fast, mesh)

    # every block starts from the same state, so that every block does the
    # same work and no window leaves the block (the JAX tool's blocks
    # continue from the last one and track clamped samples after the
    # first; the band backend refuses a window outside its block)
    sfast.run_block(st, block, nsteps)              # build + warm-up
    before = kernels.snapshot()
    dd.barrier()
    t0 = time.time()
    compute = 0.0       # the shards' block (on a card: its launch)
    for _ in range(blocks):
        t1 = time.time()
        _, h = sfast.run_block_start(st, block, nsteps)
        compute += time.time() - t1
        sfast.run_block_collect(h)      # the copy out and the all-gather
    wall = time.time() - t0
    k1 = kernels.since(before).get("band_taps", {})
    cps = C * nsteps * nsamp * blocks / wall / ndev
    if dd.is_output_host():
        print(json.dumps({"cps_per_dev": cps, "nproc": nproc, "ndev": ndev,
                          "C": C, "wall": wall, "compute_s": compute,
                          "collect_s": wall - compute, "corr": fast.corr,
                          "k1_launches": k1.get("kernel", 0),
                          "k1_plain": k1.get("plain", 0)}), flush=True)
    dd.shutdown()
    return 0


def launch(nproc: int, devices: int, channels: int, nsteps: int,
           blocks: int, device: str = "cuda") -> dict:
    """Run the measurement as ``nproc`` coordinated processes; returns the
    output host's JSON."""
    coord = f"127.0.0.1:{free_port()}"
    argv = ["gnsslib_tpu_torch.tools.scaling_efficiency", "--worker",
            "--nproc", str(nproc), "--coord", coord, "--devices",
            str(devices), "--channels", str(channels), "--nsteps",
            str(nsteps), "--blocks", str(blocks), "--device", device]
    # a "host" is a fixed slice of the cores: the base process gets the
    # same slice as each scaled one, so the ratio isolates coordination
    # rather than core contention
    ncpu = os.cpu_count() or 2
    per = max(1, ncpu // max(2, nproc))

    def pin(p):
        cores = ",".join(str(c) for c in range(p * per, (p + 1) * per))
        return (["taskset", "-c", cores] if os.path.exists("/usr/bin/taskset")
                else [])
    res = run_workers([argv + ["--pid", str(p)] for p in range(nproc)],
                      timeout=4 * TIMEOUT_S, prefix=pin)
    bad = [(p, rc) for p, (rc, _) in enumerate(res) if rc != 0]
    if bad:
        raise RuntimeError(f"workers failed (process, exit code): {bad}")
    for _, out in res:
        for ln in out.splitlines():
            if ln.startswith("{"):
                return json.loads(ln)
    raise RuntimeError(f"no result line: {res}")


def layout(nproc: int, devices: int, device: str) -> str:
    if device == "cpu":
        return f"{nproc} processes x {devices} shards on the CPU"
    import torch
    cards = torch.cuda.device_count()
    if cards < nproc:
        return (f"{nproc} processes x {devices} shards sharing {cards} "
                f"card{'s' if cards > 1 else ''}")
    return f"{nproc} processes x {devices} shards on {nproc} cards"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch.tools.scaling_efficiency",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--coord", default=None)
    ap.add_argument("--devices", type=int, default=2,
                    help="shards per process")
    ap.add_argument("--channels", type=int, default=8,
                    help="channels per shard (weak scaling)")
    ap.add_argument("--nsteps", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=6)
    a = ap.parse_args(argv)
    if no_card(a.device, "scaling_efficiency"):
        return 2
    if a.worker:
        return worker(a.pid, a.nproc, a.coord, a.devices, a.channels,
                      a.nsteps, a.blocks, a.device)
    print(json.dumps(run(a.nproc, a.devices, a.channels, a.nsteps,
                         a.blocks, device=a.device)), flush=True)
    return 0


def run(nproc: int = 2, devices: int = 2, channels: int = 8,
        nsteps: int = 100, blocks: int = 6, *,
        device: str = "cuda") -> dict:
    """The base and scaled runs -> the tool's JSON record (a dict)."""
    base = launch(1, devices, channels, nsteps, blocks, device)
    scaled = launch(nproc, devices, channels, nsteps, blocks, device)
    return {
        "base_cps_per_dev": base["cps_per_dev"] / 1e6,
        "scaled_cps_per_dev": scaled["cps_per_dev"] / 1e6,
        "unit": "Mchannel-samples/s/device",
        "nproc": nproc, "devices_per_proc": devices,
        "channels_per_dev": channels,
        "efficiency": scaled["cps_per_dev"] / base["cps_per_dev"],
        "layout": layout(nproc, devices, device), "device": device,
        "corr": base["corr"],
        "k1_launches": [base["k1_launches"], scaled["k1_launches"]],
        "wall": [base["wall"], scaled["wall"]],
        "compute_s": [base["compute_s"], scaled["compute_s"]],
        "collect_s": [base["collect_s"], scaled["collect_s"]],
    }


if __name__ == "__main__":
    sys.exit(main())
