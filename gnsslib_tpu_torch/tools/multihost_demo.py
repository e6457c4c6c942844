"""Two-process channel-sharded tracking demo (port of the JAX package's
``tools/multihost_demo.py``, on ``torch.distributed``).

    python -m gnsslib_tpu_torch.tools.multihost_demo [--device cuda|cpu]

Starts ``NPROC`` = 2 processes (coordinator port from a bound socket),
each running ``PER_PROCESS`` = 4 shards of one global mesh (on the card
every process's shards share ``cuda:{rank % cards}``; all of them
``cuda:0`` on a one-card machine): the JAX demo's 16 channels (2 per
shard), a 50-period
pull-in block of 0.2 s of synthesized signal through ``ShardedTracker``,
then one steady super-step through ``ShardedFastTracker`` (on the card its
band backend, K1; on the CPU the plain version).  Process 0 prints the
result line, ending ``MULTIHOST OK``; every process prints one JSON line
with its K1 launches and wall seconds.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import free_port, no_card, run_workers

NPROC = 2
PER_PROCESS = 4           # the JAX demo's 4 virtual devices per process
TIMEOUT_S = 120.0


def worker(pid: int, coord: str, device: str) -> int:
    import numpy as np
    import torch
    from .. import sim
    from ..constants import CodeType, DType
    from ..ops import kernels
    from ..parallel import ShardedFastTracker, ShardedTracker
    from ..parallel import distributed as dd
    from ..track import FastTracker, TrackConfig, Tracker

    if device == "cpu":
        torch.set_num_threads(2)
    dd.init_distributed(coord, NPROC, pid, timeout_s=TIMEOUT_S)
    assert dd.process_count() == NPROC
    if device == "cuda":
        dd.build_kernels()
    mesh = dd.global_mesh(per_process=PER_PROCESS, device=device)
    dev = dd.local_device(device)
    C = mesh.size * 2                     # 2 channels per shard, 16 total
    f_sf = 1.023e6
    chans = [sim.SimChannel(prn=(i % 32) + 1, doppler=100.0 * (i % 5),
                            code_phase=30.0 * i) for i in range(4)]
    data = np.asarray(sim.synthesize(chans, f_sf, f_sf / 4, DType.REAL,
                                     int(0.2 * f_sf), noise_std=0.5),
                      np.float32)
    block = torch.from_numpy(data).to(dev)
    trk = Tracker(TrackConfig(corrn=1, corrd=1, corrp=1),
                  [(i % 32) + 1 for i in range(C)], [CodeType.L1CA] * C,
                  f_sf, f_sf / 4, DType.REAL, device=dev)
    before = kernels.snapshot()
    t0 = time.time()
    strk = ShardedTracker(trk, mesh)
    st = trk.init_state()
    st = trk.start_channels(st, list(range(C)), [0] * C,
                            [100.0 * (i % 5) for i in range(C)])
    nsteps = 50
    st, out = strk.run_block(st, block, nsteps)
    assert out.ip.shape == (nsteps, C), out.ip.shape

    # the steady-state fast path over the same global mesh
    fast = FastTracker(trk)
    sfast = ShardedFastTracker(fast, mesh)
    for c in range(C):
        st = trk.set_bit_sync(st, c, c % 10)
    st = trk.rebase(st, 0)
    st, outf = sfast.run_block(st, block, fast.L)
    assert outf.ip.shape == (fast.L, C), outf.ip.shape
    wall = time.time() - t0
    k1 = kernels.since(before).get("band_taps", {})
    print(json.dumps({"pid": pid, "device": dev.type, "shards":
                      len(strk.shards), "k1_launches": k1.get("kernel", 0),
                      "k1_plain": k1.get("plain", 0), "wall": wall}),
          flush=True)
    if dd.is_output_host():
        print(f"[demo] {NPROC} processes x {PER_PROCESS} local shards "
              f"({fast.corr} backend, {dev.type}), C={C} channels sharded; "
              f"tracked {nsteps} periods; mean |IP| = "
              f"{float(np.mean(np.abs(out.ip))):.1f}; fast-path super-step "
              f"out {outf.ip.shape}  -> MULTIHOST OK", flush=True)
    dd.shutdown()
    return 0


def launch(device: str = "cuda") -> list:
    """Run the demo's processes; returns [(exit code, stdout)]."""
    coord = f"127.0.0.1:{free_port()}"
    argv = ["gnsslib_tpu_torch.tools.multihost_demo", "--coord", coord,
            "--device", device]
    return run_workers([argv + ["--pid", str(p)] for p in range(NPROC)],
                       timeout=4 * TIMEOUT_S)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch.tools.multihost_demo",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--coord", default=None)
    a = ap.parse_args(argv)
    if no_card(a.device, "multihost_demo"):
        return 2
    if a.pid is not None:
        return worker(a.pid, a.coord, a.device)
    res = launch(a.device)
    for _, out in res:
        sys.stdout.write(out)
    return max(abs(rc) for rc, _ in res)


if __name__ == "__main__":
    sys.exit(main())
