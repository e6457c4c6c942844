"""The port's multi-process runs (``gnsslib_tpu_torch.parallel.
distributed``, gloo) on the CPU: the counterparts of
``tests/test_scaling.py``, and the guard that keeps a desynchronised
process from hanging the run.

- both two-process demos end with their OK lines; the two-process
  receiver's events equal those of the JAX ``Receiver(mesh=make_mesh(4),
  pipeline_acq=False)`` on the same capture, and process 0 alone writes
  RINEX;
- a process that skips a collect makes the other raise at once (each
  collective's header: the block number in its tag), and one that stops
  makes it raise when the group's timeout expires;
- ``scaling_efficiency``: a tiny run's JSON, and the >= 0.80 floor in a
  test marked slow and skipped under xdist, as the JAX test is.

Every subprocess has a timeout."""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import jax

from gnsslib_tpu_torch.tools import (multihost_receiver_demo, run_workers,
                                     scaling_efficiency)

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("multihost_demo", "multihost_receiver_demo", "scaling_efficiency")


def _tool(name, *args, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", f"gnsslib_tpu_torch.tools.{name}", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def test_multihost_demo_two_processes():
    """The two-process channel-sharded demo (pull-in and steady blocks,
    4 CPU shards per process) completes and reports MULTIHOST OK."""
    r = _tool("multihost_demo", "--device", "cpu", timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "MULTIHOST OK" in r.stdout, r.stdout
    recs = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]
    assert sorted(x["pid"] for x in recs) == [0, 1]
    assert all(x["shards"] == 4 and x["k1_plain"] == 4 for x in recs)


def test_multihost_full_receiver_two_processes(tmp_path):
    """The whole receiver in two processes x 2 CPU shards: both lock and
    decode every satellite with the same events, process 0 alone writes
    RINEX, and the events equal the JAX mesh receiver's (``make_mesh(4)``,
    ``pipeline_acq=False``) on the same capture."""
    from gnsslib_tpu.constants import DType, FrontendType
    from gnsslib_tpu.io.frontend import FileFrontend, FrontendSpec
    from gnsslib_tpu.parallel import make_mesh
    from gnsslib_tpu.runtime.config import ChannelConfig, ReceiverConfig
    from gnsslib_tpu.runtime.receiver import Receiver
    from gnsslib_tpu.track.state import TrackConfig

    demo = multihost_receiver_demo
    path = demo.make_capture()
    jout = []

    def jax_run():
        spec = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9,
                            f_sf=demo.F_SF, f_if=demo.F_IF,
                            dtype=DType.REAL)
        cfg = ReceiverConfig(
            channels=[ChannelConfig(prn=p) for p in demo.PRNS],
            fends=[spec], files=[path],
            track=TrackConfig(corrn=4, corrd=2, corrp=2), outms=400,
            rinex=False)
        rx = Receiver(cfg, FileFrontend(path, spec), mesh=make_mesh(4),
                      pipeline_acq=False)
        rx.run_seconds()
        jout.append(rx)

    th = threading.Thread(target=jax_run)
    th.start()
    try:
        r = _tool("multihost_receiver_demo", "--device", "cpu", "--outdir",
                  str(tmp_path), timeout=600)
    finally:
        th.join()
    assert r.returncode == 0, r.stderr[-2000:]
    assert "MULTIHOST RECEIVER OK" in r.stdout, r.stdout
    res = [json.load(open(tmp_path / f"proc{p}.json")) for p in (0, 1)]
    assert res[0]["events"] == res[1]["events"]
    assert [e[:3] for e in res[0]["events"]] == \
        [list(e[:3]) for e in jout[0].events]
    assert res[0]["epochs"] == res[1]["epochs"] == jout[0].epochs_written
    written = sorted(p[-3:] for p in os.listdir(tmp_path)
                     if not p.endswith(".json"))
    assert written == ["nav", "obs"]


# a worker of two processes x 1 CPU shard over 4 channels: three pull-in
# blocks dispatched, then collected; process 1 misbehaves at the second
# collect ("skip": it goes on to the third; "stall": it sleeps)
HANG_WORKER = textwrap.dedent("""
    import sys, time
    import numpy as np, torch
    torch.set_num_threads(1)
    from gnsslib_tpu_torch.constants import CodeType, DType
    from gnsslib_tpu_torch.parallel import ShardedTracker
    from gnsslib_tpu_torch.parallel import distributed as dd
    from gnsslib_tpu_torch.track import TrackConfig, Tracker
    pid, coord, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dd.init_distributed(coord, 2, pid, timeout_s=5)
    mesh = dd.global_mesh(device="cpu")
    trk = Tracker(TrackConfig(1, 1, 1), [1, 2, 3, 4], [CodeType.L1CA] * 4,
                  1.023e6, 1.023e6 / 4, DType.REAL, device="cpu")
    strk = ShardedTracker(trk, mesh)
    block = torch.from_numpy(np.random.default_rng(1).standard_normal(
        60000).astype(np.float32))
    st = trk.start_channels(trk.init_state(), [0, 1, 2, 3], [0] * 4,
                            [0.0] * 4)
    hs = []
    for _ in range(3):
        st, h = strk.run_block_start(trk.rebase(st, 0), block, 5)
        hs.append(h)
    t0 = time.time()
    for k, h in enumerate(hs):
        if pid == 1 and k == 1:
            if mode == "stall":
                time.sleep(120)
            continue
        try:
            strk.run_block_collect(h)
        except RuntimeError as e:
            print(f"RAISED after {time.time() - t0:.1f} s: {e}",
                  file=sys.stderr, flush=True)
            sys.exit(3)
    print("COLLECTED", flush=True)
""")


@pytest.mark.parametrize("mode", ["skip", "stall"])
def test_desynchronised_process_raises(mode, tmp_path):
    """A process that skips one collect (``skip``) or stops before it
    (``stall``) never hangs the other: the other raises, at once for a
    skipped collective (the tags' block numbers differ) or after the
    group's 5 s timeout for a stalled one."""
    from gnsslib_tpu_torch.tools import free_port
    script = tmp_path / "worker.py"
    script.write_text(HANG_WORKER)
    coord = f"127.0.0.1:{free_port()}"
    errs = [tmp_path / f"err{p}.txt" for p in (0, 1)]
    procs = []
    t0 = time.time()
    for p in (0, 1):
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(p), coord, mode], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=subprocess.DEVNULL, stderr=open(errs[p], "w")))
    try:
        rc0 = procs[0].wait(timeout=90)
        waited = time.time() - t0
        if mode == "skip":
            procs[1].wait(timeout=30)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    err0 = errs[0].read_text()
    assert rc0 == 3, err0[-2000:]
    assert "RAISED" in err0
    if mode == "skip":
        assert "out of step" in err0, err0[-2000:]
        assert procs[1].returncode == 3, errs[1].read_text()[-2000:]
    assert waited < 60, waited


def test_run_workers_kills_the_rest_when_one_fails():
    """The launcher's guard: a worker that fails ends the others at once
    (no wait for the timeout)."""
    t0 = time.time()
    res = run_workers([["json.tool", "/nonexistent/file"],
                       ["http.server", "--bind", "127.0.0.1", "0"]],
                      timeout=60)
    assert res[0][0] != 0 and res[1][0] != 0
    assert time.time() - t0 < 30


def test_scaling_efficiency_small():
    """A tiny two-process run on the CPU: the JSON record's keys, a
    positive ratio, the layout, and the plain band backend on the CPU."""
    res = scaling_efficiency.run(nproc=2, devices=2, channels=2, nsteps=20,
                                 blocks=2, device="cpu")
    for k in ("base_cps_per_dev", "scaled_cps_per_dev", "unit", "nproc",
              "devices_per_proc", "channels_per_dev", "efficiency",
              "layout", "device", "k1_launches", "compute_s", "collect_s"):
        assert k in res, k
    for base_or_scaled in range(2):
        assert res["compute_s"][base_or_scaled] > 0
        assert 0 <= res["collect_s"][base_or_scaled] < \
            res["wall"][base_or_scaled]
    assert res["efficiency"] > 0 and res["base_cps_per_dev"] > 0
    assert res["layout"] == "2 processes x 2 shards on the CPU"
    assert res["corr"] == "band" and res["k1_launches"] == [0, 0]


@pytest.mark.slow
@pytest.mark.skipif("PYTEST_XDIST_WORKER" in os.environ,
                    reason="timing measurement; meaningless while other "
                           "xdist workers compete for the pinned cores — "
                           "run serially")
def test_scaling_efficiency_two_processes():
    """Weak-scaling efficiency 1 -> 2 processes at a production block
    size on the CPU, at the JAX test's floor (>= 0.80)."""
    res = None
    for attempt in range(2):
        r = _tool("scaling_efficiency", "--device", "cpu", "--nsteps",
                  "1200", "--blocks", "2", timeout=1500)
        assert r.returncode == 0, r.stderr[-2000:]
        res = json.loads([ln for ln in r.stdout.splitlines()
                          if ln.startswith("{")][-1])
        if res["efficiency"] >= 0.80:
            break
    assert res["efficiency"] >= 0.80, res


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_without_card_exits_2(tool):
    """``--device cuda`` (the default) without a card: exit 2 with "no
    CUDA card", before any work (no process started, no capture)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _tool(tool, "--device", "cuda", timeout=120)
    assert r.returncode == 2, (r.stdout, r.stderr)
    assert "no CUDA card" in r.stderr
    assert r.stdout == ""


def test_checkpoint_refused_across_processes(tmp_path):
    """A multi-process mesh receiver refuses to write a checkpoint (its
    state holds only its own channels' rows), before writing anything."""
    from gnsslib_tpu_torch.parallel import Mesh
    demo = multihost_receiver_demo
    mesh = Mesh(["cpu", "cpu", None, None], owners=[0, 0, 1, 1], rank=0)
    rx = demo.receiver(demo.make_capture(), "cpu", mesh)
    ck = tmp_path / "rx.ckpt"
    with pytest.raises(RuntimeError, match="multi-process"):
        rx.save_checkpoint(str(ck))
    assert not ck.exists()
    assert len(rx._slow_eng.shards) == 2 and rx._acq_eng.mode == "ch"
    assert np.all(rx._live == 0)
