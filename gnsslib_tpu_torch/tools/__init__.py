"""Measurement tools of the port (``python -m gnsslib_tpu_torch.tools.<name>``).

Each tool runs on the card unless ``--device cpu`` is given, and exits 2
when the card is asked for and absent: a number it prints is never a CPU
number under the card's name.

The receiver tools: ``receiver_throughput``, ``ttff``,
``profile_receiver``, ``scaling_channels``, ``receiver_256ch``,
``acq_throughput``, ``e2e_receiver_check``, ``measure_round``.  The
multi-device tools (:mod:`..parallel`): ``multihost_demo`` (two processes,
channel-sharded pull-in and steady blocks), ``multihost_receiver_demo``
(the whole receiver in two processes, process 0 writing RINEX) and
``scaling_efficiency`` (one process against two, each with the same
shards).  The parity tool: ``parity_vs_reference`` (the reference C
receiver against the port's CLI, on the JAX tool's scenarios).  The
kernel profilers: ``profile_fast``, ``profile_kernel``,
``profile_band``, ``profile_window``, ``profile_gram``."""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def no_card(device: str, prog: str) -> bool:
    """Whether ``device`` is ``cuda`` and torch sees no card; if so, says
    so on stderr (the caller then exits 2)."""
    if device != "cuda":
        return False
    import torch       # not at import time: ttff times torch's import
    if torch.cuda.is_available():
        return False
    print(f"{prog}: no CUDA card (use --device cpu to run the plain "
          f"versions on the CPU)", file=sys.stderr)
    return True


def free_port() -> int:
    """A localhost TCP port the system has just handed out: a
    coordinator's port is never a fixed one, so that concurrent runs do
    not collide."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(argvs: list, timeout: float, prefix=None) -> list:
    """Run ``python -m <argv...>`` for every argv at once from the root of
    the checkout (``prefix(i)``: a command put before worker ``i``'s, such
    as a ``taskset``), each one's standard output into a file; wait for
    all of them, and kill the others as soon as one fails or ``timeout``
    seconds pass.  Returns [(exit code, standard output)]."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    outs, procs = [], []
    try:
        for i, argv in enumerate(argvs):
            f = tempfile.TemporaryFile(mode="w+")
            outs.append(f)
            procs.append(subprocess.Popen(
                (list(prefix(i)) if prefix else [])
                + [sys.executable, "-m"] + list(argv),
                cwd=ROOT, env=env, stdout=f))
        end = time.time() + timeout
        while any(p.poll() is None for p in procs):
            if time.time() > end or any(p.poll() for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    res = []
    for p, f in zip(procs, outs):
        f.seek(0)
        res.append((p.returncode, f.read()))
        f.close()
    return res
