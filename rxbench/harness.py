"""One run of a cell: set-up, the measured window of jobs, the comparison
with the plain reference, and the result line.

A run is a closed loop of jobs.  A job is one capture processed by a fresh
receiver, as a user of the CLI runs one capture after another:
``runtime/config.py::load_ini`` on the configuration's INI pair, then
``runtime/receiver.py::build_receiver(cfg, {1: frontend}, device=...,
nsteps_per_block=400)``, ``step_block`` to the capture's end, ``flush`` and
``close``.  The next job starts when one ends; the job running at the
window's nominal end runs to its end, and the window closes with it, so
a run times whole jobs only and the same seed gives the same samples.

Set-up (process start to the first timed job) builds nothing the window
needs later: the kernels come from the build cache under ``build/`` in the
checkout, the captures are made on the device from the seed, and one warm
job runs the first capture's first ``warm_seconds`` of signal (the cell's
own shapes, its capture's size on the card, its decoders and outputs).
"""
from __future__ import annotations

import contextlib
import gc
import glob
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

from . import catalog, devtrace, sky, truth
from .frontend import MemoryFrontend

FORBIDDEN = ("jax", "jaxlib", "flax", "gnsslib_tpu")
NSTEPS = 400
STAGES = ("acquire", "pullin", "steady")
WORST = ("acq_dop_err_hz", "pr_err_m")     # a run's worst job; else sums


def forbidden_modules() -> list:
    """Top-level names of loaded modules that no run may load (whole names:
    ``gnsslib_tpu_torch`` is not ``gnsslib_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class SbasClient:
    """Drains a receiver's SBAS TCP stream on a thread until the receiver
    closes it."""

    def __init__(self, port: int):
        self.data = bytearray()
        self._sock = socket.create_connection(("127.0.0.1", port),
                                              timeout=10.0)
        self._sock.settimeout(None)
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        while True:
            try:
                b = self._sock.recv(65536)
            except OSError:
                break
            if not b:
                break
            self.data += b

    def finish(self) -> bytes:
        self._t.join(timeout=30.0)
        self._sock.close()
        return bytes(self.data)


def card_line() -> str:
    """The card's clocks, power and limit by ``nvidia-smi`` (or why not)."""
    q = ("name,clocks.sm,clocks.mem,power.draw,power.limit,"
         "temperature.gpu")
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


class Tracer:
    """The traced window of a ``--trace 1`` run: a ``torch.profiler`` trace
    (CPU and CUDA activities) over ``blocks`` blocks of the first window
    job that reaches the traffic's trace point (``"start"``: the job's
    build; ``"steady"``: its first steady block), with ``rxbench.*``
    annotations around the harness's calls into the receiver."""

    def __init__(self, spec: dict | None, enabled: bool, workdir: str):
        self.enabled = enabled and spec is not None
        self.at = (spec or {}).get("at", "start")
        self.blocks = int((spec or {}).get("blocks", 0))
        self.path = os.path.join(workdir, "trace.json")
        self.active = False
        self.done = False
        self.count = 0
        self._prof = self._win = None

    def warm_up(self) -> None:
        """Start and stop the profiler once on a small copy, so that its
        first start (CUPTI's set-up, seconds) falls in set-up."""
        if not self.enabled:
            return
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.ones(1024, device="cuda").sum().item()

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(devtrace.SPAN_PREFIX + name)

    def maybe_start(self, point: str) -> None:
        if not self.enabled or self.active or self.done or point != self.at:
            return
        import torch
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._win = torch.profiler.record_function(devtrace.WINDOW)
        self._win.__enter__()
        self.active = True

    def after_block(self) -> None:
        if self.active:
            self.count += 1
            if self.count >= self.blocks:
                self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        import torch
        torch.cuda.synchronize()
        self._win.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        self.done = True

    def export(self) -> str | None:
        if self._prof is None:
            return None
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        return self.path


class Run:
    """One run of ``cell`` with ``seed`` on ``device``."""

    def __init__(self, cell: catalog.Cell, seed: int, device: str = "cuda"):
        self.cell = cell
        self.seed = int(seed) % (1 << 63)
        self.device = device
        self.workdir = tempfile.mkdtemp(prefix="rxbench_")
        self.ini = os.path.join(cell.config_dir, "gnss-sdrcli.ini")
        self.captures = []          # (Sky, host int8 tensor)
        self.blocks = []            # per timed block: job, stage, walls, ...
        self.jobs = []

    # ------------------------------------------------------------ set-up
    def _rng(self, *key) -> np.random.Generator:
        return np.random.default_rng([self.seed, *key])

    def make_captures(self) -> None:
        """Every capture of the traffic, on the device from the seed."""
        from gnsslib_tpu_torch.runtime.config import load_ini
        spec = load_ini(self.ini).fends[0]
        mix = self.cell.mix
        self.spec = spec

        def make(key, seconds):
            sk = sky.draw_sky(mix, self._rng(*key), seconds)
            n = int(round(seconds * spec.f_sf))
            noise = int(np.random.SeedSequence([self.seed, *key])
                        .generate_state(1, np.uint64)[0])
            data = sky.synthesize(sk, spec.f_sf, spec.f_if, n,
                                  device=self.device, noise_seed=noise)
            return sk, data
        self.captures = [make((i,), float(mix["seconds"]))
                         for i in range(int(mix["captures"]))]

    # ------------------------------------------------------------ a job
    def job(self, k: int, cap, tracer: Tracer | None,
            signal_s: float | None = None) -> dict:
        """One capture through a fresh receiver until its end or
        ``signal_s`` seconds of signal."""
        from gnsslib_tpu_torch.constants import DType
        from gnsslib_tpu_torch.runtime.config import load_ini
        from gnsslib_tpu_torch.runtime.receiver import build_receiver
        _, data = cap
        tracer = tracer or Tracer(None, False, self.workdir)
        rec = dict(index=k, samples=0, seconds=0.0, completed=False,
                   t_first_epoch=None, error=None, traced=False,
                   acq=[], events=[], rinex_obs="", rinex_nav="",
                   sbas_bytes=b"")
        jobdir = os.path.join(self.workdir, f"job{k}")
        os.makedirs(jobdir, exist_ok=True)
        rec["t0"] = time.time()
        tracer.maybe_start("start")
        rec["traced"] = tracer.active
        rx = client = None
        try:
            cfg = load_ini(self.ini)
            cfg.rinexpath = cfg.logpath = jobdir
            if cfg.sbas:
                cfg.sbasport = 0
            rec["outms"] = cfg.outms
            rec["taps"] = 2 * cfg.track.corrn + 1
            rec["smax"] = cfg.track.corrn * cfg.track.corrd
            rec["iq"] = cfg.fends[0].dtype == DType.IQ
            fe = MemoryFrontend(data.numpy(), cfg.fends[0])
            with tracer.span("build"):
                rx = build_receiver(cfg, {1: fe}, device=self.device,
                                    nsteps_per_block=NSTEPS)
            groups = list(getattr(rx, "rx", [rx]))
            for g in groups:
                _record_decisions(g, rec["acq"])
            if rx.hub.sbas_srv is not None:
                client = SbasClient(rx.hub.sbas_srv.port)
            ends = [g.end_sample(signal_s) for g in groups]
            while all(g.can_step(e) for g, e in zip(groups, ends)):
                before = [dict(g.stage_wall) for g in groups]
                base0 = groups[0].base
                i = len(self.blocks)
                ta = time.time()
                with tracer.span(f"block.{i}"):
                    rx.step_block()
                tb = time.time()
                stages = [max(STAGES, key=lambda s, g=g, b=b:
                              g.stage_wall[s] - b[s])
                          for g, b in zip(groups, before)]
                self.blocks.append(dict(
                    job=k, t0=ta, t1=tb, samples=groups[0].base - base0,
                    stages=stages, traced=tracer.active,
                    locked=[sum(ch.locked for ch in g.channels)
                            for g in groups]))
                rec["traced"] = rec["traced"] or tracer.active
                tracer.after_block()
                if rec["t_first_epoch"] is None and rx.epochs_written:
                    rec["t_first_epoch"] = tb
                if all(s == "steady" for s in stages):
                    tracer.maybe_start("steady")
            rec["completed"] = True
            with tracer.span("flush"):
                rx.flush()
            rec["t_end"] = time.time()
            rec["samples"] = int(groups[0].base)
            rec["seconds"] = rec["samples"] / self.spec.f_sf
            rec["groups"] = [dict(
                channels=len(g.channels), nsteps=g.nsteps, nsamp=g.nsamp,
                L=(g.fast.L if g.fast is not None else 1),
                stage_wall=dict(g.stage_wall),
                precompiled=float(g.timeline.get("precompiled", 0.0)))
                for g in groups]
        except Exception:
            rec["error"] = traceback.format_exc()
            rec.setdefault("t_end", time.time())
            print(f"job {k} failed:\n{rec['error']}", file=sys.stderr)
        finally:
            if rx is not None:
                try:
                    with tracer.span("close"):
                        rx.close()
                except Exception:
                    rec["error"] = rec["error"] or traceback.format_exc()
                    print(f"job {k} failed to close:\n{rec['error']}",
                          file=sys.stderr)
                rec["events"] = list(rx.events)
            if client is not None:
                rec["sbas_bytes"] = client.finish()
            for key, pat in (("rinex_obs", "*.obs"), ("rinex_nav", "*.nav")):
                for p in glob.glob(os.path.join(jobdir, pat)):
                    with open(p) as f:
                        rec[key] += f.read()
            shutil.rmtree(jobdir, ignore_errors=True)
            del rx
        return rec

    def warm(self) -> dict:
        """The warm-up job: the first capture's first ``warm_seconds``,
        its receiver freed after it as after every job."""
        rec = self.job(-1, self.captures[0], None,
                       float(self.cell.mix["warm_seconds"]))
        self.blocks.clear()
        gc.collect()
        return rec

    # ------------------------------------------------------------ window
    def window(self, seconds: float, tracer: Tracer,
               max_jobs: int | None = None) -> tuple[float, float]:
        """Jobs one after another, each to its end, as long as one starts
        within ``seconds`` (or until ``max_jobs`` have run); returns
        (start, end) of the window on the host clock: its end is the last
        job's."""
        t0 = time.time()
        deadline = t0 + float(seconds)
        k = 0
        while time.time() < deadline and (max_jobs is None
                                          or k < max_jobs):
            rec = self.job(k, self.captures[k % len(self.captures)],
                           tracer)
            self.jobs.append(rec)
            k += 1
            # free the closed receiver (its graphs, its capture on the
            # card) now, as the end of a CLI process would, and not at
            # some later job's cyclic collection
            t = time.time()
            gc.collect()
            rec["gc_s"] = time.time() - t
        t1 = time.time()
        tracer.stop()
        return t0, t1

    # ------------------------------------------------------------ judging
    def judge(self) -> dict:
        """Every compared number over the window's jobs."""
        tot = dict(acq_bad=0, acq_miss=0, acq_dop_err_hz=0.0, nav_bad=0,
                   nav_miss=0, obs_miss=0, pr_err_m=0.0)
        for rec in self.jobs:
            if rec["error"] is not None:
                continue
            sk = self.captures[rec["index"] % len(self.captures)][0]
            got = truth.judge(rec, sk, self.spec.f_sf)
            rec["numbers"] = got
            for key, v in got.items():
                tot[key] = max(tot[key], v) if key in WORST else \
                    tot[key] + v
        return tot

    def close(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def _record_decisions(g, out: list) -> None:
    """Appends to ``out`` each acquisition decision that receiver group
    ``g`` applies: (PRN, kind, code boundary in samples after the searched
    stream sample, Doppler Hz, that sample).  The sample is the one the
    search read its block from, as ``_apply_acq`` is handed it: the nominal
    stream cursor while the channels sit near it, else the nearest sample
    that leaves the search its extent (``Receiver._search_offset``)."""
    from gnsslib_tpu_torch.constants import CodeType
    real = g._apply_acq

    def apply_acq(res, at, t_disp, pend_idx):
        was = [g.channels[i].locked for i in pend_idx]
        real(res, at, t_disp, pend_idx)
        for i, w in zip(pend_idx, was):
            ch = g.channels[i]
            if ch.locked and not w:
                kind = "sbas" if ch.cfg.ctype == CodeType.L1SBAS else "gps"
                out.append((ch.cfg.prn, kind, int(ch.acq_codei),
                            float(ch.acq_dcarr), int(at)))
    g._apply_acq = apply_acq
