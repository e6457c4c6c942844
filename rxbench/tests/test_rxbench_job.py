"""A run on the CPU through the in-memory front end, on the small
configuration beside these tests (4 GPS channels, 3 satellites present, 1
SBAS channel, 4.092 Msps, a 20 s capture): its last line has exactly the
result line's keys and reads correct; the same run with the timed path broken
underneath reads not correct, once for each fault the cells can have; and
the control (the reference in float32 in the receiver's place) fails the
pseudorange limit.  The card is not looked for: ``run_cell`` drives the
rest of a run with ``device="cpu"``."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from rxbench import harness, readings, run, sky

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BENCH = {
    "workloads": [{"name": "tiny.cpu", "config": "tiny_gps",
                   "traffic": "tiny", "chips": 1, "why": "CPU test"}],
    "end_to_end": [
        {"name": "rx_msps", "unit": "Msamples/s", "better": "higher",
         "bound": 0.25, "source": "host_clock"},
        {"name": "first_epoch_s", "unit": "s", "better": "lower",
         "bound": 0.25, "source": "host_clock"},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"}],
    "per_layer": [
        {"name": "pullin_s", "unit": "s", "better": "lower",
         "source": "program_span", "layer": "track pull-in",
         "moves": "first_epoch_s"}]}
SEED = 2 ** 31 + 123
_CACHE = {}


@pytest.fixture(autouse=True)
def _cached_synthesis(monkeypatch):
    """The captures of a seed are made once for the module (the CPU makes
    them slowly); the same seed gives the same captures anyway."""
    real = sky.synthesize

    def cached(sk, f_sf, f_if, n, **kw):
        key = (tuple((s.prn, s.doppler, s.delay) for s in sk.signals),
               n, kw.get("noise_seed"))
        if key not in _CACHE:
            _CACHE[key] = real(sk, f_sf, f_if, n, **kw)
        return _CACHE[key]
    monkeypatch.setattr(sky, "synthesize", cached)
    torch.set_num_threads(min(4, torch.get_num_threads()))


def _run(**kw):
    return run.run_cell("tiny.cpu", SEED, 1e4, False, device="cpu",
                        bench=BENCH, base=DATA, max_jobs=1,
                        log=lambda *a: None, **kw)


def test_cpu_run_is_correct_with_the_result_keys():
    out = _run()
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["metrics"]) == {"rx_msps", "first_epoch_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0
               for m in out["metrics"].values())
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


def _state_unchanged(monkeypatch):
    from gnsslib_tpu_torch.track import program
    real = program.BlockRunner.run_block_start

    def start(self, state, block, nsteps):
        _, handle = real(self, state, block, nsteps)
        return state, handle
    monkeypatch.setattr(program.BlockRunner, "run_block_start", start)


def _half_the_channels(monkeypatch):
    from gnsslib_tpu_torch.track import program
    real = program.BlockRunner.run_block_start

    def start(self, state, block, nsteps):
        keep = torch.ones_like(state.active)
        keep[1::2] = False
        return real(self, state.replace(active=state.active & keep), block,
                    nsteps)
    monkeypatch.setattr(program.BlockRunner, "run_block_start", start)


def _pseudorange_altered(monkeypatch):
    """One pseudorange of one epoch 300 m off, where the epoch is made."""
    from gnsslib_tpu_torch.constants import SYS_GPS
    from gnsslib_tpu_torch.obs import epoch
    real = epoch.EpochAligner._epoch_at
    done = []

    def at(self, chans, reftow):
        obs = real(self, chans, reftow)
        gps = [o for o in obs or () if o.sys == SYS_GPS]
        if len(gps) >= 3 and not done:
            gps[0].P += 300.0
            done.append(reftow)
        return obs
    monkeypatch.setattr(epoch.EpochAligner, "_epoch_at", at)


def _doppler_flipped(monkeypatch):
    """The acquisition's Doppler answers taken with the wrong sign, where
    the search produces them."""
    from gnsslib_tpu_torch.acquire.search import Acquirer
    real = Acquirer.postprocess
    flip = readings.ACQ_FAULTS["dflip"]
    monkeypatch.setattr(Acquirer, "postprocess",
                        lambda self, *a: flip(real(self, *a)))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_channels,
                                   _pseudorange_altered, _doppler_flipped],
                         ids=["state_unchanged", "half_the_batch",
                              "answer_altered", "doppler_flipped"])
def test_fault_reads_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = _run()
    assert out["correct"] is False, out["checks"]
    if fault is _doppler_flipped:
        assert out["checks"]["acq_dop_err_hz"]["value"] > \
            out["checks"]["acq_dop_err_hz"]["limit"], out["checks"]


@pytest.fixture(scope="module")
def tiny_run():
    """One job of the tiny cell, judged; closed after the module."""
    from rxbench import catalog
    cell = catalog.cell("tiny.cpu", BENCH, DATA)
    r = harness.Run(cell, SEED, "cpu")
    try:
        r.make_captures()
        r.window(1e4, harness.Tracer(None, False, r.workdir), max_jobs=1)
        r.judge()
        yield cell, r
    finally:
        r.close()


def test_control_fails_the_pseudorange_limit(tiny_run):
    """The reference put in the receiver's place and worked out in
    float32 reads far above the limit, the float64 reference far below."""
    from rxbench import truth
    cell, r = tiny_run
    ctl = readings.control_numbers(r)
    job = r.jobs[0]
    sk = r.captures[0][0]
    exact = dict(job, rinex_obs=truth.control_observables(
        job, sk, np.float64))
    assert truth.judge_obs(exact, sk)[1] < 0.01
    assert ctl["pr_err_m"] > 3 * cell.limits["pr_err_m"], ctl


def test_decisions_are_judged_at_the_searched_sample(tiny_run):
    """Each acquisition decision's code boundary is judged from the sample
    the search read: within a chip there, and not half a code period
    later."""
    from rxbench import truth
    _, r = tiny_run
    job, sk = r.jobs[0], r.captures[0][0]
    f_sf = r.spec.f_sf
    assert job["acq"]
    assert truth.judge_acq(job, sk, f_sf)[0] == 0
    half = int(round(f_sf * 5e-4))
    moved = dict(job, acq=[(p, k, c, d, at + half)
                           for p, k, c, d, at in job["acq"]])
    assert truth.judge_acq(moved, sk, f_sf)[0] == len(job["acq"])
