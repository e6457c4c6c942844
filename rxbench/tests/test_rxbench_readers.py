"""The trace reduction and the per-layer readers on made-up inputs whose
answers are known by hand."""
from __future__ import annotations

import json

import pytest

from rxbench import catalog, devtrace, peaks


def _trace(tmp_path):
    ev = [
        {"name": "rxbench.window", "cat": "user_annotation", "ts": 0.0,
         "dur": 1000.0},
        {"name": "rxbench.block.0", "cat": "user_annotation", "ts": 0.0,
         "dur": 500.0},
        {"name": "rxbench.block.1", "cat": "user_annotation", "ts": 500.0,
         "dur": 500.0},
        {"name": "band_taps_cluster_kernel", "cat": "kernel", "ts": 100.0,
         "dur": 50.0},
        {"name": "add", "cat": "kernel", "ts": 120.0, "dur": 80.0},
        {"name": "band_taps_cluster_kernel", "cat": "kernel", "ts": 600.0,
         "dur": 50.0},
        {"name": "Memcpy DtoH", "cat": "gpu_memcpy", "ts": 900.0,
         "dur": 20.0},
        {"name": "outside", "cat": "kernel", "ts": 2000.0, "dur": 5.0},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return str(p)


def test_reduce_trace_busy_gaps_and_k1(tmp_path):
    names = {"block.0": "pullin_block", "block.1": "steady_block"}
    s = devtrace.reduce_trace(_trace(tmp_path), rename=names.get)
    # busy: [100, 200] + [600, 650] + [900, 920] us of a 1000 us window
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(170e-6)
    assert s["k1_launches"] == 2 and s["k1_s"] == pytest.approx(100e-6)
    # gaps: [0,100] [200,600] (mid 400: block 0) [650,900] [920,1000]
    assert s["idle_gaps"][0] == ["pullin_block", pytest.approx(400e-6)]
    assert s["idle_by_span"]["steady_block"] == pytest.approx(330e-6)
    assert s["device_ops"][0] == ["band_taps_cluster_kernel",
                                  pytest.approx(100e-6)]


def test_readers(tmp_path):
    trace = devtrace.reduce_trace(_trace(tmp_path))
    job = dict(index=0, error=None, traced=False, completed=True,
               taps=13, smax=18, iq=False,
               groups=[dict(channels=32, nsteps=20, nsamp=16368, L=10,
                            stage_wall=dict(acquire=0.5, pullin=2.0,
                                            steady=1.0),
                            precompiled=1.5)])
    blocks = [dict(job=0, t0=0.0, t1=0.5, samples=327360,
                   stages=["steady"], locked=[12], traced=True),
              dict(job=0, t0=0.5, t1=1.5, samples=327360,
                   stages=["steady"], locked=[12], traced=False)]
    ctx = dict(jobs=[job], blocks=blocks, trace=trace)
    read = catalog.reader
    assert read("build_s")(ctx) == 1.5
    assert read("acquire_s")(ctx) == 0.5 and read("pullin_s")(ctx) == 2.0
    assert read("steady_msps")(ctx) == pytest.approx(0.32736)
    assert read("device_idle_pct.long")(ctx) == pytest.approx(83.0)
    # one traced steady block of 20 periods: 2 launches of 12 x 10 windows
    b = peaks.bound_s(*peaks.k1_work(channels=32, active=12, periods=10,
                                     nsamp=16368, taps=13, smax=18))
    assert read("k1_roofline_pct")(ctx) == pytest.approx(100 * b / 50e-6)
    blocks[0]["locked"] = [12]
    blocks.append(dict(blocks[0]))
    assert read("k1_roofline_pct")(ctx) is None       # 4 launches expected
    assert read("device_idle_pct.cold")(dict(ctx, trace=None)) is None
