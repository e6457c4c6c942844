"""The SBAS cell's per-layer readers on a made-up two-group window (a GPS
group stepping 10 periods a super-step and an SBAS group stepping 2) whose
answers are known by hand: the SBAS group is found by its ``L``, K1's
bound counts each group's super-steps at their own shape, and nothing is
read without steady blocks."""
from __future__ import annotations

import json

import pytest

from rxbench import catalog, devtrace, peaks

NSAMP = 16368
READERS = ("steady_msps.sbas35", "sbas_steady_ms", "k1_roofline_pct.sbas35",
           "device_idle_pct.sbas35")


def _trace(tmp_path, k1_launches):
    """A 2000 us window with ``k1_launches`` K1 kernels of 2 us each, one
    per 4 us from 100 us on, and one copy of 20 us at 1500 us."""
    ev = [{"name": "rxbench.window", "cat": "user_annotation", "ts": 0.0,
           "dur": 2000.0},
          {"name": "rxbench.block.0", "cat": "user_annotation", "ts": 0.0,
           "dur": 2000.0},
          {"name": "Memcpy DtoH", "cat": "gpu_memcpy", "ts": 1500.0,
           "dur": 20.0}]
    ev += [{"name": "band_taps_cluster_kernel", "cat": "kernel",
            "ts": 100.0 + 4.0 * i, "dur": 2.0} for i in range(k1_launches)]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return devtrace.reduce_trace(str(p))


def _group(L, channels, steady):
    return dict(channels=channels, nsteps=400, nsamp=NSAMP, L=L,
                stage_wall=dict(acquire=0.1, pullin=1.0, steady=steady),
                precompiled=2.0)


def _ctx(tmp_path, sbas_first=False, traced_stages=("steady", "steady")):
    """Job 0 untraced: 3 blocks (one pull-in, two steady) with the GPS
    group's steady wall 0.05 s and the SBAS group's 0.08 s; job 1 traced:
    one block of both groups steady, 40 GPS and 200 SBAS launches."""
    groups = [_group(10, 32, 0.05), _group(2, 3, 0.08)]
    if sbas_first:
        groups.reverse()

    def stages(gps, sbas):
        return [sbas, gps] if sbas_first else [gps, sbas]

    def locked(gps, sbas):
        return [sbas, gps] if sbas_first else [gps, sbas]
    jobs = [dict(index=k, error=None, traced=bool(k), completed=True,
                 taps=13, smax=18, iq=False, groups=groups)
            for k in (0, 1)]
    n = 400 * NSAMP
    blocks = [dict(job=0, t0=0.0, t1=0.2, samples=n,
                   stages=stages("pullin", "pullin"),
                   locked=locked(12, 2), traced=False),
              dict(job=0, t0=0.2, t1=0.25, samples=n,
                   stages=stages("steady", "steady"),
                   locked=locked(12, 2), traced=False),
              dict(job=0, t0=0.25, t1=0.35, samples=n,
                   stages=stages("steady", "steady"),
                   locked=locked(12, 2), traced=False),
              dict(job=1, t0=1.0, t1=1.5, samples=n,
                   stages=stages(*traced_stages),
                   locked=locked(12, 2), traced=True)]
    return dict(jobs=jobs, blocks=blocks, trace=_trace(tmp_path, 240))


@pytest.mark.parametrize("sbas_first", [False, True])
def test_sbas_cell_readers(tmp_path, sbas_first):
    ctx = _ctx(tmp_path, sbas_first)
    read = catalog.reader
    # the untraced job's two steady blocks: 2 x 400 x 16368 samples in
    # 0.15 s
    assert read("steady_msps.sbas35")(ctx) == pytest.approx(
        2 * 400 * NSAMP / 0.15 / 1e6)
    # the SBAS group's (L 2) steady wall over its 2 steady blocks
    assert read("sbas_steady_ms")(ctx) == pytest.approx(40.0)
    # busy: 240 x 2 us + 20 us of 2000 us
    assert read("device_idle_pct.sbas35")(ctx) == pytest.approx(75.0)
    gps = peaks.bound_s(*peaks.k1_work(channels=32, active=12, periods=10,
                                       nsamp=NSAMP, taps=13, smax=18))
    sbas = peaks.bound_s(*peaks.k1_work(channels=3, active=2, periods=2,
                                        nsamp=NSAMP, taps=13, smax=18))
    mean_bound = (40 * gps + 200 * sbas) / 240
    assert read("k1_roofline_pct.sbas35")(ctx) == pytest.approx(
        100.0 * mean_bound / 2e-6)


def test_sbas_cell_readers_without_steady_blocks(tmp_path):
    """No steady block of the SBAS group, or no SBAS group: nothing read;
    a traced block whose SBAS group was still pulling in counts only the
    GPS group's 40 launches, and the trace's 240 read nothing."""
    ctx = _ctx(tmp_path)
    for b in ctx["blocks"]:
        b["stages"][1] = "pullin"
    assert catalog.reader("sbas_steady_ms")(ctx) is None
    assert catalog.reader("steady_msps.sbas35")(ctx) is None
    assert catalog.reader("k1_roofline_pct.sbas35")(ctx) is None
    gps_only = _ctx(tmp_path)
    for j in gps_only["jobs"]:
        j["groups"] = j["groups"][:1]
    assert catalog.reader("sbas_steady_ms")(gps_only) is None
    no_trace = dict(_ctx(tmp_path), trace=None)
    assert catalog.reader("device_idle_pct.sbas35")(no_trace) is None
    assert catalog.reader("k1_roofline_pct.sbas35")(no_trace) is None


def test_sbas_cell_entries():
    """The cell and its four readers are entries of BENCHMARK.json, each
    reader listed for the SBAS cell alone, moving rx_msps."""
    cell = catalog.cell("sbas35.long")
    assert cell.config == "gps32_sbas3" and cell.traffic == "sbas35_long"
    assert cell.mix["sbas"] == [129, 133]
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    for m in cell.per_layer:
        assert m["workloads"] == ["sbas35.long"] and m["moves"] == "rx_msps"
    assert {m["name"] for m in cell.end_to_end} == {"rx_msps", "setup_s"}
