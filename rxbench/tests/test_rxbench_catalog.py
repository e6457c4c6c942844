"""Every piece ``BENCHMARK.json`` names loads by name, the file keeps to
the benchmark file's required shape, and a new cell, configuration, traffic mix
or metric is added as new files without editing one that is there."""
from __future__ import annotations

import hashlib
import json
import os
import re

import pytest

from rxbench import catalog

BENCH = catalog.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rxbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("rxbench/") and os.path.exists(
            os.path.join(catalog.ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_pieces_load_by_name(name):
    from gnsslib_tpu_torch.runtime.config import load_ini
    cell = catalog.cell(name)
    cfg = load_ini(os.path.join(cell.config_dir, "gnss-sdrcli.ini"))
    assert cfg.channels and cfg.fends
    assert cell.config_meta["reduced"] == []
    for key in ("gps", "cn0_dbhz", "captures", "seconds", "warm_seconds",
                "trace"):
        assert key in cell.mix
    assert set(cell.limits) == {"acq_bad", "acq_miss", "acq_dop_err_hz",
                                "nav_bad", "nav_miss", "obs_miss",
                                "pr_err_m"}
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(catalog.reader(m["name"]))


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py") or f.endswith(".json") or f.endswith(".ini"):
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_pieces_are_new_files(tmp_path):
    """A later cell brings its configuration, traffic, limits and metric
    reader as files of its own; nothing of ``rxbench/`` changes."""
    before = _digest(catalog.HERE)
    base = tmp_path
    src = catalog.config_dir("gps_l1ca_32ch")
    (base / "configs" / "newcfg").mkdir(parents=True)
    for f in os.listdir(src):
        (base / "configs" / "newcfg" / f).write_text(
            open(os.path.join(src, f)).read())
    (base / "traffic").mkdir()
    mix = catalog.load_traffic("cold")
    mix["seconds"] = 30.0
    (base / "traffic" / "newmix.json").write_text(json.dumps(mix))
    (base / "limits").mkdir()
    (base / "limits" / "new.cell.json").write_text(json.dumps(
        catalog.load_limits("l1ca32.cold")))
    (base / "metrics").mkdir()
    (base / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return len(ctx['jobs'])\n")
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [dict(
        name="new.cell", config="newcfg", traffic="newmix", chips=1,
        why="a later cell")]
    bench["per_layer"] = BENCH["per_layer"] + [dict(
        name="new_metric", unit="jobs", better="higher",
        source="host_clock", layer="runtime", moves="rx_msps",
        workloads=["new.cell"])]
    cell = catalog.cell("new.cell", bench, str(base))
    assert cell.mix["seconds"] == 30.0
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    assert catalog.reader("new_metric", str(base))({"jobs": [1, 2]}) == 2
    assert _digest(catalog.HERE) == before
