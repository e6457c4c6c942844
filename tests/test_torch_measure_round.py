"""The port's ``measure_round`` (counterparts of test_measure_round.py:
child retry with the card's device name, a timeout as a failure, the
artifact merge; and the default artifact's name), and every port tool's
refusal to run without a card."""
import json
import os
import subprocess
import sys

import pytest
import torch

from gnsslib_tpu_torch.tools import measure_round as mr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("receiver_throughput", "ttff", "profile_receiver",
         "scaling_channels", "receiver_256ch", "acq_throughput",
         "e2e_receiver_check", "measure_round", "parity_vs_reference")


def test_run_child_parses_last_json_and_retries(tmp_path):
    """A child that dies (rc != 0, no JSON) is run again; the last JSON
    line wins; a result from another device than ``cuda`` is refused with
    ``want_gpu``; the diagnostics carry the stderr tail."""
    script = tmp_path / "child.py"
    marker = tmp_path / "attempts"
    script.write_text("""
import json, os, sys
n = int(open(r"%s").read()) if os.path.exists(r"%s") else 0
open(r"%s", "w").write(str(n + 1))
if n == 0:
    print("some diagnostic", file=sys.stderr)
    sys.exit(3)                     # first attempt dies
if n == 1:
    print(json.dumps({"value": 1.0, "device": "cpu"}))
    sys.exit(0)                     # second: lands, not on the card
print("# progress line")
print(json.dumps({"value": 1.0, "device": "cuda"}))
print(json.dumps({"value": 2.0, "device": "cuda"}))   # last line wins
""" % (marker, marker, marker))
    r, diags = mr._run_child([sys.executable, str(script)], timeout_s=30,
                             want_gpu=True, retries=4, label="t")
    assert r is not None and r["value"] == 2.0 and r["attempts"] == 3
    assert len(diags) == 2
    assert diags[0]["rc"] == 3
    assert diags[0]["stderr_tail"] == ["some diagnostic"]
    assert diags[1]["device"] == "cpu"      # refused: not the card


def test_run_child_timeout_is_a_failure(tmp_path):
    script = tmp_path / "hang.py"
    script.write_text("import time\ntime.sleep(60)\n")
    r, diags = mr._run_child([sys.executable, str(script)], timeout_s=1,
                             want_gpu=True, retries=2, label="t")
    assert r is None
    assert [d["rc"] for d in diags] == ["timeout", "timeout"]


def test_artifact_merge_preserves_other_sections(tmp_path):
    """A re-measure with parts skipped updates the existing artifact in
    place instead of discarding the sections it skipped (main() run for
    real with everything skipped); the bench section is recorded absent."""
    out = tmp_path / "M.json"
    out.write_text(json.dumps({"round": 7, "unix_time": 1,
                               "acq": {"value": 42.0, "device": "cuda"},
                               "receiver_median_msps": 99.0}))
    p = subprocess.run(
        [sys.executable, "-m", "gnsslib_tpu_torch.tools.measure_round",
         "--device", "cpu", "--round", "7", "--out", str(out),
         "--skip", "bench,acq,receiver,ttff"],
        cwd=ROOT, capture_output=True, timeout=120)
    assert p.returncode == 0, p.stderr
    final = json.loads(out.read_text())
    assert final["acq"]["value"] == 42.0            # skipped: preserved
    assert final["receiver_median_msps"] == 99.0
    assert final["unix_time"] != 1                  # re-stamped
    assert final["bench"] is None                   # no benchmark yet


def test_default_artifact_is_the_ports_own(tmp_path, monkeypatch):
    """The default artifact is MEASUREMENTS_torch_rNN.json, numbered after
    the existing MEASUREMENTS_torch_r*.json; the JAX package's
    MEASUREMENTS_r*.json and BENCH_r*.json neither number it nor are
    written."""
    jax_files = {"MEASUREMENTS_r09.json": '{"round": 9}',
                 "BENCH_r12.json": '{"value": 1}'}
    for name, text in jax_files.items():
        (tmp_path / name).write_text(text)
    (tmp_path / "MEASUREMENTS_torch_r03.json").write_text('{"round": 3}')
    monkeypatch.setattr(mr, "REPO", str(tmp_path))
    assert mr.default_round() == 4
    assert mr.main(["--device", "cpu",
                    "--skip", "bench,acq,receiver,ttff"]) == 0
    assert sorted(os.listdir(tmp_path)) == [
        "BENCH_r12.json", "MEASUREMENTS_r09.json",
        "MEASUREMENTS_torch_r03.json", "MEASUREMENTS_torch_r04.json"]
    for name, text in jax_files.items():
        assert (tmp_path / name).read_text() == text
    art = json.loads((tmp_path / "MEASUREMENTS_torch_r04.json").read_text())
    assert art["round"] == 4 and art["bench"] is None


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_without_card_exits_2(tool):
    """``--device cuda`` (the default) without a card: exit 2 with "no
    CUDA card", before any work (no capture synthesized)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run(
        [sys.executable, "-m", f"gnsslib_tpu_torch.tools.{tool}",
         "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2, (p.stdout, p.stderr)
    assert "no CUDA card" in p.stderr
    assert p.stdout == ""
