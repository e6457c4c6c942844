"""Each cell of ``BENCHMARK.json`` on the card, as ``python3 -m
rxbench.run`` runs it from the root (a short window): a result line with
``correct`` true.  Needs a CUDA card (marked ``cuda``; skipped here
without one)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from rxbench import catalog

CELLS = [w["name"] for w in catalog.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run(
        [sys.executable, "-m", "rxbench.run", "--workload", cell,
         "--seed", str(2 ** 31 + 4242), "--seconds", "10", "--trace", "0"],
        cwd=catalog.ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
