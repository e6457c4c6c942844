"""No run loads JAX or the JAX package, the harness reads nothing of the
JAX package's benchmark or of the port's own scripts, and a run without a
card, or without the program beside it, prints no result."""
from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
import types

import pytest

from rxbench import catalog, harness


@pytest.mark.parametrize("planted,hit", [
    ("jax", ["jax"]), ("jax.numpy", ["jax"]), ("flax", ["flax"]),
    ("gnsslib_tpu.ops", ["gnsslib_tpu"]), ("gnsslib_tpu_torch_x", []),
    ("gnsslib_tpu_torch", [])])
def test_isolation_check_compares_whole_top_level_names(monkeypatch,
                                                        planted, hit):
    for name in [m for m in sys.modules
                 if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))
    assert harness.forbidden_modules() == hit


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_and_no_scripts():
    for d, _, files in os.walk(catalog.HERE):
        if os.sep + "tests" in d:
            continue
        for f in files:
            if not f.endswith(".py"):
                continue
            p = os.path.join(d, f)
            for mod in _imports(p):
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "gnsslib_tpu",
                                   "bench", "chip_smoke"), (p, mod)
                assert not mod.startswith("gnsslib_tpu_torch.tools"), (p, mod)
            text = open(p).read()
            assert "bench.py" not in text and "chip_smoke" not in text, p


def _run(cwd, env_extra=None):
    env = dict(os.environ)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "rxbench.run", "--workload", "l1ca32.long",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    """This sandbox has no card: the run exits non-zero, prints no result,
    and does not fall back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _run(catalog.ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_benchmark_alone_no_result(tmp_path):
    """Only BENCHMARK.json and the files under ``paths``: no program to
    run, so no result."""
    shutil.copy(os.path.join(catalog.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(catalog.HERE, tmp_path / "rxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(str(tmp_path), {"PYTHONPATH": ""})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
