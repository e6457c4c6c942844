"""Finds the pieces of a cell by name: ``BENCHMARK.json`` at the root of
the checkout, a configuration under ``rxbench/configs/<name>/``
(``config.json`` with the INI pair beside it), a traffic mix at
``rxbench/traffic/<name>.json`` and a per-layer metric's reader at
``rxbench/metrics/<name>.py`` (a module with ``read(ctx)``)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    config_dir: str
    config_meta: dict
    mix: dict
    end_to_end: list        # the metric entries this cell reports
    per_layer: list
    limits: dict            # the limit of each number compared


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def config_dir(name: str, base: str = HERE) -> str:
    return os.path.join(base, "configs", name)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(name: str, base: str = HERE) -> dict:
    return _json(os.path.join(config_dir(name, base), "config.json"))


def load_traffic(name: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, "traffic", f"{name}.json"))


def load_limits(cell: str, base: str = HERE) -> dict:
    """The limits of the cell's compared numbers
    (``rxbench/limits/<cell>.json``)."""
    return _json(os.path.join(base, "limits", f"{cell}.json"))


def reader(metric: str, base: str = HERE):
    """The ``read(ctx)`` function of ``rxbench/metrics/<metric>.py``."""
    path = os.path.join(base, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "rxbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, bench: dict | None = None, base: str = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``) with its
    configuration, traffic, metrics and limits, found under ``base``."""
    bench = benchmark() if bench is None else bench
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name=name, config=w["config"], traffic=w["traffic"],
                chips=int(w["chips"]),
                config_dir=config_dir(w["config"], base),
                config_meta=load_config(w["config"], base),
                mix=load_traffic(w["traffic"], base), end_to_end=e2e,
                per_layer=per, limits=load_limits(name, base))
