"""Where the benchmark finds what it runs: ``BENCHMARK.json`` at the root
of the checkout names the cells, each a configuration and a traffic mix,
and the metrics; each configuration is ``configs/<name>.json``, each
traffic mix ``traffic/<name>.json`` and each metric a reader
``metrics/<name>.py``. A later change adds a cell, a configuration or a
metric by adding files and entries; no code here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json, with "name"
    traffic: dict           # traffic/<traffic>.json, with "name"
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path | None = None) -> dict:
    return load_json(path or ROOT / "BENCHMARK.json")


def _named(kind: str, name: str) -> dict:
    d = load_json(HERE / kind / f"{name}.json")
    d["name"] = name
    return d


def reports(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is read in ``cell``: every cell unless the entry
    lists its cells."""
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       + ", ".join(w["name"] for w in bench["workloads"]))
    w = entries[0]
    return Cell(name=name, chips=w["chips"], config=_named("configs", w["config"]),
                traffic=_named("traffic", w["traffic"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if reports(m, name)])


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
