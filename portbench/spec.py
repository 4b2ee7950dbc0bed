"""Where the benchmark finds what it runs: ``BENCHMARK.json`` at the root
of the checkout names the cells, each a configuration and a traffic mix,
and the metrics; each configuration is ``configs/<name>.json``, each
traffic mix ``traffic/<name>.json``, each metric a reader
``metrics/<name>.py``, and each configuration's model family, named by
its ``"family"`` key (``DEFAULT_FAMILY`` where it has none), a module
``families/<name>.py``: the weights, the class pin, the plain reference
and the work counts of that architecture. A later change adds a cell, a
configuration, a metric or a family by adding files and entries; no code
here names one but the default."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_FAMILY = "r50_fpn"      # the family of a configuration without the key


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json, with "name"
    traffic: dict           # traffic/<traffic>.json, with "name"
    family: ModuleType      # families/<the configuration's family>.py
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
    config = _named("configs", w["config"])
    return Cell(name=name, chips=w["chips"], config=config,
                traffic=_named("traffic", w["traffic"]),
                family=family(config.get("family", DEFAULT_FAMILY)),
                end_to_end=[m for m in bench["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if reports(m, name)])


def _module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py``, loaded from its file."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind}: no {name!r}, {path} is not there")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return _module("metrics", metric).read


def family(name: str) -> ModuleType:
    """``families/<name>.py``: ``weights(st, g, device, dtype)``,
    ``PIN_TILES``, ``pin_classes(state, st, tiles_u8, device)``, ``run(W,
    images_u8, st, given=None, block=8)`` (the plain reference),
    ``forward_flops(st, tile_px)``, ``pooler_bytes(st, precision)``,
    ``nms_bytes(st)`` and ``NARROW`` (the widths, and any sizes, of the
    CPU tests)."""
    return _module("families", name)
