"""Discovery by name, and the import rule."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

from conftest import narrow

from portbench import harness, spec

ROOT = Path(__file__).resolve().parents[2]


def test_a_new_cell_is_a_file(tmp_path, monkeypatch):
    """A cell added as a traffic file and a BENCHMARK.json entry runs with
    no code edited."""
    for d in ("configs", "traffic", "metrics", "families"):
        shutil.copytree(spec.HERE / d, tmp_path / d)
    mix = json.loads((spec.HERE / "traffic" / "detect-b16.json").read_text())
    mix.update(batch=3, scan_k=2)
    (tmp_path / "traffic" / "detect-b3-k2.json").write_text(json.dumps(mix))
    bench = spec.benchmark()
    bench["workloads"].append({"name": "fast-256.detect-b3-k2",
                               "config": "fast-256",
                               "traffic": "detect-b3-k2", "chips": 1,
                               "why": "a test"})
    monkeypatch.setattr(spec, "HERE", tmp_path)
    cell = spec.cell("fast-256.detect-b3-k2", bench)
    assert cell.traffic["scan_k"] == 2 and cell.config["name"] == "fast-256"
    ov = narrow(cell)
    ov["traffic"]["batch"] = 3
    ov["traffic"]["pool_tiles"] = 12
    res = harness.run_cell(cell, 11, 0.3, False, time.perf_counter(),
                           device="cpu", overrides=ov)
    assert res["correct"]
    assert res["attempted"] % 6 == 0          # whole groups of 2 batches


def test_benchmark_names_existing_files():
    bench = spec.benchmark()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


_PROBE = """
import sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
{body}
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(top))
"""


def _modules(body: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(ROOT), tests=str(
            Path(__file__).parent), body=body)],
        capture_output=True, text=True, timeout=600, check=True, cwd=ROOT)
    return set(out.stdout.split("\n")[-2].split())


def test_a_run_loads_no_jax():
    """After a dry run, no module whose top-level name, compared whole, is
    jax, jaxlib, flax or roadsurf_tpu (roadsurf_tpu_torch is the program)."""
    mods = _modules(
        "import conftest\n"
        "from portbench import spec, harness\n"
        "c = spec.cell('parity-800.detect-b16')\n"
        "harness.run_cell(c, 3, 0.2, True, time.perf_counter(), "
        "device='cpu', overrides=conftest.narrow(c))\n"
        "from portbench.run import forbidden_modules\n"
        "assert forbidden_modules() == [], forbidden_modules()\n")
    assert "roadsurf_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "roadsurf_tpu"}


def test_the_reference_stands_alone():
    """The reference, the check, the work counts and every model family
    (``families/*.py``) import nothing of the program, of JAX or of the
    JAX package."""
    names = sorted(p.stem for p in (spec.HERE / "families").glob("*.py"))
    assert names
    mods = _modules("import portbench.reference, portbench.check, "
                    "portbench.work, portbench.window, portbench.trace\n"
                    "from portbench import spec\n"
                    f"for name in {names!r}:\n"
                    "    spec.family(name)\n")
    assert not mods & {"jax", "jaxlib", "flax", "roadsurf_tpu",
                       "roadsurf_tpu_torch"}


def test_forbidden_compares_whole_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "roadsurf_tpu_torch.x", object())
    monkeypatch.setitem(sys.modules, "jaxlibx", object())
    assert not [m for m in run.forbidden_modules()
                if m.startswith(("roadsurf_tpu_torch", "jaxlibx"))]
    monkeypatch.setitem(sys.modules, "roadsurf_tpu.ops", object())
    assert "roadsurf_tpu.ops" in run.forbidden_modules()
