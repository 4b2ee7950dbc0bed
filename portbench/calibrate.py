"""The readings that the limits of ``correct`` are set from, for one cell
in one process: the program on each of ``--seeds`` and the control on
each of ``--control``, each a short window at the cell's own size and
load, then the check. One JSON line a run.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        --control 101,102,103 --seconds 3

The control is the program's own int8 path, the nearest precision below
the configurations' bf16: ``int8_scope="full"`` with the int8 pyramid,
calibrated by ``models.quant.prepare_quantized`` on the pool's first
eight tiles, as ``tools/bench.py`` runs it by default. The benchmark's
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from dataclasses import replace

CALIB_TILES = 8


def int8_control(cfg, state, pool, dev):
    """(cfg, state) -> the program's int8 path on the same weights."""
    from roadsurf_tpu_torch.models.quant import prepare_quantized

    cfg = replace(cfg, int8_scope="full", int8_pyramid=True)
    q = prepare_quantized(state, pool[:CALIB_TILES], cfg, device=dev)
    return cfg, dict(state, quant=q)


def _seeds(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    from portbench.run import caches

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    caches()
    from portbench import harness, spec

    cell = spec.cell(args.workload)
    runs = [(s, "program", None) for s in _seeds(args.seeds)] + \
        [(s, "control", int8_control) for s in _seeds(args.control)]
    for seed, kind, prepare in runs:
        t0 = time.perf_counter()
        try:
            res = harness.run_cell(cell, seed, args.seconds, False, t0,
                                   device=args.device, prepare=prepare)
        except Exception as e:            # a control that crashes has failed
            traceback.print_exc()
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "kind": kind, "error": repr(e)}), flush=True)
            continue
        print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                          "correct": res["correct"],
                          "readings": res["readings"],
                          "metrics": res["metrics"],
                          "peak": res["device"]["memory_peak_bytes"],
                          "run_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
