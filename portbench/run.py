"""The benchmark's command:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also close standard error. Exits
with another code than 0, and prints no result, without a CUDA device (or
with fewer than the cell asks for) and where a module of JAX or of the
JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "roadsurf_tpu")


def caches():
    """Every kernel cache in a fixed directory of the checkout; the
    program's nvcc builds go to ``roadsurf_tpu_torch/_build`` already."""
    os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / ".cache" /
                                             "torch_extensions")


def threads():
    """One thread for the process's OpenMP pools (torch's intra-op pool,
    numpy's BLAS): the window's host work is one thread's launches and
    unpacking, and idle pool threads that wake beside it on a shared host
    stall the launches that pace an eager cell. Set before torch loads."""
    os.environ["OMP_NUM_THREADS"] = "1"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches()
    threads()
    import torch

    from portbench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"no result: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           T0, device="cuda:0")
    bad = forbidden_modules()
    if bad:
        print("no result: modules of JAX or of the JAX package were "
              "loaded: " + ", ".join(bad), file=sys.stderr)
        return 3
    print(f"memory_peak_bytes {res['device']['memory_peak_bytes']}")
    print(json.dumps(res), flush=True)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {res['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
