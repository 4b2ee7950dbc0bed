"""Time K2 (``roi_align_fused_blocked``) in both modes, bf16 and int8
levels, at the parity profile's main-path shapes, in one or more checkouts
of the repo on one card, so that two versions of the kernel are compared
within one call.

    python3 roadsurf_tpu_torch/tools/time_blocked.py [--rounds N] TREE...

The inputs are ``chip_smoke.py``'s (its ``_parity_pool_inputs`` and
``_quantized``, from each tree, seed 1): B=16, P2..P5 of an 800 px image,
C=256; the box pooler (R=1000, P=7), the mask pooler (R=100, P=14), both
adaptive, and the edge batch's box pooler; and, untimed, edge batches at
P=14 and P=28 (R=13). Each tree runs in a process of its own (the trees
share the package's name), in rounds that alternate them (A B A B ...).
Prints nvidia-smi's name and power limit, then JSON lines: per tree its
build (ptxas's registers and spills), and per (tree, round, case, mode)
the mean time of 50 calls (CUDA events, after 2) and the agreement with
the plain version on the first two images (``chip_smoke._agreement``).
Exits non-zero without a card or when a call disagrees.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CASES = (("box", 1000, 7, False, True), ("mask", 100, 14, False, True),
         ("box_edge", 1000, 7, True, True), ("mask_edge", 13, 14, True, False),
         ("p28_edge", 13, 28, True, False))


def one(tree: str, rnd: int):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from roadsurf_tpu_torch.ops import cuda_build
    from roadsurf_tpu_torch.ops.roi_align import level_assignment, \
        reachable_levels
    from roadsurf_tpu_torch.ops.roi_align_blocked_kernel import \
        roi_align_fused_blocked as kernel, \
        roi_align_fused_blocked_ref as plain

    if rnd == 0:
        r = cuda_build.build("roi_align_blocked")
        print(json.dumps({"tree": tree, "build_s": r["seconds"], "ptxas": [
            ln.strip() for ln in r["log"].splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    ok = True
    for name, R, P, edge, timed in CASES:
        feats, boxes = cs._parity_pool_inputs(g, R, edge)
        lvl = level_assignment(boxes, 224, 4, 2,
                               1 + reachable_levels(feats)).contiguous()
        for int8 in (False, True):
            f, sc = cs._quantized(feats) if int8 else (feats, None)
            got = kernel(f, boxes, lvl, P, 0, feat_scales=sc)
            ref = plain(tuple(x[:2] for x in f), boxes[:2], lvl[:2], P, 0,
                        feat_scales=sc)
            agree = cs._agreement(got[:2], ref)
            ms = cs._time_ms(lambda: kernel(f, boxes, lvl, P, 0,
                                            feat_scales=sc), 50) \
                if timed else None
            ok &= agree["finite"] and agree["out_of_tolerance"] == 0
            print(json.dumps({"tree": tree, "round": rnd, "case": name,
                              "mode": "int8" if int8 else "bf16", "ms": ms,
                              **agree}), flush=True)
    sys.exit(0 if ok else 1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    if args.one is not None:
        one(os.path.abspath(args.trees[0]), args.one)
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for rnd in range(args.rounds):
        for tree in args.trees:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", str(rnd), tree], check=True)


if __name__ == "__main__":
    main()
