"""Time one of the port's kernels in one or more checkouts of the repo on
one card, so that two versions of a kernel are compared within one call.

    python3 roadsurf_tpu_torch/tools/time_kernels.py \\
        --kernel {k1,k2,k4,k5} [--k1-shapes] [--rounds N] TREE...

The inputs are those of this checkout's ``chip_smoke.py`` (its
``_pool_inputs``, ``_parity_pool_inputs``, ``_quantized``,
``_gemm_inputs`` and ``_k5_inputs``), the same for every tree; each
tree's own kernel wrapper and plain version are called. Each tree runs in
a process of its own (the trees share the package's name), in rounds that
alternate them (A B A B ...).

- ``k1`` (``roi_align_fused``): the fast profile's poolers (B=64, P2..P4
  of a 256 px tile, C=256, s=2; box R=32 P=7, mask R=8 P=14) in both modes,
  bf16 and int8 levels; untimed, the edge batch at those poolers and at
  ``chip_smoke.SPLIT`` (R 37 and 13, P 28).
- ``k2`` (``roi_align_fused_blocked``): the parity profile's poolers (B=16,
  P2..P5 of an 800 px image; box R=1000 P=7, mask R=100 P=14, adaptive)
  and the edge batch's box pooler in both modes; untimed, edge batches at
  P=14 and P=28 (R=13). With ``--k1-shapes``, K2's kernel at K1's cases
  instead (fixed s=2 on the fast profile's levels).
- ``k4`` (``int8_gemm``): the seven GEMMs of ``chip_smoke.GEMMS`` in the
  raw, bf16 and int8 modes, beside ``torch._int_mm`` (raw), each as
  ``chip_smoke._gemm_case`` times it: event time, and the device time of
  its kernels (torch.profiler; at the small shapes the event time is the
  host's launch path); untimed, the ragged shapes of
  ``chip_smoke.GEMM_EDGES``.
- ``k5`` (``roi_align_backward``): the poolers' gradient at
  ``chip_smoke.K5_CASES`` (the YAML's box R=1016 P=7 and mask M=128 P=14
  at 800 px, adaptive; the fast profile's at 256 px, s=2): timed at the
  training batch B=8 with bf16 gradients, as a training step calls it;
  untimed, float32 gradients at B=2 (random and edge boxes) against the
  tree's plain version within ``chip_smoke.K5_REL``·max|plain| +
  ``K5_ABS``.

Prints nvidia-smi's name and power limit, then JSON lines: per tree its
build (ptxas's registers and spills), per (tree, round, case, mode) the
mean time of 20 calls (CUDA events, after 2) and the agreement with the
plain version (poolers: ``chip_smoke._agreement``, on the first two images
for K2's parity cases; K4: mismatches, bit for bit; K5: the values beyond
its tolerance), and at the end one
``summary`` line per (tree, case, mode): the times of every round (K4: the
device times too).
Exits non-zero without a card or when a call disagrees.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# K2's parity cases: (name, R, P, edge, timed)
K2_CASES = (("box", 1000, 7, False, True), ("mask", 100, 14, False, True),
            ("box_edge", 1000, 7, True, True),
            ("mask_edge", 13, 14, True, False),
            ("p28_edge", 13, 28, True, False))


def _inputs_module():
    """This checkout's chip_smoke.py, under a name of its own (the tree
    under test is first on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "_time_kernels_inputs", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pooler_cases(cs, kernel_name: str, k1_shapes: bool):
    """(name, R, P, sampling, edge, timed, fast shapes) of a pooler."""
    if kernel_name == "k1" or k1_shapes:
        return [(n, R, P, 2, False, True, True) for n, R, P in cs.POOLERS] \
            + [(n + "_edge", R, P, 2, True, False, True)
               for n, R, P in cs.POOLERS + cs.SPLIT]
    return [(n, R, P, 0, edge, timed, False)
            for n, R, P, edge, timed in K2_CASES]


def _poolers(tree_mod, cs, kernel_name: str, k1_shapes: bool, emit):
    import torch

    from roadsurf_tpu_torch.ops.roi_align import level_assignment, \
        reachable_levels

    kernel, plain = tree_mod
    g = torch.Generator(device="cuda").manual_seed(
        0 if kernel_name == "k1" or k1_shapes else 1)
    ok = True
    for name, R, P, s, edge, timed, fast in _pooler_cases(cs, kernel_name,
                                                          k1_shapes):
        feats, boxes = cs._pool_inputs(g, R, edge) if fast \
            else cs._parity_pool_inputs(g, R, edge)
        lvl = level_assignment(boxes, 224, 4, 2,
                               1 + reachable_levels(feats)).contiguous()
        # the parity cases' plain version on two images (its intermediates
        # are large); the fast ones' on the whole batch
        n = boxes.shape[0] if fast else 2
        for int8 in (False, True):
            f, sc = cs._quantized(feats) if int8 else (feats, None)
            got = kernel(f, boxes, lvl, P, s, feat_scales=sc)
            ref = plain(tuple(x[:n] for x in f), boxes[:n], lvl[:n], P, s,
                        feat_scales=sc)
            agree = cs._agreement(got[:n], ref)
            del got, ref
            ms = cs._time_ms(lambda: kernel(f, boxes, lvl, P, s,
                                            feat_scales=sc), 20) \
                if timed else None
            ok &= agree["finite"] and agree["out_of_tolerance"] == 0
            emit({"case": name, "mode": "int8" if int8 else "bf16",
                  "ms": ms, **agree})
        torch.cuda.empty_cache()
    return ok


def _gemms(cs, emit):
    import torch

    from roadsurf_tpu_torch.ops.int8_gemm import int8_gemm, int8_gemm_ref

    g = torch.Generator(device="cuda").manual_seed(3)
    shapes = [(n, M, K, N, 0, True) for n, M, K, N in cs.GEMMS] \
        + [(*e, False) for e in cs.GEMM_EDGES]
    ok = True
    for name, M, K, N, offset, timed in shapes:
        a, w, mult, bias = cs._gemm_inputs(g, M, K, N, offset)
        for mode, kw in cs.GEMM_MODES:
            case = cs._gemm_case(int8_gemm, int8_gemm_ref, a, w,
                                 kw(mult, bias), timed)
            ok &= case["mismatches"] == 0
            emit({"case": name, "mode": mode, **case})
    return ok


def _k5(tree_mod, cs, emit):
    import torch

    from roadsurf_tpu_torch.ops.roi_align import level_assignment, \
        reachable_levels

    kernel, plain = tree_mod
    g = torch.Generator(device="cuda").manual_seed(5)
    ok = True
    for name, side, levels, R, P, s, _ in cs.K5_CASES:
        for Bn, edge in ((cs.K5_CHECK_B, False), (cs.K5_CHECK_B, True),
                         (cs.TB, False)):
            shapes, dout, boxes = cs._k5_inputs(g, Bn, side, levels, R, P,
                                                edge)
            n_lev = reachable_levels([torch.empty(sh, device="meta")
                                      for sh in shapes])
            shapes = shapes[:n_lev]
            lvl = level_assignment(boxes, 224, 4, 2, 1 + n_lev).contiguous()
            if Bn == cs.TB:
                ms = cs._time_ms(lambda: kernel(dout, shapes, boxes, lvl, P,
                                                s), 20)
                emit({"case": name, "mode": "bf16", "B": Bn, "ms": ms})
                continue
            got = kernel(dout, shapes, boxes, lvl, P, s, dtype=torch.float32)
            ref = plain(dout, shapes, boxes, lvl, P, s)
            bad, err = 0, 0.0
            for k, r in zip(got, ref):
                e = (k - r).abs()
                bad += int((e > cs.K5_REL * float(r.abs().max())
                            + cs.K5_ABS).sum())
                err = max(err, float(e.max()))
            ok &= bad == 0
            emit({"case": name + ("_edge" if edge else ""), "mode": "f32",
                  "B": Bn, "max_abs_err": err, "out_of_tolerance": bad})
            del got, ref
        torch.cuda.empty_cache()
    return ok


def one(tree: str, rnd: int, kernel_name: str, k1_shapes: bool):
    cs = _inputs_module()
    sys.path.insert(0, tree)
    os.chdir(tree)
    from roadsurf_tpu_torch.ops import cuda_build

    source = {"k1": "roi_align", "k2": "roi_align_blocked",
              "k4": "int8_gemm", "k5": "roi_align_backward"}[kernel_name]
    if rnd == 0:
        r = cuda_build.build(source)
        print(json.dumps({"tree": tree, "build_s": r["seconds"], "ptxas": [
            ln.strip() for ln in r["log"].splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)

    def emit(rec):
        print(json.dumps({"tree": tree, "round": rnd, "kernel": kernel_name,
                          **rec}), flush=True)

    if kernel_name == "k4":
        ok = _gemms(cs, emit)
    elif kernel_name == "k5":
        from roadsurf_tpu_torch.ops.roi_align_backward_kernel import \
            roi_align_backward, roi_align_backward_ref
        ok = _k5((roi_align_backward, roi_align_backward_ref), cs, emit)
    else:
        if kernel_name == "k1":
            from roadsurf_tpu_torch.ops.roi_align_kernel import \
                roi_align_fused as kernel, roi_align_fused_ref as plain
        else:
            from roadsurf_tpu_torch.ops.roi_align_blocked_kernel import \
                roi_align_fused_blocked as kernel, \
                roi_align_fused_blocked_ref as plain
        ok = _poolers((kernel, plain), cs, kernel_name, k1_shapes, emit)
    sys.exit(0 if ok else 1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("k1", "k2", "k4", "k5"),
                    required=True)
    ap.add_argument("--k1-shapes", action="store_true",
                    help="k2 only: run K2's kernel at K1's cases")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    if args.one is not None:
        one(os.path.abspath(args.trees[0]), args.one, args.kernel,
            args.k1_shapes)
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    times: dict = {}
    failed = False
    for rnd in range(args.rounds):
        for tree in args.trees:
            cmd = [sys.executable, os.path.abspath(__file__), "--one",
                   str(rnd), "--kernel", args.kernel, tree]
            if args.k1_shapes:
                cmd.insert(-1, "--k1-shapes")
            proc = subprocess.run(cmd, capture_output=True, text=True)
            sys.stdout.write(proc.stdout)
            sys.stderr.write(proc.stderr[-4000:])
            sys.stdout.flush()
            failed |= proc.returncode != 0
            for line in proc.stdout.splitlines():
                rec = json.loads(line)
                for key in ("ms", "device_ms", "library_device_ms"):
                    if rec.get(key) is not None:
                        times.setdefault((tree, rec["case"], rec["mode"]),
                                         {}).setdefault(key, []).append(
                                             rec[key])
    for (tree, case, mode), ms in times.items():
        print(json.dumps({"summary": True, "kernel": args.kernel,
                          "tree": tree, "case": case, "mode": mode, **ms}),
              flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
