"""Ablate the fast profile's approximations against the exact profile, on
a ``tools/quality.py`` workdir (its trained checkpoint and tiles).

    python -m roadsurf_tpu_torch.tools.ablate_fast_profile --workdir DIR
        [--variants NAME,NAME] [--device cuda]

A port of the reference package's ``scripts/ablate_fast_profile.py``: the
newest checkpoint under ``outputs/obj_detector/logs`` scored by
make_detections (batch 16) and final_metrics under each of the script's
variants (``VARIANTS``: detections, proposals, pre-NMS budgets and exact
NMS), then ``R32``, ``int8`` and ``R32+int8`` (``int8_backbone``). The
``--variants`` filter runs twice, as the script's does: once over the
table, once after those three are added. Prints one JSON line a variant
and the {variant: balanced F1} dict, and returns that dict. ``cut``
scores at ``tools/quality.py``'s ``CUT`` sizes, for a workdir that
``quality.run(cut=True)`` made.
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import replace

from ..models.config import fast_profile
from ..utils.config import load_config
from ..utils.device import resolve_device
from ..utils.logging import logger
from ..utils.weights import latest_checkpoint
from .ablate_seeded import cut_config, score, select
from .quality import CONFIG, DET_BATCH, OD, STD


def _variants() -> dict:
    base = replace(fast_profile(), pixel_std=STD, freeze_at=0)

    def budget(pre=None, post=None, dets=None, exact=False):
        kw = {"fast_nms": False} if exact else {}
        for k, v in (("rpn_pre_nms_topk_test", pre),
                     ("rpn_post_nms_topk_test", post),
                     ("detections_per_image", dets)):
            if v is not None:
                kw[k] = v
        return replace(base, **kw)

    return {
        "fast(R64,D8,sweep)": base,
        "D16": budget(dets=16),
        "D16+exactnms": budget(dets=16, exact=True),
        "R128+D16": replace(fast_profile(post_nms_topk=128,
                                         detections_per_image=16),
                            pixel_std=STD, freeze_at=0),
        "exactnms": budget(exact=True),
        "exact(R1000,D100)": budget(1000, 1000, 100, exact=True),
        "pre512": budget(pre=512),
        "pre1024": budget(pre=1024),
        "pre1024+R128": budget(1024, 128),
        "pre1024+R256+D16": budget(1024, 256, 16),
        "pre1024+R512+D32": budget(1024, 512, 32),
        "pre1024+R512+D32+exactnms": budget(1024, 512, 32, exact=True),
        "pre1024+R256+D16+exactnms": budget(1024, 256, 16, exact=True),
    }


VARIANTS = _variants()
# added after the first pass of the filter, as the script adds them
_BASE = VARIANTS["fast(R64,D8,sweep)"]
LATE = {"R32": replace(_BASE, rpn_post_nms_topk_test=32),
        "int8": replace(_BASE, int8_backbone=True),
        "R32+int8": replace(_BASE, rpn_post_nms_topk_test=32,
                            int8_backbone=True)}


def selection(variants: str | list | None = None) -> dict:
    """The runs a ``--variants`` string selects: the filter over the
    table, the three late variants added, the filter again."""
    return select({**select(VARIANTS, variants), **LATE}, variants)


def run(workdir: str, variants=None, device="cuda",
        cut: bool = False) -> dict:
    """The selected variants in ``workdir`` (restored after); returns
    {variant: balanced F1}. Raises when ``device`` names CUDA and no CUDA
    device is present."""
    dev = resolve_device(device)
    cfg = load_config(CONFIG)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        ckpt = latest_checkpoint(f"{OD}/logs")
        results = {}
        for name, mcfg in selection(variants).items():
            logger.info(f"=== variant {name} ===")
            results[name] = score(cfg, ckpt, cut_config(mcfg) if cut
                                  else mcfg, DET_BATCH, dev)["f1b"]
            print(json.dumps({name: results[name]}), flush=True)
        print(json.dumps(results), flush=True)
    finally:
        os.chdir(cwd)
    return results


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Scores a quality workdir's checkpoint under the fast "
                    "profile's approximations and the exact profile.")
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--variants", default="")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(args.workdir, args.variants, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
