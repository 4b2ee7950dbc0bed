"""Paired check of the bit-packed mask downlink: each seeded checkpoint
scored twice, with ``mask_format="u8"`` (mask probabilities, thresholded
after the paste) and ``"bits"`` (thresholded at 0.5 on the device and
packed, 8x fewer bytes to the host), so the F1 difference is the
downlink's alone.

    python -m roadsurf_tpu_torch.tools.ablate_mask_bits [--workdir DIR]
        [--seeds 5] [--batch 16] [--out ablate_mask_bits.json]
        [--device cuda]

A port of the reference package's ``scripts/ablate_mask_bits.py`` over a
``tools/ablate_seeded.py`` workdir: the fast profile with 32 proposals
(std-normalised, no frozen stages), seed ``s``'s newest checkpoint under
``outputs/obj_detector/logs_seed{s}`` (a seed without one is logged and
skipped), make_detections then final_metrics for ``u8`` and then
``bits``. Writes and returns {"per_seed": [{seed, fmt, f1b}],
"delta_bits_minus_u8": [...], "max_abs_delta"}; the script's ``--cpu``
is ``--device cpu``. ``cut`` scores at ``tools/quality.py``'s ``CUT``
sizes, for a workdir that ``ablate_seeded.run(cut=True)`` made.
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
from .ablate_seeded import cut_config, score
from .quality import CONFIG, OD, STD

FORMATS = ("u8", "bits")


def mask_config():
    """The script's model: the fast profile with 32 proposals."""
    return replace(fast_profile(), pixel_std=STD, freeze_at=0,
                   rpn_post_nms_topk_test=32)


def run(workdir: str, seeds: int = 5, batch: int = 16, device="cuda",
        cut: bool = False, out: str = "ablate_mask_bits.json") -> dict:
    """The paired runs in ``workdir`` (restored after); writes ``out``
    there and returns its dict. Raises when ``device`` names CUDA and no
    CUDA device is present."""
    dev = resolve_device(device)
    cfg = load_config(CONFIG)
    mcfg = cut_config(mask_config()) if cut else mask_config()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        rows = []
        for s in range(seeds):
            ckpt = latest_checkpoint(f"{OD}/logs_seed{s}")
            if ckpt is None:
                logger.warning(f"seed {s}: no checkpoint, skipping")
                continue
            for fmt in FORMATS:
                logger.info(f"=== seed {s} mask_format={fmt} ===")
                res = score(cfg, ckpt, mcfg, batch, dev, mask_format=fmt)
                rows.append({"seed": s, "fmt": fmt, "f1b": res["f1b"]})
                print(json.dumps(rows[-1]), flush=True)
        f1 = {(r["seed"], r["fmt"]): r["f1b"] for r in rows}
        deltas = [f1[s, "bits"] - f1[s, "u8"]
                  for s in sorted({r["seed"] for r in rows})]
        res = {"per_seed": rows,
               "delta_bits_minus_u8": [round(d, 4) for d in deltas],
               "max_abs_delta": round(max(abs(d) for d in deltas), 4)}
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps(res), flush=True)
        logger.info(f"wrote {os.path.join(workdir, out)}")
    finally:
        os.chdir(cwd)
    return res


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Scores each seeded checkpoint with the u8 and the "
                    "bit-packed mask downlink and reports the paired F1 "
                    "differences.")
    parser.add_argument("--workdir", default="outputs/ablate_seeded")
    parser.add_argument("--seeds", type=int, default=5)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--out", default="ablate_mask_bits.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(args.workdir, args.seeds, args.batch, device=args.device,
        out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
