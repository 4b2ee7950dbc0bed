"""Share, in %, of the forward's LayerNorm calls that the program's
LayerNorm kernel ran (with the residual sum, the pad and the activation
beside each): its counter ``roadsurf_tpu_torch.ops.layer_norm.counts``
("fused" against "plain") over the run; None where the program has no such
counter or ran no LayerNorm."""

import importlib


def read(ctx):
    try:
        mod = importlib.import_module("roadsurf_tpu_torch.ops.layer_norm")
    except ModuleNotFoundError:
        return None
    counts = getattr(mod, "counts", None)
    if not counts:
        return None
    fused, plain = counts.get("fused", 0), counts.get("plain", 0)
    return 100.0 * fused / (fused + plain) if fused + plain else None
