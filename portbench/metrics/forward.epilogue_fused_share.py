"""Share, in %, of the forward's convs whose bias (and the ReLU, residual
sum or top-down sum after it) the program's epilogue kernel applied: its
counter ``roadsurf_tpu_torch.ops.bias_act.counts`` ("fused" against
"plain"; each eager call once, the calls of a CUDA graph once, at its
capture) over the run; None where the program has no such counter."""

import importlib


def read(ctx):
    try:
        mod = importlib.import_module("roadsurf_tpu_torch.ops.bias_act")
    except ModuleNotFoundError:
        return None
    counts = getattr(mod, "counts", None)
    if not counts:
        return None
    fused, plain = counts.get("fused", 0), counts.get("plain", 0)
    return 100.0 * fused / (fused + plain) if fused + plain else None
