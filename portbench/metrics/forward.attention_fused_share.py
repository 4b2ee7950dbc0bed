"""Share, in %, of the forward's attention calls that the program's
attention kernel ran: its counter ``roadsurf_tpu_torch.ops.attention.
counts`` ("fused" against "plain") over the run; None where the program
has no such counter or ran no attention."""

import importlib


def read(ctx):
    try:
        mod = importlib.import_module("roadsurf_tpu_torch.ops.attention")
    except ModuleNotFoundError:
        return None
    counts = getattr(mod, "counts", None)
    if not counts:
        return None
    fused, plain = counts.get("fused", 0), counts.get("plain", 0)
    return 100.0 * fused / (fused + plain) if fused + plain else None
