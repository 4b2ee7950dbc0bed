"""% of its roofline that the exact-NMS kernel (K3, category "nms")
reaches over the traced stretch: the least time its bytes need
(``portbench.work.nms_bytes``) at 3.35 TB/s, over its device time. Read
only where the configuration runs exact NMS."""

from portbench.trace import traced_tiles


def read(ctx):
    n = traced_tiles(ctx)
    t = ctx.trace["by_category"].get("nms") if n else None
    if not t or ctx.settings["fast_nms"]:
        return None
    need = ctx.work.nms_bytes(ctx.settings) * n
    return need / ctx.work.HBM_BYTES_PER_S / t * 100.0
