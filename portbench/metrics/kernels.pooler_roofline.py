"""% of its roofline that the pooler kernel (K1 on the fast profile, K2 on
parity; category "roi_align") reaches over the traced stretch: the least
time its bytes need (``portbench.work.pooler_bytes``, a lower bound from
the shapes) at 3.35 TB/s, over its device time."""

from portbench.trace import traced_tiles


def read(ctx):
    n = traced_tiles(ctx)
    t = ctx.trace["by_category"].get("roi_align") if n else None
    if not t:
        return None
    need = ctx.work.pooler_bytes(ctx.settings, ctx.precision) * n
    return need / ctx.work.HBM_BYTES_PER_S / t * 100.0
