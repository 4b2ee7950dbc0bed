"""% of the card's bf16 peak that the whole forward's convolutions and
matrix products reach over the traced stretch: the plain reference's
FLOPs a tile at the cell's shapes (``portbench.work.forward_flops``) times
the stretch's tiles a second, over 989 TFLOP/s."""

from portbench.trace import traced_tiles


def read(ctx):
    n = traced_tiles(ctx)
    if n is None:
        return None
    flops = ctx.work.forward_flops(ctx.settings, ctx.tile_px)
    return flops * n / ctx.trace["window_s"] / ctx.work.BF16_PEAK * 100.0
