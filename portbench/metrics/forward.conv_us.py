"""Device us a tile in kernels of category "conv" (by kernel name,
``portbench.trace.category``) over the traced stretch."""

from portbench.trace import per_tile_us


def read(ctx):
    return per_tile_us(ctx, "conv")
