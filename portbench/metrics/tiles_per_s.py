"""Tiles whose results reached the host, over the whole window, from the
first hand-over to the last result (host clock)."""


def read(ctx):
    return ctx.window.tiles_per_s()
