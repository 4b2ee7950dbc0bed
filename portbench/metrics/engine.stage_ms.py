"""Host ms a window's dispatch spent staging tiles into pinned memory and
issuing the upload: the engine's ``stats["h2d_s"]`` over the window, per
dispatch."""


def read(ctx):
    return ctx.stats["h2d_s"] / ctx.dispatches * 1e3 if ctx.dispatches \
        else None
