"""Host ms a window's dispatch spent copying its results out of the
pinned buffer into the caller's arrays (span ``engine.unpack``): the
engine's ``stats["unpack_s"]`` over the window, per dispatch; None where
the engine keeps no such counter."""


def read(ctx):
    s = ctx.stats.get("unpack_s")
    return s / ctx.dispatches * 1e3 if s is not None and ctx.dispatches \
        else None
