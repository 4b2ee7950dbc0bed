"""Host ms a window's dispatch spent waiting for its result: the engine's
``stats["d2h_s"]`` over the window, per dispatch."""


def read(ctx):
    return ctx.stats["d2h_s"] / ctx.dispatches * 1e3 if ctx.dispatches \
        else None
