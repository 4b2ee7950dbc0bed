"""From the harness's first line to the window's first hand-over: imports,
kernel builds (from the build cache after a checkout's first run), weights,
the tile pool, the engine and its warm-up with any capture (host clock)."""


def read(ctx):
    return ctx.setup_s
