"""Host seconds of the engine's CUDA graph capture (``CapturedGraph.
capture_s``), made in set-up; nothing where the cell runs eagerly."""


def read(ctx):
    return ctx.capture_s
