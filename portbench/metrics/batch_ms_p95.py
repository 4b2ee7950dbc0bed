"""The 95th percentile over all of the window's batches of the time from
a batch's hand-over to the engine to its result being yielded (host
clock)."""

from portbench.window import percentile


def read(ctx):
    return percentile(ctx.window.latencies_ms(), 95)
