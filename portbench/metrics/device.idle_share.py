"""% of the traced stretch in which no kernel, copy or set ran on the
device."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["busy_s"]:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
