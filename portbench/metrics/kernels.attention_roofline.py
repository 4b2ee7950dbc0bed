"""% of its roofline that the ViT's attention kernel (K7, found by its
name, ``rel_attention``; category "other") reaches over the traced
stretch: the least time of the traced tiles' attention work (the family's
``attention_work``: FLOPs at 989 TFLOP/s or bytes at 3.35 TB/s, the
larger), over the device time of the kernel's launches. None where the
family counts no attention or the kernel did not run."""

from portbench.trace import traced_tiles


def read(ctx):
    n = traced_tiles(ctx)
    work = getattr(ctx.work, "attention_work", None)
    if not n or work is None:
        return None
    t = sum(s for name, s in ctx.trace["device_ops"]
            if "rel_attention" in name)
    if not t:
        return None
    flops, nbytes = work(ctx.settings, ctx.tile_px)
    need = max(flops / ctx.work.BF16_PEAK, nbytes / ctx.work.HBM_BYTES_PER_S)
    return need * n / t * 100.0
