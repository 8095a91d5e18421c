"""Share of the traced stretch in which no operation (kernel, copy, fill) ran
on the card: 100 (1 - busy / window), busy the union of the device
operations' intervals (``trace.union_s``)."""


def read(ctx):
    if not ctx.on_device or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
