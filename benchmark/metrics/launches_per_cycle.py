"""Kernels on the card in the traced stretch over the engine cycles in it
(copies and fills not counted): what the host launches a cycle."""


def read(ctx):
    if not ctx.on_device or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.device_cycles
