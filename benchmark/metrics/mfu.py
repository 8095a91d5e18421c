"""The whole cycle step's share of the card's peak: the detector's operations
on every view it ran in the traced stretch, counted from the standard
YOLOv8 layer shapes (``counting.ops_per_view``: the same work whether the
stem is folded or fused), over the stretch's length and the configuration's
peak (989 TFLOP/s bf16, 1,979 TOP/s int8; H100 SXM data sheet, dense).  The
renderer, the letterbox, the predictor and the motor are left out of the
count: they are under 1 % of the operations."""

from benchmark import counting


def read(ctx):
    if not ctx.on_device or ctx.busy_s <= 0:
        return None
    ops = counting.ops_per_view(ctx.config) * ctx.views
    return 100.0 * ops / ctx.window_s / float(ctx.config["peak_ops_per_s"])
