"""The int8 convolution kernel K2 (``ops/conv_s8.py`` -> ``csrc/conv_s8.cu``)
against its roofline: for every convolution it ran in the traced stretch,
the larger of its operations at 1,979 TOP/s and its bytes at 3.35 TB/s
(int8 input and weights, a float32 scale and bias a channel, int8 output or
bf16 logits, each read or written once; ``counting.k2_work``), summed, over
K2's summed device time.  The folded stem's ``b0`` runs as matmuls, not K2,
and is left out where the stem is folded."""

from benchmark import counting, trace

PEAK_INT8 = 1979e12


def read(ctx):
    if not ctx.on_device or ctx.precision != "int8":
        return None
    kernel_s = trace.kernel_seconds(ctx.trace, lambda name: "conv_s8_kernel" in name)
    if kernel_s <= 0:
        return None
    convs = [c for c in counting.yolov8_convs(ctx.config) if not (ctx.stem_folded and c.name == "b0")]
    bound = sum(calls * counting.bound_s([counting.k2_work(c, n) for c in convs], PEAK_INT8)
                for n, calls in ctx.batches)
    return 100.0 * bound / kernel_s
