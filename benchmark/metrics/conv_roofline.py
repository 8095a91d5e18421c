"""The bf16 detector's convolutions (cuDNN, ``models/yolov8.py``) against
their roofline: for every convolution of every detect call in the traced
stretch, the larger of its operations at 989 TFLOP/s and its bytes at 3.35
TB/s (bf16 input, weights, bias and output, each read or written once;
``counting.bf16_conv_work``), summed, over the summed device time of the
convolution kernels.  Kernels are told by name, ``PATTERNS``, as the first
trace of the loop named them (torch 2.11, cuDNN on the H100): cuDNN's
implicit-GEMM forward convolutions (``sm90_xmma_fprop_implicit_gemm_bf16...``,
39 a forward) and the cuBLAS GEMMs that the 1x1 convolutions become
(``nvjet_tst_...``, 23 a forward), and cuDNN's layout transforms around
them where the input comes in NCHW (the mixed-geometry loop's
``letterbox_indexed`` output): work of the convolution call, so its time.
The loop's other matrix products are float32 (the folded stem, the
letterbox, the predictor) and named otherwise.  The folded stem's ``b0`` is a matmul chain, not a
convolution, and is left out where the stem is folded."""

from benchmark import counting, trace

PEAK_BF16 = 989e12
PATTERNS = ("fprop", "nvjet", "nchwToNhwcKernel", "nhwcToNchwKernel")
EXCLUDE = ("conv_s8",)


def is_conv(name: str) -> bool:
    return any(p in name for p in PATTERNS) and not any(p in name for p in EXCLUDE)


def read(ctx):
    if not ctx.on_device or ctx.precision != "bf16":
        return None
    kernel_s = trace.kernel_seconds(ctx.trace, is_conv)
    if kernel_s <= 0:
        return None
    convs = [c for c in counting.yolov8_convs(ctx.config) if not (ctx.stem_folded and c.name == "b0")]
    bound = sum(calls * counting.bound_s([counting.bf16_conv_work(c, n) for c in convs], PEAK_BF16)
                for n, calls in ctx.batches)
    return 100.0 * bound / kernel_s
