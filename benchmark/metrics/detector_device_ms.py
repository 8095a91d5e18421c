"""The detector's own device time a cycle (ms): the operations enqueued
inside ``wt.detector`` spans and no inner span (``YoloV8.forward``; the int8
graph from b0 on), over the traced run's cycles (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.layer_ms(ctx, "detector")
