"""The top-1 decode's own device time a cycle (ms): ``wt.decode`` spans
(``top1_source_boxes``), over the traced run's cycles
(``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.layer_ms(ctx, "decode")
