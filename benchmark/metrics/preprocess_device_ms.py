"""Preprocessing's own device time a cycle (ms): ``wt.preprocess`` spans
(the folded stem, which computes the letterbox and b0 as one set of
matmuls; ``letterbox``; ``letterbox_indexed``), over the traced run's
cycles (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.layer_ms(ctx, "preprocess")
