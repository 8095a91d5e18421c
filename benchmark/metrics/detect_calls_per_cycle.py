"""Detect sub-batches a cycle, counted where the work happens: ``wt.detect``
spans over ``wt.cycle`` spans in the traced run (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    lay = spans.layers(ctx)
    if lay is None:
        return None
    return lay.counts.get("wt.detect", 0) / lay.cycles
