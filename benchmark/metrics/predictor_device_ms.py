"""The ring update's and the movement decision's own device time a cycle
(ms): ``wt.predict`` spans (``_ring_set`` and the ResMLP decision), over the
traced run's cycles (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.layer_ms(ctx, "predictor")
