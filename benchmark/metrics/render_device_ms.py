"""The renderer's own device time a cycle (ms): ``wt.render`` spans
(``SyntheticScene.render_views``), over the traced run's cycles
(``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.layer_ms(ctx, "render")
