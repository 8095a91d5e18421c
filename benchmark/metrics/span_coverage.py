"""Share of the traced run's device time (%) whose enqueue call lies inside
some ``wt.*`` span: what the per-layer device times account for
(``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    lay = spans.layers(ctx)
    if lay is None or lay.total_ns <= 0:
        return None
    return 100.0 * lay.attributed_ns / lay.total_ns
