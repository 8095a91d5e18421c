"""The engine loop's own device time a cycle (ms): the operations enqueued
inside ``wt.run``, ``wt.cycle`` or ``wt.detect`` and no inner span (carry
set-up, the cycle's index and position arithmetic, sub-batch concatenation,
the logs' stack), over the traced run's cycles.  With the six layers'
metrics it sums to all the device time enqueued inside spans
(``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.engine_ms(ctx)
