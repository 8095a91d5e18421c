"""The motor's own device time a cycle (ms): ``wt.motor`` spans (the sine
motor's integer steps and clamps, ``sim/engine.py::_move``), over the
traced run's cycles (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.layer_ms(ctx, "motor")
