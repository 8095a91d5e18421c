"""Per-layer metrics: one reader a metric, ``<name>.py``, whose
``read(ctx)`` returns the metric's value from a traced run, or None where
the run holds nothing for it to read (the harness then leaves it out).

``ctx`` (built by ``run.py``): ``trace`` (``trace.Trace``), ``busy_s`` and
``window_s`` (the traced stretch), ``config`` and ``traffic`` (the cell's
files), ``precision``, ``stem_folded``, ``device_cycles`` (engine cycles in
the stretch), ``views`` (views the detector ran in it), ``batches`` (list of
(views a detect call, calls) in it) and ``on_device``."""
