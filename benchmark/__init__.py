"""The benchmark of the PyTorch and CUDA port, ``wtracker_tpu_torch``.

Run one cell as ``python -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root (see ``run.py``).
Cells, configurations and metrics are listed in ``BENCHMARK.json``; each
configuration, traffic mix, per-layer metric and cell's limits is a file of
its own here, found by its name.  Nothing in this package imports JAX or the
JAX package ``wtracker_tpu``; the plain reference (``reference/``) imports
nothing of the port either.
"""
