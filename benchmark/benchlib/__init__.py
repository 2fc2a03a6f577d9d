"""The benchmark of the PyTorch/CUDA port of D-2DGS (``d2dgs_torch``).

``run.py`` drives one cell of ``BENCHMARK.json``: a configuration file
under ``configs/`` and a traffic file under ``traffic/``, both found by
name, and the per-layer metric readers under ``metrics/``, one file per
metric.  Everything the yardstick needs lives here: the inputs made from
the seed (``scene``), the plain float32 reference (``reference``), the
comparison that decides ``correct`` (``compare``), the frozen operation
and byte counts (``counts``) and the reduction of the profiler's trace
(``tracing``).  Only ``program`` imports the port.
"""
