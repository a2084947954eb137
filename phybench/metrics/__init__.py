"""The per-layer metrics, one reader per file, found by the metric's name.

Each ``<metric>.py`` defines ``UNIT``, ``LAYER``, ``MOVES`` (as its entry in
BENCHMARK.json has them) and ``read(r)``, which takes the traced run's
readings (``phybench.run.Readings``) and returns the number, or None where
the run has nothing to read (the harness then leaves the metric out).
"""
