"""Metric readers: one file a metric, ``metrics/<name>.py``, found by the
metric's name in ``BENCHMARK.json``. A quantity split over groups of
cells (``exchange_us.readme``, ``exchange_us.theta``: each group its own
bound, or its own end-to-end metric to move) is read by the quantity's
file unless the split name has a file of its own.

Each defines ``read(record) -> float | None``. ``record`` is the run's
record (:class:`aggbench.harness.Record`): the window's exchanges and
their walls, the set-up split, the host spans of a traced run and the
reduced profiler trace. A reader that finds nothing to read returns
None, and the metric is left out of the result line.
"""
