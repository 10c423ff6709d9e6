"""Metric readers, one file per metric, found by name (see
:func:`perfbench.bench.reader`). Each defines ``read(ctx)`` returning a
number, or None where the run holds nothing to read."""
