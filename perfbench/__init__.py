"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell, one
run, driven by data. ``run.py`` is the entry point; ``BENCHMARK.json`` at
the repository root names the cells, and each configuration, traffic mix,
cell check and metric reader lives in a file of its own here, found by
name."""
