"""The benchmark's tests: ``python -m pytest perfbench/tests`` from the
repository root. They run on the CPU at smoke size (``data/``); the one
marked ``cuda`` decides inside the test whether there is a card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def smoke_bench():
    """The smoke cells' BENCHMARK-like dict, with the repository's metric
    entries made to apply to every smoke cell."""
    from perfbench import bench as bn
    b = bn.load_json(DATA / "bench.json")
    real = bn.load_bench(ROOT)
    cells = [w["name"] for w in b["workloads"]]
    b["end_to_end"] = [dict(m, workloads=cells) if "workloads" in m else m
                       for m in real["end_to_end"]]
    b["per_layer"] = [dict(m, workloads=cells) for m in real["per_layer"]]
    return b
