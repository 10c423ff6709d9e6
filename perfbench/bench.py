"""Everything the harness finds by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic mix (``traffic/<name>.json``), its
check (``cells/<name>.json``) and the reader of each metric
(``metrics/<name>.py``, else ``metrics/<name up to its first dot>.py``).

A later change adds a cell or a metric by adding files and entries; no
file here names a cell, a configuration or a metric.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    return load_json(root / config_entry(bench, name)["file"])


def traffic_file(name: str, here: Path = HERE) -> dict:
    return load_json(here / "traffic" / f"{name}.json")


def cell_file(name: str, here: Path = HERE) -> dict:
    return load_json(here / "cells" / f"{name}.json")


def applies(metric: dict, cell: str) -> bool:
    """A metric applies to the cells its ``workloads`` lists; an
    end-to-end metric without the key (``setup_s``) to every cell. A
    per-layer metric always lists its cells."""
    return cell in metric.get("workloads", [cell])


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones."""
    if trace:
        for m in bench["per_layer"]:
            if "workloads" not in m:
                raise KeyError(f"per-layer metric {m['name']!r} lists no "
                               "workloads")
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if applies(m, cell)]


def reader(name: str, here: Path = HERE) -> Callable:
    """``read`` of ``metrics/<name>.py``, or of the file named by the part
    of ``name`` before its first dot (``mfu.train`` -> ``mfu.py``)."""
    for stem in (name, name.split(".")[0]):
        path = here / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                "perfbench.metrics._" + stem.replace(".", "_").replace("-", "_"),
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{here / 'metrics'}")


def read_metrics(bench: dict, cell: str, trace: bool, ctx,
                 here: Path = HERE) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric of the cell that its
    reader finds something to read for."""
    out: Dict[str, dict] = {}
    for m in metrics_for(bench, cell, trace):
        value: Optional[float] = reader(m["name"], here)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
