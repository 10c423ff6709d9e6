"""One run of one cell: find its files by name, hand them to the driver
of its traffic's kind, read its metrics and decide ``correct``.

``correct`` holds when every number the check compared is finite and at
most its limit (``cells/<cell>.json``). The result's last key,
``checks``, gives each number beside its limit.
"""

from __future__ import annotations

import importlib
import math
from pathlib import Path
from typing import Dict, Optional

from perfbench import bench as bn
from perfbench import modelcfg

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name (up to the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN))


def device_info(dev, peak: Optional[int]) -> Dict:
    import torch
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": peak}


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str, t_start: float, bench: Optional[Dict] = None,
        root: Path = bn.ROOT, data: Path = bn.HERE) -> Dict:
    """The result of one run (the dict ``run.py`` prints). ``bench``,
    ``root`` (where config files lie) and ``data`` (where ``traffic/``
    and ``cells/`` lie) default to the repository's."""
    import torch
    bench = bench or bn.load_bench(root)
    cell = bn.workload(bench, workload)
    port = modelcfg.port_of(bn.config_file(bench, cell["config"], root))
    mix = bn.traffic_file(cell["traffic"], data)
    spec = bn.cell_file(workload, data)
    driver = importlib.import_module(f"perfbench.drivers.{mix['kind']}")
    dev = torch.device(device)
    out = driver.run(port, mix, spec["check"], seed, seconds, trace, dev,
                     t_start)
    checks = {k: {"value": v, "limit": spec["limits"][k]}
              for k, v in out.checks.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    info = device_info(dev, out.window.get("peak_bytes"))
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed,
              "metrics": bn.read_metrics(bench, workload, trace, out),
              "device": info}
    if trace and out.trace is not None:
        info["busy_s"] = out.trace["busy_s"]
        info["window_s"] = out.trace["window_s"]
        result["breakdown"] = out.trace["breakdown"]
    result["checks"] = checks
    return result
