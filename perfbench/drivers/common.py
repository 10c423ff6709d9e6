"""What every driver does with the program: its configuration built from
the file's ``port``, the benchmark's weights checked against the layout
the program would draw, the device's numbers, and freeing the card."""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, Optional, Tuple

import torch

from perfbench import weights


def program_config(port: Dict):
    from repro_torch.models.config import ModelConfig, Stage
    kw = dict(port)
    kw["stages"] = tuple(Stage(tuple(s["unit"]), s["repeats"])
                         for s in port["stages"])
    cfg = ModelConfig(**kw)
    for k, v in kw.items():
        if getattr(cfg, k) != v:
            raise ValueError(f"ModelConfig.{k} is {getattr(cfg, k)!r}, "
                             f"the file states {v!r}")
    return cfg


def program_params(port: Dict, cfg, seed: int, dev: torch.device,
                   ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(the leaves by path, the program's tree of the same tensors): the
    benchmark's weights, checked leaf by leaf against the shapes and
    dtypes of ``transformer.init_params`` on the meta device."""
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import MetaGenerator
    flat = weights.make_flat(port, seed, dev)
    tree = weights.tree(port, flat)
    meta = tr.init_params(MetaGenerator(), cfg, device="meta")
    want = list(zip(weights.paths(meta), tr.tree_leaves(meta)))
    got = list(zip(weights.paths(tree), tr.tree_leaves(tree)))
    if [(p, tuple(t.shape), t.dtype) for p, t in want] != \
            [(p, tuple(t.shape), t.dtype) for p, t in got]:
        raise ValueError("the benchmark's weights are not laid out as the "
                         "program's init_params lays them out")
    return flat, tree


def say(msg: str) -> None:
    """A progress line on standard error (the checks come last)."""
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def spread(values) -> str:
    """min/median/max of ``values``, for the progress lines."""
    v = sorted(float(x) for x in values)
    return f"{v[0]:.3f}/{v[len(v) // 2]:.3f}/{v[-1]:.3f}" if v else "-"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def now() -> float:
    return time.perf_counter()


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev: torch.device) -> Optional[int]:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


@dataclasses.dataclass
class Outcome:
    """What a driver hands the harness: the window's numbers (read by the
    end-to-end readers), the traced segment's (by the per-layer ones), and
    each number the check compared, beside its limit."""
    kind: str
    port: Dict
    setup_s: float
    window: Dict
    trace: Optional[Dict]
    checks: Dict[str, float]
    attempted: int
    failed: int
