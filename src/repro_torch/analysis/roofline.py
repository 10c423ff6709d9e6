"""Roofline terms of one dry-run cell, for an NVIDIA H100.

Port of ``repro/analysis/roofline.py``. Three terms per (arch x shape x
mesh), in seconds, from one rank's operation counts
(:mod:`repro_torch.analysis.op_stats`):

  compute    = FLOPs / PEAK_FLOPS
  memory     = device-memory bytes / HBM_BW
  collective = collective operand bytes / LINK_BW

Hardware constants: one H100 SXM (NVIDIA's data sheet, dense, at its 700
W limit): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3, and
NVLink 4's 900 GB/s bidirectional, 450 GB/s a direction. The production
meshes' 16-wide model axis spans two 8-card NVLink servers, whose links
between servers are slower than NVLink, so the collective term is a lower
bound.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.distributed.sharding import leaves

PEAK_FLOPS = 989e12      # bf16 per card, dense
HBM_BW = 3.35e12         # bytes/s per card
LINK_BW = 450e9          # bytes/s per card, one direction of NVLink 4


def collective_bytes(stats) -> Dict[str, int]:
    """Collective operand bytes per kind, their total and count."""
    out = {k: int(v) for k, v in stats.coll_by_kind.items()}
    out["total"] = int(stats.coll_bytes)
    out["count"] = stats.n_collectives
    return out


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-rank FLOPs
    hbm_bytes: float             # per-rank device-memory bytes
    coll_bytes: float            # per-rank collective operand bytes
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(stats, chips: int,
                   model_flops: Optional[float] = None) -> Roofline:
    """Terms from one rank's :class:`~repro_torch.analysis.op_stats.OpStats`.
    ``model_flops`` is the global 6ND-style count; useful_ratio =
    model_flops / (flops * chips)."""
    compute_s = stats.flops / PEAK_FLOPS
    memory_s = stats.hbm_bytes / HBM_BW
    collective_s = stats.coll_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = (model_flops / (stats.flops * chips)
              if model_flops and stats.flops else None)
    return Roofline(stats.flops, stats.hbm_bytes, stats.coll_bytes, chips,
                    compute_s, memory_s, collective_s, dominant, model_flops,
                    useful)


# ------------------------------------------------------- MODEL_FLOPS (6ND)
def model_flops(cfg, shape_kind: str, batch: int, seq: int,
                params_total: int, params_active: int) -> float:
    """6*N*D for train, 2*N*D per generated token for decode/prefill-style
    forward (D = tokens processed)."""
    n = params_active
    tokens = batch * (1 if shape_kind == "decode" else seq)
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n * tokens


def count_params(struct_tree) -> int:
    """Elements of a tree of tensors (meta tensors included)."""
    return int(sum(t.numel() for t in leaves(struct_tree)))


def active_params(cfg, total: int) -> int:
    """MoE: discount inactive experts (top_k of n_experts active)."""
    if not cfg.n_experts:
        return total
    moe_layers = sum((s.unit.count("moe") + s.unit.count("mla_moe"))
                     * s.repeats for s in cfg.stages)
    per_expert = 3 * cfg.d_model * cfg.expert_d_ff
    inactive = moe_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total - int(inactive)
