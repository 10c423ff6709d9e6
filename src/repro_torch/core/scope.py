"""SCOPe — one-shot entry point and the paper's variant grid (paper §VII).

Port of ``repro.core.scope``:

 * ``MigrationPlan`` — re-exported from the engine, as the reference
   does, for :meth:`PlacementEngine.reoptimize`'s result;
 * ``run_pipeline`` — one-shot batch optimization through
   :class:`~repro_torch.core.engine.PlacementEngine`, returning its
   :class:`PipelineReport`;
 * ``paper_variants`` — the P/T/C ablation grid of Tables IX–XI (Ares =
   C only, Hermes = T only, HCompress = latency-focused T+C, '+ G-PART'
   rows = same with P on), with weights selecting the 'latency focused' /
   'read+decomp focused' / 'total cost focused' SCOPe variants and
   ``capacity`` switching greedy (Thm 3) vs capacitated solving.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import datapart
from repro_torch.core.costs import CostTable, Weights
from repro_torch.core.engine import (MigrationPlan, PipelineReport,
                                     PlacementEngine, PlacementPlan,
                                     PlacementProblem, ScopeConfig)
from repro_torch.data.tables import Table

__all__ = [
    "MigrationPlan", "PipelineReport", "PlacementEngine", "PlacementPlan", "PlacementProblem",
    "ScopeConfig", "paper_variants", "run_pipeline",
]


def run_pipeline(
    parts: List[datapart.Partition],
    file_rows: Dict[str, Tuple[Table, np.ndarray]],
    table: CostTable,
    cfg: ScopeConfig,
) -> PipelineReport:
    """One-shot entry point: build + solve + bill via the engine, on
    ``cfg.device``."""
    return PlacementEngine(table, cfg).run(parts, file_rows).report


# ------------------------------------------------------- paper table variants
def paper_variants(capacity_gb: np.ndarray) -> Dict[str, ScopeConfig]:
    """The 11 rows of Tables IX–XI, keyed by the paper's row names."""
    no_cap = None
    no_archive = (0, 1, 2)
    return {
        "Default (store on premium)": ScopeConfig(
            use_partitioning=False, use_tiering=False, use_compression=False,
            fixed_tier=0, tier_whitelist=no_archive),
        "Compress & store on premium [Ares]": ScopeConfig(
            use_partitioning=False, use_tiering=False, use_compression=True,
            fixed_tier=0, tier_whitelist=no_archive),
        "Multi-Tiering [Hermes]": ScopeConfig(
            use_partitioning=False, use_tiering=True, use_compression=False,
            capacity_gb=capacity_gb, tier_whitelist=no_archive),
        "Latency time focused [HCompress]": ScopeConfig(
            use_partitioning=False, use_tiering=True, use_compression=True,
            weights=Weights(alpha=0.0, beta=1.0), capacity_gb=capacity_gb,
            tier_whitelist=no_archive),
        "Partition & store on premium": ScopeConfig(
            use_partitioning=True, use_tiering=False, use_compression=False,
            fixed_tier=0, tier_whitelist=no_archive),
        "Partitioning + Tiering [Hermes + G-PART]": ScopeConfig(
            use_partitioning=True, use_tiering=True, use_compression=False,
            capacity_gb=capacity_gb, tier_whitelist=no_archive),
        "Partitioning + Compression [Ares + G-PART]": ScopeConfig(
            use_partitioning=True, use_tiering=False, use_compression=True,
            fixed_tier=0, tier_whitelist=no_archive),
        "SCOPe (Latency time focused)": ScopeConfig(
            weights=Weights(alpha=0.0, beta=1.0), capacity_gb=capacity_gb,
            tier_whitelist=no_archive),
        "SCOPe (No capacity constraint)": ScopeConfig(
            capacity_gb=no_cap, tier_whitelist=no_archive),
        "SCOPe (Read+Decomp. cost focused)": ScopeConfig(
            weights=Weights(alpha=0.05, beta=1.0), capacity_gb=capacity_gb,
            tier_whitelist=no_archive),
        "SCOPe (Total cost focused)": ScopeConfig(
            capacity_gb=capacity_gb, tier_whitelist=no_archive),
    }
