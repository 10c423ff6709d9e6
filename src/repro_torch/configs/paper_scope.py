"""SCOPe pipeline defaults — the paper's own experimental configuration
(§VII): Azure cost table, 5.5-month window, no-archive tier set, the
Tables IX-XI variant grid, and the TPC-H capacity ratios of Table XII.

A copy of ``repro.configs.paper_scope``; its configurations run on
``device`` (default ``"cuda"``)."""

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.costs import azure_table
from repro_torch.core.scope import ScopeConfig, paper_variants

COST_TABLE = azure_table()
EVAL_MONTHS = 5.5
TIERS_NO_ARCHIVE = (0, 1, 2)


def default_config(device: str = "cuda") -> ScopeConfig:
    return ScopeConfig(tier_whitelist=TIERS_NO_ARCHIVE, months=EVAL_MONTHS,
                       device=device)


def variant_grid(total_gb: float,
                 device: str = "cuda") -> Dict[str, ScopeConfig]:
    """The 11 policy rows of Tables IX-XI for a dataset of ``total_gb``."""
    cap = np.array([0.163, 0.326, 0.4891, np.inf]) * total_gb * 3.0
    return {name: dataclasses.replace(cfg, device=device)
            for name, cfg in paper_variants(cap).items()}
