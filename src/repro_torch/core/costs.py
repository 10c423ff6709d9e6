"""Cloud storage cost model — parameters and cost algebra from the paper.

A copy of the single-cloud part of ``repro.core.costs`` that the batch
placement path uses. All monetary quantities are in **cents**. Sizes are
in **GB**. Times in seconds. Defaults reproduce Table I / Table XII (Azure
ADLS Gen2) of *Towards Optimizing Storage Costs on the Cloud* (2023).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Tier indices follow the paper's convention: 0 = lowest latency (Premium),
# L-1 = archival (highest latency).
TIER_NAMES = ("premium", "hot", "cool", "archive")


@dataclasses.dataclass(frozen=True)
class CostTable:
    """Per-tier cost/latency parameters (vectors of length L).

    Attributes
    ----------
    storage_cents_gb_month : C^s_l — storage cost, cents per GB per month.
    read_cents_gb          : C^r_l — read (egress+ops) cost, cents per GB.
    write_cents_gb         : C^w_l — write cost, cents per GB (= Delta_{-1,l}).
    ttfb_seconds           : B_l   — read latency (time to first byte), seconds.
    capacity_gb            : S_l   — reserved capacity (np.inf = unbounded).
    early_delete_months    : minimum residency before a free move-out.
    compute_cents_sec      : C^c   — compute cost, cents per second (scalar).
    """

    storage_cents_gb_month: np.ndarray
    read_cents_gb: np.ndarray
    write_cents_gb: np.ndarray
    ttfb_seconds: np.ndarray
    capacity_gb: np.ndarray
    early_delete_months: np.ndarray
    compute_cents_sec: float = 0.001
    names: Sequence[str] = TIER_NAMES

    @property
    def num_tiers(self) -> int:
        return int(self.storage_cents_gb_month.shape[0])

    def tier_change_cents_gb(self) -> np.ndarray:
        """Delta_{u,v} per GB: read from u + write to v. Shape (L+1, L).

        Row index L(P)=-1 (new data) is stored last: Delta[-1, v] = write-only.
        Diagonal (u == v) is zero — staying put is free.
        """
        L = self.num_tiers
        delta = self.read_cents_gb[:, None] + self.write_cents_gb[None, :]
        delta = delta * (1.0 - np.eye(L))
        new_row = self.write_cents_gb[None, :]  # ingestion: write cost only
        return np.concatenate([delta, new_row], axis=0)


def azure_table() -> CostTable:
    """Azure ADLS Gen2 parameters (paper Tables I & XII); write costs are
    derived from Azure's write-ops pricing at 4 MB per op."""
    return CostTable(
        storage_cents_gb_month=np.array([15.0, 2.08, 1.52, 0.099]),
        read_cents_gb=np.array([0.004659, 0.01331, 0.0333, 16.64]),
        write_cents_gb=np.array([0.00923, 0.0333, 0.0666, 0.0666]),
        ttfb_seconds=np.array([0.0053, 0.0614, 0.0614, 3600.0]),
        capacity_gb=np.array([np.inf, np.inf, np.inf, np.inf]),
        early_delete_months=np.array([0.0, 0.0, 1.0, 6.0]),
        compute_cents_sec=0.001,
    )


@dataclasses.dataclass(frozen=True)
class Weights:
    """Objective hyper-parameters (paper §IV-A): alpha weights storage,
    beta weights access (read + decompression-compute), gamma weights
    tier-change cost."""

    alpha: float = 1.0
    beta: float = 1.0
    gamma: float = 1.0


def cost_tensor(
    spans_gb: np.ndarray,          # (N,)  Sp(P_n)
    accesses: np.ndarray,          # (N,)  rho(P_n) — projected # of reads
    current_tier: np.ndarray,      # (N,)  L(P_n) in {-1, 0..L-1}
    ratios: np.ndarray,            # (N,K) R_n^k   — compression ratios (>=1)
    decomp_sec: np.ndarray,        # (N,K) D_n^k   — decompression seconds (whole partition)
    table: CostTable,
    weights: Weights = Weights(),
    months: float = 1.0,
    pushdown_fraction: float = 0.0,
) -> np.ndarray:
    """Full OPTASSIGN objective tensor, shape (N, L, K).

    cost[n,l,k] = (alpha*C^s_l*months + gamma*Delta_{L(n),l}) * Sp_n / R_nk
                + beta * (1-f) * rho_n * (C^c * D_nk + C^r_l * Sp_n / R_nk)

    ``pushdown_fraction`` is the paper's `f`: queries answerable directly on
    compressed data contribute neither read nor decompression cost.
    """
    delta = table.tier_change_cents_gb()          # (L+1, L)
    move = delta[current_tier.astype(int)]        # (N, L) — cents/GB
    stored_gb = spans_gb[:, None] / ratios        # (N, K)
    eff_rho = (1.0 - pushdown_fraction) * accesses

    hold = (weights.alpha * table.storage_cents_gb_month[None, :] * months
            + weights.gamma * move)               # (N, L)
    storage_cost = hold[:, :, None] * stored_gb[:, None, :]          # (N,L,K)
    read_cost = (table.read_cents_gb[None, :, None]
                 * stored_gb[:, None, :])                             # (N,L,K)
    decomp_cost = (table.compute_cents_sec * decomp_sec)[:, None, :]  # (N,1,K)->(N,L,K)
    access_cost = weights.beta * eff_rho[:, None, None] * (decomp_cost + read_cost)
    return storage_cost + access_cost


def sla_penalty_tensor(
    accesses: np.ndarray,          # (N,)  rho — projected # of reads
    sla_ms: np.ndarray,            # (N,)  per-partition target (inf = none)
    decomp_sec: np.ndarray,        # (N,K) whole-partition decompression
    table: CostTable,
) -> np.ndarray:
    """Soft-SLA violation penalty tensor, shape (N, L, K).

    penalty[n,l,k] = rho_n * max(0, B_l*1e3 + D_nk*1e3 - sla_ms_n)

    Units are **rho-weighted excess milliseconds**, not cents. Rows with
    ``sla_ms = inf`` contribute exactly 0.0.
    """
    lat_ms = (table.ttfb_seconds[None, :, None]
              + decomp_sec[:, None, :]) * 1e3              # (N,L,K)
    sla = np.asarray(sla_ms, np.float64)[:, None, None]
    # inf - inf would NaN; an infinite SLA means "no target" -> zero excess
    excess = np.where(np.isfinite(sla), np.maximum(lat_ms - sla, 0.0), 0.0)
    return np.asarray(accesses, np.float64)[:, None, None] * excess


def latency_feasible(
    decomp_sec: np.ndarray,       # (N,K)
    latency_threshold: np.ndarray,  # (N,)
    table: CostTable,
) -> np.ndarray:
    """Latency constraint mask, shape (N, L, K): D_nk + B_l <= T_n."""
    total = decomp_sec[:, None, :] + table.ttfb_seconds[None, :, None]
    return total <= latency_threshold[:, None, None]
