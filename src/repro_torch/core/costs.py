"""Cloud storage cost model — parameters and cost algebra from the paper.

A copy of ``repro.core.costs``: the single-cloud :class:`CostTable`, the
flattened multi-cloud ``(provider, tier)`` space with its provider presets,
and the cost algebra. All host numpy. All monetary quantities are in
**cents**. Sizes are in **GB**. Times in seconds. Defaults reproduce Table
I / Table XII (Azure ADLS Gen2) of *Towards Optimizing Storage Costs on the
Cloud* (2023).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

# Tier indices follow the paper's convention: 0 = lowest latency (Premium),
# L-1 = archival (highest latency).
PREMIUM, HOT, COOL, ARCHIVE = 0, 1, 2, 3
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

    @property
    def retrieval_latency_ms(self) -> np.ndarray:
        """Per-tier retrieval latency in milliseconds, shape (L,): the
        ``ttfb_seconds`` model in SLA units."""
        return self.ttfb_seconds * 1e3

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

    def with_capacity(self, capacity_gb: Sequence[float]) -> "CostTable":
        return dataclasses.replace(self, capacity_gb=np.asarray(capacity_gb, np.float64))


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


def tpch_capacity_table(total_gb: float) -> CostTable:
    """Capacity-constrained variant used for TPC-H experiments (Table XII):
    Premium/Hot/Cool capacities in ratio 0.163 : 0.326 : 0.4891, Archive inf."""
    t = azure_table()
    frac = np.array([0.163, 0.326, 0.4891, np.inf])
    return t.with_capacity(frac * total_gb if np.isfinite(total_gb) else frac)


# ------------------------------------------------------------- multi-cloud
@dataclasses.dataclass(frozen=True)
class ProviderCostTable:
    """One provider's tier lattice plus its outbound data-transfer rate.

    ``egress_out_cents_gb`` is the provider's internet/cross-cloud egress
    price — what the *source* provider bills when bytes leave it for another
    cloud. ``capacity_gb`` caps the provider's total footprint across all of
    its tiers (np.inf = unbounded); it becomes a group constraint row in the
    capacitated solver.

    ``region`` models one provider deployed in several regions: build one
    ``ProviderCostTable`` per region with the SAME ``provider`` name and
    distinct regions. Moves between two regions of one provider then
    default to the *reduced* intra-provider rate
    ``region_egress_out_cents_gb`` (inter-region transfer is far cheaper
    than internet egress) instead of the full cross-cloud rate; moves
    within one region stay free. With ``region=None`` (the default)
    nothing changes — single-region tables are bit-identical to before.
    """

    provider: str
    table: CostTable
    egress_out_cents_gb: float = 0.0
    capacity_gb: float = np.inf
    region: Optional[str] = None
    region_egress_out_cents_gb: float = 0.0


@dataclasses.dataclass(frozen=True)
class MultiCloudCostTable(CostTable):
    """A flattened ``(provider, tier)`` placement space.

    Concatenates P providers' tier vectors into one ``CostTable`` with
    ``L = sum(L_p)`` flat tiers, so every consumer of the single-cloud model
    (cost tensor, solvers, billing, store) works unchanged. The one semantic
    extension is :meth:`tier_change_cents_gb`: moves whose source and
    destination flat tiers belong to different providers additionally pay the
    source provider's egress — the **off-diagonal blocks** of the Delta
    matrix. With one provider and zero egress this class is bit-for-bit
    equivalent to its underlying :class:`CostTable`.

    Build instances with :func:`multi_cloud_table`, not directly.
    """

    provider_names: Tuple[str, ...] = ()
    provider_of_tier: Optional[np.ndarray] = None    # (L,) int
    egress_cents_gb: Optional[np.ndarray] = None     # (P,P), zero diagonal
    provider_capacity_gb: Optional[np.ndarray] = None  # (P,)
    provider_regions: Optional[Tuple] = None         # (P,) region or None

    @property
    def num_providers(self) -> int:
        return len(self.provider_names)

    def provider_tiers(self, p: int) -> np.ndarray:
        """Flat tier indices belonging to provider ``p``."""
        return np.where(self.provider_of_tier == p)[0]

    def tier_change_cents_gb(self) -> np.ndarray:
        """Block-structured Delta: within-provider blocks are read+write as in
        the base class; cross-provider blocks add ``egress[p(u), p(v)]``.
        The ingestion row (new data, L(P) = -1) never pays egress."""
        delta = super().tier_change_cents_gb()        # (L+1, L)
        L = self.num_tiers
        p = self.provider_of_tier
        delta[:L] += self.egress_cents_gb[p[:, None], p[None, :]]
        return delta


def multi_cloud_table(providers: Sequence[ProviderCostTable],
                      egress_cents_gb: Optional[np.ndarray] = None,
                      ) -> MultiCloudCostTable:
    """Flatten provider tier lattices into one ``(provider, tier)`` space.

    ``egress_cents_gb`` overrides the (P,P) egress matrix; by default row i
    is ``providers[i].egress_out_cents_gb`` everywhere off the diagonal
    (cross-cloud transfer is billed by the source as internet egress),
    except between two entries that carry the SAME provider name and
    distinct (non-None) ``region`` fields — those intra-provider
    cross-region lanes price the source's reduced
    ``region_egress_out_cents_gb`` instead. The diagonal is always forced
    to zero — moving within one (provider, region) pays no egress.
    ``compute_cents_sec`` is taken from the first provider (the paper's
    C^c is a property of where decompression runs, not of storage).
    """
    if not providers:
        raise ValueError("need at least one provider")
    P = len(providers)
    if egress_cents_gb is None:
        out = np.array([p.egress_out_cents_gb for p in providers])
        egress = np.repeat(out[:, None], P, axis=1)
        for i, pi in enumerate(providers):
            for j, pj in enumerate(providers):
                if (i != j and pi.provider == pj.provider
                        and pi.region is not None and pj.region is not None):
                    egress[i, j] = (pi.region_egress_out_cents_gb
                                    if pi.region != pj.region else 0.0)
    else:
        egress = np.array(egress_cents_gb, np.float64, copy=True)
        if egress.shape != (P, P):
            raise ValueError(f"egress matrix must be ({P},{P}), "
                             f"got {egress.shape}")
    np.fill_diagonal(egress, 0.0)
    tabs = [p.table for p in providers]
    cat = lambda attr: np.concatenate([getattr(t, attr) for t in tabs])
    return MultiCloudCostTable(
        storage_cents_gb_month=cat("storage_cents_gb_month"),
        read_cents_gb=cat("read_cents_gb"),
        write_cents_gb=cat("write_cents_gb"),
        ttfb_seconds=cat("ttfb_seconds"),
        capacity_gb=cat("capacity_gb"),
        early_delete_months=cat("early_delete_months"),
        compute_cents_sec=tabs[0].compute_cents_sec,
        names=tuple((f"{p.provider}@{p.region}:{n}" if p.region is not None
                     else f"{p.provider}:{n}") for p in providers
                    for n in p.table.names),
        provider_names=tuple(p.provider for p in providers),
        provider_of_tier=np.concatenate(
            [np.full(t.num_tiers, i) for i, t in enumerate(tabs)]),
        egress_cents_gb=egress,
        provider_capacity_gb=np.array([p.capacity_gb for p in providers],
                                      np.float64),
        provider_regions=tuple(p.region for p in providers),
    )


def aws_s3_provider(capacity_gb: float = np.inf) -> ProviderCostTable:
    """AWS S3, us-east-1 list prices (2024), normalized like the paper's
    Table XII: request charges amortized per GB at 4 MB-per-op granularity,
    retrieval fees folded into ``read_cents_gb``. Tiers: Standard /
    Standard-IA / Glacier Instant Retrieval / Glacier Deep Archive."""
    return ProviderCostTable(
        provider="aws",
        table=CostTable(
            storage_cents_gb_month=np.array([2.3, 1.25, 0.4, 0.099]),
            read_cents_gb=np.array([0.0103, 1.0, 3.0, 2.0]),
            write_cents_gb=np.array([0.0128, 0.0256, 0.0512, 0.128]),
            ttfb_seconds=np.array([0.02, 0.02, 0.05, 43200.0]),
            capacity_gb=np.array([np.inf] * 4),
            early_delete_months=np.array([0.0, 1.0, 3.0, 6.0]),
            names=("standard", "standard_ia", "glacier_ir", "deep_archive"),
        ),
        egress_out_cents_gb=9.0,
        capacity_gb=capacity_gb,
    )


def gcp_gcs_provider(capacity_gb: float = np.inf) -> ProviderCostTable:
    """GCP Cloud Storage, regional us-central1 list prices (2024), same
    normalization. All four GCS classes are online (millisecond TTFB) —
    archival is priced, not slow. Tiers: Standard / Nearline / Coldline /
    Archive."""
    return ProviderCostTable(
        provider="gcp",
        table=CostTable(
            storage_cents_gb_month=np.array([2.0, 1.0, 0.4, 0.12]),
            read_cents_gb=np.array([0.0102, 1.0256, 2.0512, 5.128]),
            write_cents_gb=np.array([0.0128, 0.0256, 0.0256, 0.128]),
            ttfb_seconds=np.array([0.02, 0.02, 0.02, 0.05]),
            capacity_gb=np.array([np.inf] * 4),
            early_delete_months=np.array([0.0, 1.0, 3.0, 12.0]),
            names=("standard", "nearline", "coldline", "archive"),
        ),
        egress_out_cents_gb=12.0,
        capacity_gb=capacity_gb,
    )


def azure_blob_provider(capacity_gb: float = np.inf) -> ProviderCostTable:
    """Azure Blob Storage, East US LRS flat-namespace list prices (2024),
    same normalization. Distinct from :func:`azure_table`, which reproduces
    the paper's ADLS Gen2 Tables I & XII. Tiers: Hot / Cool / Cold /
    Archive (Archive TTFB is the documented up-to-15 h rehydration)."""
    return ProviderCostTable(
        provider="azure",
        table=CostTable(
            storage_cents_gb_month=np.array([1.84, 1.0, 0.36, 0.099]),
            read_cents_gb=np.array([0.0111, 1.0256, 3.0768, 2.7184]),
            write_cents_gb=np.array([0.0163, 0.0325, 0.0585, 0.0666]),
            ttfb_seconds=np.array([0.02, 0.02, 0.02, 54000.0]),
            capacity_gb=np.array([np.inf] * 4),
            early_delete_months=np.array([0.0, 1.0, 3.0, 6.0]),
            names=("hot", "cool", "cold", "archive"),
        ),
        egress_out_cents_gb=8.7,
        capacity_gb=capacity_gb,
    )


def big3_table(aws_capacity_gb: float = np.inf,
               gcp_capacity_gb: float = np.inf,
               azure_capacity_gb: float = np.inf) -> MultiCloudCostTable:
    """AWS + GCP + Azure flattened into one 12-tier placement space."""
    return multi_cloud_table([aws_s3_provider(aws_capacity_gb),
                              gcp_gcs_provider(gcp_capacity_gb),
                              azure_blob_provider(azure_capacity_gb)])


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


def early_delete_penalty_gb(
    table: CostTable,
    current_tier: np.ndarray,      # (N,) in {-1, 0..L-1}; -1 = new data
    months_held: "float | np.ndarray" = 0.0,
) -> np.ndarray:
    """Per-GB charge if a partition leaves ``current_tier`` now, shape (N,).

    The prorated remainder of the tier's minimum-stay storage charge —
    mirrors ``TieredStore.change_tier`` / ``delete`` semantics. Zero for new
    data (tier -1) and for tiers without a minimum stay.
    """
    cur = np.asarray(current_tier, int)
    held = np.broadcast_to(np.asarray(months_held, np.float64), cur.shape)
    safe = np.maximum(cur, 0)
    due = np.maximum(0.0, table.early_delete_months[safe] - held)
    return np.where(cur >= 0, due * table.storage_cents_gb_month[safe], 0.0)


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


def move_egress_cents_gb(table: CostTable,
                         from_tier: "int | np.ndarray",
                         to_tier: "int | np.ndarray") -> np.ndarray:
    """Per-GB cross-provider egress for a tier move (broadcasts).

    Zero for plain single-cloud tables, for new data (``from_tier == -1``),
    and for moves within one provider.
    """
    f = np.asarray(from_tier, int)
    t = np.asarray(to_tier, int)
    p = getattr(table, "provider_of_tier", None)
    if p is None:
        return np.zeros(np.broadcast(f, t).shape)
    safe_f, safe_t = np.maximum(f, 0), np.maximum(t, 0)
    eg = table.egress_cents_gb[p[safe_f], p[safe_t]]
    return np.where((f >= 0) & (t >= 0), eg, 0.0)
