"""PlacementEngine — the SCOPe pipeline (paper §VII) as composable stages.

Port of ``repro.core.engine``'s batch path and online re-optimization.
Four stages exchange typed payloads::

    PartitionStage   (parts, file_rows)      -> PartitionedData
    CompressStage    PartitionedData         -> PlacementProblem
    AssignStage      PlacementProblem        -> Assignment
    BillingStage     (problem, assignment)   -> PipelineReport

:meth:`PlacementEngine.reoptimize` takes an existing :class:`PlacementPlan`
plus drifted access rates and returns a :class:`MigrationPlan` whose
objective internalizes tier-change transfer, cross-provider egress and
early-deletion penalties; :meth:`PlacementEngine.plan_replicas` places
read-locality copies of hot partitions.

``ScopeConfig.device`` (default ``"cuda"``) is where the device parts run:
G-PART's overlap matrix (``partition_backend="device"``), COMPREDICT's
batched features (``feature_backend="device"``) and the solvers' argmin and
dual ascent. Asking for the card where there is none raises.
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, FrozenSet, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core import datapart
from repro_torch.core.cache import (CacheConfig, cache_access_adjustment,
                                    cache_cents, forecast_admission,
                                    served_latency_terms, weighted_p99_ms)
from repro_torch.core.costs import (CostTable, Weights, cost_tensor,
                                    early_delete_penalty_gb,
                                    latency_feasible, move_egress_cents_gb,
                                    sla_penalty_tensor)
from repro_torch.core.optassign import (Assignment, capacitated_assign,
                                        greedy_assign, lock_schemes)
from repro_torch.data.tables import Table
from repro_torch.device import resolve
from repro_torch.storage.codecs import available_schemes, codec_by_name, measure


@dataclasses.dataclass
class ScopeConfig:
    use_partitioning: bool = True
    use_tiering: bool = True
    use_compression: bool = True
    weights: Weights = dataclasses.field(default_factory=Weights)
    months: float = 5.5                      # paper's evaluation window
    schemes: Sequence[str] = dataclasses.field(default_factory=available_schemes)
    layout: str = "col"
    capacity_gb: Optional[np.ndarray] = None  # None = unbounded (greedy path)
    latency_sla_sec: float = np.inf
    tier_whitelist: Optional[Sequence[int]] = None  # e.g. (0,1,2) = no archive
    provider_whitelist: Optional[Sequence[str]] = None  # multi-cloud tables:
    # restrict placement to these providers' flat tiers (None = all)
    s_thresh_mult: float = 3.0               # G-PART span cap, x median family span
    rho_c: float = 4.0
    rho_c_abs: float = 10.0
    # G-PART candidate-graph backend: 'numpy' (exact inverted-index join),
    # 'device' (overlap-matrix kernel on `device`), or 'ref' (pair loop)
    partition_backend: str = "numpy"
    partition_sample: Optional[float] = None  # MinHash-style code sampling
    # rate for the candidate graph (None = exact)
    predictor: str = "truth"                 # 'truth' | fitted CompressionPredictor
    feature_backend: str = "numpy"           # 'numpy' | 'device'
    fixed_tier: Optional[int] = None         # e.g. 0 -> 'store on premium'
    # ---- serving SLA (soft constraints) ---------------------------------
    sla_lambda: float = 0.0                  # objective = cost + lambda*penalty
    sla_ms: float = np.inf                   # default per-partition SLA target
    # (per-partition overrides via PlacementProblem.sla_ms; inf = no target)
    cache: Optional[CacheConfig] = None      # optional serving cache tier
    replicas: int = 1                        # copies for hot partitions
    replica_rho_min: float = np.inf          # replicate when rho >= this
    device: str = "cuda"                     # 'cuda' | 'cpu'; no fallback


@dataclasses.dataclass
class PipelineReport:
    storage_cents: float
    decomp_cents: float
    read_cents: float
    total_cents: float
    read_latency_ttfb: float          # access-weighted mean TTFB (s)
    decomp_latency_ms: float          # access-weighted mean decompression (ms)
    tiering_scheme: List[int]         # partitions per tier
    n_partitions: int
    assignment: Assignment
    spans_gb: np.ndarray
    rho: np.ndarray
    schemes: Sequence[str]
    provider_scheme: Optional[List[int]] = None  # partitions per provider
    # (multi-cloud tables only; None for single-cloud)
    # ---- serving metrics (SLA/cache; zero when the features are off) ----
    sla_penalty: float = 0.0          # rho-weighted excess ms — NOT cents,
    # never metered by BillingMeter; lambda-weighted only inside the solver
    p99_latency_ms: float = 0.0       # access-weighted p99 serving latency
    cache_cents: float = 0.0          # cache storage + fill spend (real cents,
    # included in total_cents when a cache tier is configured)
    n_cached: int = 0                 # partitions admitted to the cache


@dataclasses.dataclass
class PartitionedData:
    """Output of :class:`PartitionStage`."""

    partitions: List[datapart.Partition]
    tables: List[Table]
    raw_bytes: List[bytes]
    spans_gb: np.ndarray              # (N,)
    rho: np.ndarray                   # (N,)


@dataclasses.dataclass
class PlacementProblem:
    """Everything :class:`AssignStage` needs — the typed stage boundary."""

    spans_gb: np.ndarray              # (N,)  raw partition sizes
    rho: np.ndarray                   # (N,)  projected access counts
    current_tier: np.ndarray          # (N,)  -1 = new data (ingestion)
    R: np.ndarray                     # (N,K) compression ratios (>= 1)
    D: np.ndarray                     # (N,K) decompression seconds, whole part
    schemes: Sequence[str]
    table: CostTable
    cfg: ScopeConfig
    partitions: Optional[List[datapart.Partition]] = None
    raw_bytes: Optional[List[bytes]] = None
    sla_ms: Optional[np.ndarray] = None  # (N,) per-partition SLA targets;
    # None -> broadcast cfg.sla_ms (inf = no target, zero penalty)

    @property
    def n(self) -> int:
        return int(self.spans_gb.shape[0])

    def effective_sla_ms(self) -> np.ndarray:
        """(N,) SLA targets: the per-partition override or the config
        default broadcast. ``inf`` rows contribute exactly zero penalty."""
        if self.sla_ms is not None:
            sla = np.asarray(self.sla_ms, np.float64)
            if sla.shape != (self.n,):
                raise ValueError(f"sla_ms must have shape ({self.n},), "
                                 f"got {sla.shape}")
            return sla
        return np.full(self.n, float(self.cfg.sla_ms))

    def stored_matrix(self) -> np.ndarray:
        """(N,L,K) GB occupied if cell (l,k) is chosen (tier-independent)."""
        L = self.table.num_tiers
        return np.repeat((self.spans_gb[:, None] / self.R)[:, None, :], L, 1)


@dataclasses.dataclass
class PlacementPlan:
    problem: PlacementProblem
    assignment: Assignment
    report: PipelineReport

    @property
    def stored_gb(self) -> np.ndarray:
        """(N,) GB actually occupied under the chosen schemes."""
        n = np.arange(self.problem.n)
        return self.problem.spans_gb / self.problem.R[n, self.assignment.scheme]


def drift_gate(rho: np.ndarray, rho_ref: np.ndarray, rho_rel_tol: float,
               rho_abs_tol: float = 0.0) -> np.ndarray:
    """Boolean drift mask shared by ``reoptimize``, the streaming engine,
    and the daemon's hysteresis.

    A partition counts as drifted only when ``|rho - rho_ref|`` exceeds
    **both** the relative band (``rho_rel_tol`` of the lock-base rate) and
    the absolute floor ``rho_abs_tol``. The floor is what keeps the scheme
    lock stable for cold data: with ``rho_ref == 0`` the relative band
    collapses to ~0, so without a floor a single epsilon access would
    unlock (and churn) every cold partition.
    """
    thr = np.maximum(rho_rel_tol * np.maximum(rho_ref, 1e-12), rho_abs_tol)
    return np.abs(rho - rho_ref) > thr


@dataclasses.dataclass
class MigrationPlan:
    """Incremental move set produced by :meth:`PlacementEngine.reoptimize`.

    The solver proposes a set of **candidate** moves; by default all of
    them are **selected** (``moved == candidate``). Under a migration
    budget, :meth:`select` keeps a subset and reverts the rest — the
    daemon defers them to a later cycle. Per-move cents arrays carry the
    one-off charge break-up so partial plans meter exactly.
    """

    plan: PlacementPlan               # re-optimized placement (new rho)
    moved: np.ndarray                 # (N,) bool — selected moves
    old_tier: np.ndarray
    new_tier: np.ndarray
    old_scheme: np.ndarray
    new_scheme: np.ndarray
    migration_cents: float            # read-out + egress + write-in transfer
    penalty_cents: float              # early-deletion charges
    egress_cents: float = 0.0         # cross-provider egress component of
    # migration_cents (already included there; broken out for visibility)
    candidate: Optional[np.ndarray] = None   # (N,) bool — proposed moves
    move_transfer_cents: Optional[np.ndarray] = None  # (N,) read+write, no egress
    move_egress_cents: Optional[np.ndarray] = None    # (N,)
    move_penalty_cents: Optional[np.ndarray] = None   # (N,)
    old_stored_gb: Optional[np.ndarray] = None        # (N,) bytes at old cell

    def __post_init__(self):
        if self.candidate is None:
            self.candidate = self.moved.copy()
        z = lambda: np.zeros(self.moved.shape[0])
        if self.move_transfer_cents is None:
            self.move_transfer_cents = z()
        if self.move_egress_cents is None:
            self.move_egress_cents = z()
        if self.move_penalty_cents is None:
            self.move_penalty_cents = z()
        if self.old_stored_gb is None:
            self.old_stored_gb = z()

    @property
    def n_moved(self) -> int:
        return int(self.moved.sum())

    @property
    def n_candidates(self) -> int:
        return int(self.candidate.sum())

    @property
    def deferred(self) -> np.ndarray:
        """(N,) bool — candidate moves not selected this cycle."""
        return self.candidate & ~self.moved

    @property
    def total_move_cents(self) -> float:
        return self.migration_cents + self.penalty_cents

    def steady_savings_cents(self, months: Optional[float] = None,
                             ) -> np.ndarray:
        """(N,) steady-state savings each candidate move yields over
        ``months`` (default: the plan's ``cfg.months`` horizon) — old cell
        minus new cell under the plan's access rates. The daemon's knapsack
        numerator.

        With a serving SLA configured (``cfg.sla_lambda > 0``) the savings
        additionally include the lambda-weighted latency-penalty relief of
        the move, so SLA-violation moves compete in the same
        savings-per-cent knapsack as pure cost moves. The relief is an
        *objective* quantity (lambda * excess-ms), not cents — what gets
        **spent** on a move (``move_transfer/egress/penalty_cents``) stays
        pure cents either way. With a cache tier, admitted partitions'
        backing traffic is their miss traffic only.
        """
        p = self.plan.problem
        t = p.table
        cfg = p.cfg
        m = cfg.months if months is None else float(months)
        n = np.arange(p.n)
        old_l = np.maximum(self.old_tier, 0)
        old_k = np.maximum(self.old_scheme, 0)
        new_l, new_k = self.new_tier.astype(int), self.new_scheme.astype(int)

        rho_eff = p.rho
        if cfg.cache is not None:
            cached = forecast_admission(p.rho, p.spans_gb, cfg.cache)
            rho_eff = np.where(cached, cfg.cache.miss_rate * p.rho, p.rho)

        def cell(stored, l, k):
            return (stored * t.storage_cents_gb_month[l] * m
                    + rho_eff * (stored * t.read_cents_gb[l]
                                 + p.D[n, k] * t.compute_cents_sec))

        new_stored = p.spans_gb / p.R[n, new_k]
        sav = cell(self.old_stored_gb, old_l, old_k) \
            - cell(new_stored, new_l, new_k)
        if cfg.sla_lambda > 0:
            sla = p.effective_sla_ms()
            if bool(np.isfinite(sla).any()):
                def excess(l, k):
                    lat = (t.ttfb_seconds[l] + p.D[n, k]) * 1e3
                    return np.where(np.isfinite(sla),
                                    np.maximum(lat - sla, 0.0), 0.0)
                sav = sav + cfg.sla_lambda * rho_eff * (
                    excess(old_l, old_k) - excess(new_l, new_k))
        return np.where(self.candidate, sav, 0.0)

    def select(self, keep: np.ndarray) -> "MigrationPlan":
        """Partial plan executing only ``candidate & keep``.

        The returned plan shares no mutable array with ``self``: its
        masks and its assignment are new arrays, and the per-move cents
        arrays are copied. Deferred partitions revert to their old tier and scheme in the
        returned plan's assignment (so ``TieredStore.migrate``/``sync_plan``
        leave them untouched and the steady-state report prices the state
        actually reached); aggregate cents re-sum the selected moves only.
        When every candidate is kept, returns ``self`` unchanged — the
        unbudgeted path stays bit-identical.
        """
        sel = self.candidate & np.asarray(keep, bool)
        if bool((sel == self.candidate).all()):
            return self
        defer = self.candidate & ~sel
        tier = np.where(defer, self.old_tier, self.new_tier).astype(int)
        scheme = np.where(defer, self.old_scheme, self.new_scheme).astype(int)
        problem = self.plan.problem
        # the migration objective (one-off terms included) is not
        # reconstructible here, so the partial assignment carries no cost
        assignment = dataclasses.replace(self.plan.assignment, tier=tier,
                                         scheme=scheme, cost=float("nan"))
        report = BillingStage(problem.table, problem.cfg)(problem, assignment)
        egress = float(np.where(sel, self.move_egress_cents, 0.0).sum())
        transfer = float(np.where(sel, self.move_transfer_cents, 0.0).sum())
        penalty = float(np.where(sel, self.move_penalty_cents, 0.0).sum())
        return MigrationPlan(
            plan=PlacementPlan(problem, assignment, report), moved=sel,
            old_tier=self.old_tier.copy(), new_tier=tier,
            old_scheme=self.old_scheme.copy(), new_scheme=scheme,
            migration_cents=egress + transfer, penalty_cents=penalty,
            egress_cents=egress, candidate=self.candidate.copy(),
            move_transfer_cents=self.move_transfer_cents.copy(),
            move_egress_cents=self.move_egress_cents.copy(),
            move_penalty_cents=self.move_penalty_cents.copy(),
            old_stored_gb=self.old_stored_gb.copy())

    def land(self, unapplied: np.ndarray) -> "MigrationPlan":
        """Fold execution outcomes back into the plan.

        ``unapplied`` marks selected moves that did **not** land (the
        executor's failed/budget-skipped rows). Those moves revert to
        deferred-candidate status — old tier/scheme in the assignment, so
        the steady-state report prices the state actually reached and the
        next cycle re-plans them. When every selected move landed, returns
        ``self`` unchanged (the zero-fault parity pin).
        """
        unapplied = np.asarray(unapplied, bool)
        if not bool((unapplied & self.moved).any()):
            return self
        return self.select(self.moved & ~unapplied)


@dataclasses.dataclass
class ReplicaPlan:
    """K-replica placement for read locality (hot partitions only).

    Extra copies of a partition are placed on *distinct providers* (or
    distinct tiers, for single-cloud tables) so reads can be served by the
    closest/fastest copy; each of a partition's ``copies`` serves ``1 /
    copies`` of its reads. Produced by
    :meth:`PlacementEngine.plan_replicas`.
    """

    copies: np.ndarray                # (N,) total copies actually placed
    replica_tier: np.ndarray          # (N, R-1) int; -1 = no copy
    replica_scheme: np.ndarray        # (N, R-1) int; -1 = no copy
    replica_cents: float              # storage + ingestion write + the read
    # share the replicas serve — real cents
    read_rebate_cents: float          # primary access cents now served by
    # replicas instead (subtract from the base report when combining)
    best_latency_ms: np.ndarray       # (N,) fastest copy's backing latency

    @property
    def n_replicated(self) -> int:
        return int((self.copies > 1).sum())

    def latency_points(self, problem: "PlacementProblem",
                       assignment: Assignment,
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Serving-latency distribution with reads split across copies:
        ``(latency_ms_points, access_weights)`` for
        :func:`repro_torch.core.cache.weighted_p99_ms`."""
        t = problem.table
        n = np.arange(problem.n)
        pts = [(t.ttfb_seconds[assignment.tier.astype(int)]
                + problem.D[n, assignment.scheme.astype(int)]) * 1e3]
        wts = [problem.rho / self.copies]
        for j in range(self.replica_tier.shape[1]):
            l_j = self.replica_tier[:, j]
            k_j = self.replica_scheme[:, j]
            has = l_j >= 0
            safe_l, safe_k = np.maximum(l_j, 0), np.maximum(k_j, 0)
            pts.append(np.where(
                has, (t.ttfb_seconds[safe_l] + problem.D[n, safe_k]) * 1e3,
                0.0))
            wts.append(np.where(has, problem.rho / self.copies, 0.0))
        return np.concatenate(pts), np.concatenate(wts)


# ------------------------------------------------------------------ stages
class PartitionStage:
    """G-PART merge (or per-dataset baseline) + partition materialization."""

    def __init__(self, cfg: ScopeConfig):
        self.cfg = cfg

    @staticmethod
    def _partition_tables(parts: Sequence[datapart.Partition],
                          file_rows: Dict[str, Tuple[Table, np.ndarray]],
                          ) -> List[Table]:
        """Materialize each partition as the concatenation of its files' rows."""
        out: List[Table] = []
        for p in parts:
            per_table: Dict[str, List[np.ndarray]] = {}
            for f in sorted(p.files):
                t, idx = file_rows[f]
                per_table.setdefault(t.name, []).append(idx)
            # A query family touches exactly one table in our workload; guard anyway.
            name = max(per_table, key=lambda n: sum(len(i) for i in per_table[n]))
            t0 = [file_rows[f][0] for f in sorted(p.files)
                  if file_rows[f][0].name == name][0]
            idx = np.sort(np.concatenate(per_table[name]))
            out.append(t0.select(idx))
        return out

    def __call__(self, parts: List[datapart.Partition],
                 file_rows: Dict[str, Tuple[Table, np.ndarray]],
                 ) -> PartitionedData:
        cfg = self.cfg
        if cfg.use_partitioning:
            med = float(np.median([p.span for p in parts])) if parts else 0.0
            merged = datapart.g_part(parts, s_thresh=cfg.s_thresh_mult * med,
                                     rho_c=cfg.rho_c, rho_c_abs=cfg.rho_c_abs,
                                     backend=cfg.partition_backend,
                                     sample=cfg.partition_sample,
                                     device=cfg.device)
        else:
            # paper's non-partitioned baselines treat each DATASET (table) as
            # one partition: every access scans its whole table
            by_table: Dict[str, List[datapart.Partition]] = {}
            for p in parts:
                tname = sorted(p.files)[0].split("/")[0]
                by_table.setdefault(tname, []).append(p)
            merged = []
            for group in by_table.values():
                merged.extend(datapart.merge_all(group))
        tables = self._partition_tables(merged, file_rows)
        raw_bytes = [t.serialize(cfg.layout) for t in tables]
        spans_gb = np.array([len(b) / 1e9 for b in raw_bytes])
        rho = np.array([p.rho for p in merged])
        return PartitionedData(merged, tables, raw_bytes, spans_gb, rho)


class CompressStage:
    """Per-partition (ratio, decompression-time) matrices — measured ground
    truth or a fitted COMPREDICT model.

    With a fitted predictor, features for all N partitions are extracted by
    ``cfg.feature_backend`` ('numpy' per-partition loop, or the batched
    'device' kernel — one launch per dtype class for the whole batch) and
    serialized sizes are reused from :class:`PartitionStage` instead of
    re-serializing every table."""

    def __init__(self, cfg: ScopeConfig):
        self.cfg = cfg

    def __call__(self, data: PartitionedData, table: CostTable,
                 ) -> PlacementProblem:
        cfg = self.cfg
        N = len(data.partitions)
        schemes = list(cfg.schemes) if cfg.use_compression else ["none"]
        K = len(schemes)
        R = np.ones((N, K))
        D = np.zeros((N, K))
        if cfg.use_compression:
            if cfg.predictor == "truth":
                for i, b in enumerate(data.raw_bytes):
                    for k, s in enumerate(schemes):
                        if s == "none":
                            continue
                        m = measure(codec_by_name(s), b)
                        R[i, k] = m.ratio
                        D[i, k] = m.decompress_sec_per_gb * (len(b) / 1e9)
            else:
                pred = cfg.predictor  # fitted CompressionPredictor instance
                Rm, Dm = pred.predict_matrix(
                    data.tables, schemes, cfg.layout,
                    sizes=[len(b) for b in data.raw_bytes],
                    feature_backend=cfg.feature_backend, device=cfg.device)
                R = Rm
                D = Dm * data.spans_gb[:, None]  # sec/GB -> sec per partition
        return PlacementProblem(
            spans_gb=data.spans_gb, rho=data.rho,
            current_tier=np.full(N, -1), R=R, D=D, schemes=schemes,
            table=table, cfg=cfg, partitions=data.partitions,
            raw_bytes=data.raw_bytes)


class AssignStage:
    """OPTASSIGN: cost tensor + feasibility mask + (greedy | capacitated)."""

    def __init__(self, table: CostTable, cfg: ScopeConfig):
        self.table = table
        self.cfg = cfg

    def serving_terms(self, problem: PlacementProblem,
                      ) -> Tuple[Optional[np.ndarray],
                                 Optional[np.ndarray]]:
        """``(cached, serving_cost)`` — the SLA + cache extension of the
        objective, as one additive (N,L,K) tensor.

        ``cached`` is the forecast-driven cache admission mask (None
        without a cache tier). The rho the solve sees is already the
        projected rate when a forecaster is attached, so admission is
        forecast-driven with zero extra plumbing. ``serving_cost`` is
        ``sla_lambda * penalty + cache access relief``; it is **None**
        whenever ``sla_lambda == 0`` and no cache tier is configured, so
        the default config leaves every solver input byte-identical to the
        pre-SLA engine (the bit-parity pin).
        """
        cfg = self.cfg
        cached = None
        extra = None
        if cfg.cache is not None:
            cached = forecast_admission(problem.rho, problem.spans_gb,
                                        cfg.cache)
            extra = cache_access_adjustment(
                problem.rho, problem.stored_matrix(), problem.D, self.table,
                cfg.weights, cached, cfg.cache.miss_rate)
        if cfg.sla_lambda > 0:
            sla = problem.effective_sla_ms()
            if bool(np.isfinite(sla).any()):
                pen = sla_penalty_tensor(problem.rho, sla, problem.D,
                                         self.table)
                if cached is not None:
                    # Admitted rows serve (1 - miss_rate) of reads at the
                    # cache hit latency: the backing-tier penalty scales to
                    # the miss traffic, plus a tier-independent term for
                    # hits that still miss an (aggressive) SLA target.
                    m = cfg.cache.miss_rate
                    hit_ex = np.where(
                        np.isfinite(sla),
                        np.maximum(cfg.cache.hit_latency_ms - sla, 0.0),
                        0.0)
                    hit_pen = ((1.0 - m) * problem.rho
                               * hit_ex)[:, None, None]
                    pen = np.where(cached[:, None, None],
                                   m * pen + hit_pen, pen)
                lam_pen = cfg.sla_lambda * pen
                extra = lam_pen if extra is None else extra + lam_pen
        return cached, extra

    def cost_and_feasibility(
        self, problem: PlacementProblem,
        extra_cost: Optional[np.ndarray] = None,      # (N,L,K) additive
        locked_scheme: Optional[np.ndarray] = None,   # (N,) -1 = free
    ) -> Tuple[np.ndarray, np.ndarray]:
        cfg, table = self.cfg, self.table
        N = problem.n
        cost = cost_tensor(problem.spans_gb, problem.rho, problem.current_tier,
                           problem.R, problem.D, table, cfg.weights,
                           months=cfg.months)
        if extra_cost is not None:
            cost = cost + extra_cost
        _, serving = self.serving_terms(problem)
        if serving is not None:
            cost = cost + serving
        feas = latency_feasible(problem.D, np.full(N, cfg.latency_sla_sec),
                                table)
        if cfg.tier_whitelist is not None:
            allowed = np.zeros(table.num_tiers, bool)
            allowed[list(cfg.tier_whitelist)] = True
            feas &= allowed[None, :, None]
        if cfg.provider_whitelist is not None:
            pnames = getattr(table, "provider_names", None)
            if pnames is None:
                raise ValueError("provider_whitelist requires a "
                                 "MultiCloudCostTable")
            unknown = set(cfg.provider_whitelist) - set(pnames)
            if unknown:
                raise ValueError(f"unknown providers {sorted(unknown)}; "
                                 f"table has {pnames}")
            wanted = np.array([p in cfg.provider_whitelist for p in pnames])
            feas &= wanted[table.provider_of_tier][None, :, None]
        if not cfg.use_tiering:
            fixed = cfg.fixed_tier if cfg.fixed_tier is not None else 0
            only = np.zeros(table.num_tiers, bool)
            only[fixed] = True
            feas &= only[None, :, None]
        if locked_scheme is not None:
            feas = lock_schemes(feas, locked_scheme)
        return cost, feas

    def solver_inputs(
        self, problem: PlacementProblem,
        extra_cost: Optional[np.ndarray] = None,
        locked_scheme: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray],
               Optional[np.ndarray], Optional[np.ndarray]]:
        """``(cost, feas, stored, cap, tier_groups, group_capacity_gb)``
        exactly as :meth:`__call__` hands them to the solver. ``cap`` is
        None when the config sets no per-tier capacities; the group fields
        are None unless the table carries finite provider capacities. The
        fleet path of ``repro.core.fleet`` batches these per-tenant tuples
        into one batched dispatch."""
        cost, feas = self.cost_and_feasibility(problem, extra_cost,
                                               locked_scheme)
        # Multi-cloud tables carry per-provider capacity totals; finite ones
        # become group constraint rows in the capacitated solver.
        gcap = getattr(self.table, "provider_capacity_gb", None)
        has_gcap = gcap is not None and bool(np.isfinite(gcap).any())
        cap = (np.asarray(self.cfg.capacity_gb, np.float64)
               if self.cfg.capacity_gb is not None else None)
        return (cost, feas, problem.stored_matrix(), cap,
                self.table.provider_of_tier if has_gcap else None,
                gcap if has_gcap else None)

    def __call__(self, problem: PlacementProblem,
                 extra_cost: Optional[np.ndarray] = None,
                 locked_scheme: Optional[np.ndarray] = None) -> Assignment:
        """Greedy when the config sets no capacities and the table no
        finite provider capacity (exact, Thm 3), else the capacitated
        solver, with a multi-cloud table's finite provider capacities as
        group rows."""
        cost, feas, stored, cap, tg, gcap = self.solver_inputs(
            problem, extra_cost, locked_scheme)
        if cap is None and tg is None:
            return greedy_assign(cost, feas, device=self.cfg.device)
        if cap is None:
            cap = np.full(self.table.num_tiers, np.inf)
        return capacitated_assign(cost, feas, stored, cap, tier_groups=tg,
                                  group_capacity_gb=gcap,
                                  device=self.cfg.device)


class BillingStage:
    """Steady-state bill of an assignment — pure array math, no Python loop."""

    def __init__(self, table: CostTable, cfg: ScopeConfig):
        self.table = table
        self.cfg = cfg

    def __call__(self, problem: PlacementProblem,
                 assignment: Assignment) -> PipelineReport:
        t, cfg = self.table, self.cfg
        l = assignment.tier.astype(int)
        k = assignment.scheme.astype(int)
        n_idx = np.arange(problem.n)
        stored = problem.spans_gb / problem.R[n_idx, k]
        d_sec = problem.D[n_idx, k]
        rho = problem.rho
        # Cache tier: admitted partitions only hit the backing tier on a
        # miss, and the cache's own storage/fill spend is real cents. The
        # admission mask is a pure function of (problem, cfg) — the same
        # mask the solver priced.
        cached = None
        cache_spend = 0.0
        rho_b = rho                       # backing-tier read traffic
        if cfg.cache is not None:
            cached = forecast_admission(rho, problem.spans_gb, cfg.cache)
            rho_b = np.where(cached, cfg.cache.miss_rate * rho, rho)
            cache_spend = cache_cents(problem.spans_gb, cached, cfg.cache,
                                      cfg.months)
        storage = float((stored * t.storage_cents_gb_month[l]).sum()
                        * cfg.months)
        read = float((rho_b * stored * t.read_cents_gb[l]).sum())
        decomp = float((rho_b * d_sec).sum() * t.compute_cents_sec)
        rho_tot = float(rho.sum())
        ttfb_acc = float((rho * t.ttfb_seconds[l]).sum())
        dlat_acc = float((rho * d_sec).sum())
        # Serving-latency metrics: raw penalty units and p99 — reported,
        # never billed (BillingMeter cents fields stay latency-free).
        lat_ms = (t.ttfb_seconds[l] + d_sec) * 1e3
        pts, w = served_latency_terms(rho, lat_ms, cached,
                                      cfg.cache if cached is not None
                                      else None)
        sla = problem.effective_sla_ms()
        sla_pts = np.concatenate([sla, sla]) if cached is not None else sla
        excess = np.where(np.isfinite(sla_pts),
                          np.maximum(pts - sla_pts, 0.0), 0.0)
        sla_penalty = float((w * excess).sum())
        p99 = weighted_p99_ms(pts, w)
        counts = np.bincount(l[l >= 0], minlength=t.num_tiers)
        prov = getattr(t, "provider_of_tier", None)
        provider_scheme = None
        if prov is not None:
            pc = np.bincount(np.asarray(prov, int)[l[l >= 0]],
                             minlength=len(t.provider_names))
            provider_scheme = [int(c) for c in pc]
        return PipelineReport(
            storage_cents=storage, decomp_cents=decomp, read_cents=read,
            total_cents=storage + decomp + read + cache_spend,
            read_latency_ttfb=ttfb_acc / max(rho_tot, 1e-12),
            decomp_latency_ms=1e3 * dlat_acc / max(rho_tot, 1e-12),
            tiering_scheme=[int(c) for c in counts],
            n_partitions=problem.n, assignment=assignment,
            spans_gb=problem.spans_gb, rho=rho, schemes=problem.schemes,
            provider_scheme=provider_scheme,
            sla_penalty=sla_penalty, p99_latency_ms=p99,
            cache_cents=cache_spend,
            n_cached=int(cached.sum()) if cached is not None else 0)


# ------------------------------------------------------------------ engine
class PlacementEngine:
    """Staged SCOPe pipeline + online re-optimization. Resolves
    ``cfg.device`` up front, so asking for the card where there is none
    raises here."""

    def __init__(self, table: CostTable, cfg: ScopeConfig):
        resolve(cfg.device)
        self.table = table
        self.cfg = cfg
        self.partition = PartitionStage(cfg)
        self.compress = CompressStage(cfg)
        self.assign = AssignStage(table, cfg)
        self.billing = BillingStage(table, cfg)

    # ------------------------------------------------------------- batch path
    def build_problem(self, parts: List[datapart.Partition],
                      file_rows: Dict[str, Tuple[Table, np.ndarray]],
                      ) -> PlacementProblem:
        return self.compress(self.partition(parts, file_rows), self.table)

    def solve(self, problem: PlacementProblem) -> PlacementPlan:
        assignment = self.assign(problem)
        report = self.billing(problem, assignment)
        return PlacementPlan(problem, assignment, report)

    def run(self, parts: List[datapart.Partition],
            file_rows: Dict[str, Tuple[Table, np.ndarray]]) -> PlacementPlan:
        return self.solve(self.build_problem(parts, file_rows))

    # ----------------------------------------------------------- replicas
    def plan_replicas(self, plan: PlacementPlan,
                      n_copies: Optional[np.ndarray] = None) -> ReplicaPlan:
        """Place extra read-locality copies of hot partitions.

        ``n_copies`` is the per-partition total copy count (primary
        included); by default partitions with ``rho >= cfg.replica_rho_min``
        get ``cfg.replicas`` copies and everything else one. Each extra
        copy is one additional **placement row** solved through the same
        cost tensor / solver as the primary: ingestion write + storage at
        the candidate tier plus the ``rho / copies`` read share it will
        serve, with the primary's compression scheme locked (replicas store
        the same encoded payload). Feasibility excludes every provider
        already hosting a copy (multi-cloud) or every tier already hosting
        one (single-cloud), so copies are placement-diverse by
        construction; replica passes respect residual per-tier capacities
        when ``cfg.capacity_gb`` is set. A partition whose remaining
        feasible set is empty simply gets fewer copies.

        The returned cents are additive bookkeeping against the base
        report: ``plan.report.total_cents - read_rebate_cents +
        replica_cents`` is the combined steady bill (the rebate is the
        share of the primary's access cost the replicas now serve).
        """
        prob = plan.problem
        cfg, t = self.cfg, self.table
        N = prob.n
        L = t.num_tiers
        if n_copies is None:
            want = np.where(prob.rho >= cfg.replica_rho_min,
                            max(int(cfg.replicas), 1), 1)
        else:
            want = np.maximum(np.asarray(n_copies, int), 1)
        rmax = int(want.max()) if N else 1
        prim_l = plan.assignment.tier.astype(int)
        prim_k = plan.assignment.scheme.astype(int)
        rep_tier = np.full((N, max(rmax - 1, 0)), -1, int)
        rep_scheme = np.full((N, max(rmax - 1, 0)), -1, int)
        copies = np.ones(N, int)
        if rmax <= 1 or N == 0:
            n_idx = np.arange(N)
            lat0 = (t.ttfb_seconds[np.maximum(prim_l, 0)]
                    + prob.D[n_idx, np.maximum(prim_k, 0)]) * 1e3
            return ReplicaPlan(copies, rep_tier, rep_scheme, 0.0, 0.0, lat0)

        prov = getattr(t, "provider_of_tier", None)
        used = np.zeros((N, L), bool)          # blocked tiers per partition
        safe_pl = np.maximum(prim_l, 0)
        if prov is None:
            used[np.arange(N), safe_pl] = True
        else:
            used = np.asarray(prov)[None, :] == np.asarray(prov)[safe_pl][:, None]

        # residual per-tier capacity, aged by the primaries + prior passes
        cap = (np.asarray(cfg.capacity_gb, np.float64).copy()
               if cfg.capacity_gb is not None else None)
        if cap is not None:
            usage = np.zeros(L)
            np.add.at(usage, safe_pl, plan.stored_gb)
            cap = cap - usage
        # replica rows must not re-trigger cache admission (the cache holds
        # one serving copy, fed by whichever replica is closest)
        cfg2 = dataclasses.replace(cfg, cache=None, capacity_gb=None)
        stage = AssignStage(t, cfg2)
        rep_cents = 0.0
        rebate = 0.0
        n_all = np.arange(N)
        for j in range(rmax - 1):
            rows = np.flatnonzero(want > j + 1)
            if rows.size == 0:
                break
            share = prob.rho[rows] / want[rows]
            sub = PlacementProblem(
                spans_gb=prob.spans_gb[rows], rho=share,
                current_tier=np.full(rows.size, -1),
                R=prob.R[rows], D=prob.D[rows], schemes=prob.schemes,
                table=t, cfg=cfg2,
                sla_ms=(prob.sla_ms[rows] if prob.sla_ms is not None
                        else None))
            cost, feas = stage.cost_and_feasibility(
                sub, locked_scheme=prim_k[rows])
            feas = feas & ~used[rows][:, :, None]
            ok = feas.any(axis=(1, 2))
            if not ok.any():
                continue
            rows = rows[ok]
            cost, feas = cost[ok], feas[ok]
            sub_stored = (prob.spans_gb[rows][:, None]
                          / prob.R[rows])[:, None, :].repeat(L, 1)
            if cap is not None:
                asg = capacitated_assign(cost, feas, sub_stored,
                                         np.maximum(cap, 0.0),
                                         device=cfg.device)
                if not asg.feasible:
                    continue
            else:
                asg = greedy_assign(cost, feas, device=cfg.device)
                if not asg.feasible:
                    continue
            l_j = asg.tier.astype(int)
            k_j = asg.scheme.astype(int)
            rep_tier[rows, j] = l_j
            rep_scheme[rows, j] = k_j
            copies[rows] += 1
            stored_j = prob.spans_gb[rows] / prob.R[rows, k_j]
            # real cents only — never the lambda-weighted penalty the
            # solver may have folded into `cost`
            rep_cents += float(
                (stored_j * (t.storage_cents_gb_month[l_j] * cfg.months
                             + t.write_cents_gb[l_j])).sum()
                + cfg.weights.beta * (share[ok] * (
                    stored_j * t.read_cents_gb[l_j]
                    + prob.D[rows, k_j] * t.compute_cents_sec)).sum())
            if prov is None:
                used[rows, l_j] = True
            else:
                used[rows] |= (np.asarray(prov)[None, :]
                               == np.asarray(prov)[l_j][:, None])
            if cap is not None:
                np.add.at(cap, l_j, -stored_j)

        # read share the replicas serve, priced at the PRIMARY's cell —
        # that is the traffic the base report no longer has to bill
        rep_n = copies > 1
        if rep_n.any():
            stored_p = prob.spans_gb / prob.R[n_all, np.maximum(prim_k, 0)]
            prim_access = cfg.weights.beta * prob.rho * (
                stored_p * t.read_cents_gb[safe_pl]
                + prob.D[n_all, np.maximum(prim_k, 0)] * t.compute_cents_sec)
            rebate = float((prim_access[rep_n]
                            * (copies[rep_n] - 1) / copies[rep_n]).sum())

        lat = (t.ttfb_seconds[safe_pl]
               + prob.D[n_all, np.maximum(prim_k, 0)]) * 1e3
        best = lat.copy()
        for j in range(rep_tier.shape[1]):
            has = rep_tier[:, j] >= 0
            sl = np.maximum(rep_tier[:, j], 0)
            sk = np.maximum(rep_scheme[:, j], 0)
            lat_j = (t.ttfb_seconds[sl] + prob.D[n_all, sk]) * 1e3
            best = np.where(has, np.minimum(best, lat_j), best)
        return ReplicaPlan(copies, rep_tier, rep_scheme, rep_cents, rebate,
                           best)

    # ------------------------------------------------------------ online path
    def reoptimize(self, plan: PlacementPlan, new_rho: np.ndarray,
                   months_held: "float | np.ndarray" = 0.0,
                   lock_unchanged: bool = True,
                   rho_rel_tol: float = 0.25,
                   rho_abs_tol: float = 0.0,
                   rho_ref: Optional[np.ndarray] = None) -> MigrationPlan:
        """Incremental migration plan for drifted access rates.

        The assignment objective is the steady-state cost under ``new_rho``
        **plus** the one-off cost of getting there: tier-change transfer
        (already in the cost tensor via ``current_tier`` and Delta_{u,v}),
        same-tier re-compression transfer, and early-deletion penalties for
        leaving a tier before its minimum stay (``months_held`` months after
        the last placement). ``months_held`` may be a scalar or an (N,)
        array — partitions placed at different times (e.g. a daemon's
        survivors vs. last cycle's movers) price their early-delete
        penalties with their own residency clocks. Partitions whose access
        rate drifted less than ``rho_rel_tol`` (relative, with the
        ``rho_abs_tol`` absolute floor — see :func:`drift_gate`) keep their
        scheme locked, so stable data is never re-compressed. ``rho_ref``
        overrides the drift-lock base (default: the rates ``plan`` was
        solved under) — a daemon chaining reoptimize calls passes the rate
        each scheme was *chosen* under, so slow drift still accumulates and
        budget-deferred moves stay drifted (the streaming engine carries
        this base internally). The solve runs on ``cfg.device``.
        """
        prob = plan.problem
        new_rho = np.asarray(new_rho, np.float64)
        cur_l = plan.assignment.tier.astype(int)
        cur_k = plan.assignment.scheme.astype(int)
        months_held = np.asarray(months_held, np.float64)
        if months_held.ndim not in (0, 1) or (
                months_held.ndim == 1 and months_held.shape[0] != prob.n):
            raise ValueError(f"months_held must be a scalar or shape "
                             f"({prob.n},), got {months_held.shape}")
        problem2 = dataclasses.replace(prob, rho=new_rho, current_tier=cur_l)
        ref = prob.rho if rho_ref is None else np.asarray(rho_ref, np.float64)
        return self._solve_migration(problem2, cur_l, cur_k, plan.stored_gb,
                                     months_held, lock_unchanged,
                                     rho_rel_tol, ref,
                                     rho_abs_tol=rho_abs_tol)

    def _migration_terms(self, problem2: PlacementProblem,
                         cur_l: np.ndarray, cur_k: np.ndarray,
                         old_stored: np.ndarray,
                         months_held: "float | np.ndarray",
                         lock_unchanged: bool, rho_rel_tol: float,
                         rho_ref: np.ndarray, rho_abs_tol: float = 0.0,
                         ) -> Tuple[np.ndarray, Optional[np.ndarray],
                                    np.ndarray]:
        """Everything that precedes the assignment dispatch of a migration
        solve: the ``(extra_cost, locked_scheme, penalty_cents_n)`` triple.
        Split out so a fleet path can build per-tenant terms, batch the
        assignment, and finish with :meth:`_finalize_migration` — the same
        three steps :meth:`_solve_migration` runs for one tenant."""
        table = self.table
        L = table.num_tiers
        K = len(problem2.schemes)

        drifted = drift_gate(problem2.rho, rho_ref, rho_rel_tol, rho_abs_tol)
        locked = None
        if lock_unchanged:
            locked = np.where(~drifted & (cur_k >= 0), cur_k, -1)

        new_stored_nk = problem2.spans_gb[:, None] / problem2.R   # (N,K)
        is_cur_cell = ((np.arange(L)[None, :, None] == cur_l[:, None, None])
                       & (np.arange(K)[None, None, :] == cur_k[:, None, None]))

        # Early-deletion penalty: charged whenever the object leaves its cell
        # (a tier change OR a re-compression re-put), mirroring TieredStore.
        penalty_gb = early_delete_penalty_gb(table, cur_l, months_held)  # (N,)
        penalty_cents_n = penalty_gb * old_stored                        # (N,)
        extra = self.cfg.weights.gamma * np.where(
            ~is_cur_cell, penalty_cents_n[:, None, None], 0.0)

        # Same-tier scheme change: Delta_{u,u} = 0 in the cost tensor, but a
        # re-put still pays read-out of the old payload + write-in of the new.
        safe_l = np.maximum(cur_l, 0)         # -1 rows are masked out below
        same_tier_new_scheme = ((np.arange(L)[None, :, None]
                                 == cur_l[:, None, None]) & ~is_cur_cell)
        recompress = (old_stored * table.read_cents_gb[safe_l])[:, None, None] \
            + new_stored_nk[:, None, :] * table.write_cents_gb[None, :, None]
        extra = extra + self.cfg.weights.gamma * np.where(
            same_tier_new_scheme, recompress, 0.0)

        # Cross-provider egress rides Delta in the cost tensor, which prices
        # it on the destination-compressed bytes (spans/R[k]); the bill (and
        # the store) charges it on the OLD stored payload — the bytes that
        # actually leave the provider. Re-base the objective so scheme
        # changes can't under/over-price the egress wall.
        if getattr(table, "provider_of_tier", None) is not None:
            eg_nl = move_egress_cents_gb(table, cur_l[:, None],
                                         np.arange(L)[None, :])      # (N, L)
            extra = extra + self.cfg.weights.gamma * (
                eg_nl[:, :, None]
                * (old_stored[:, None, None] - new_stored_nk[:, None, :]))
        return extra, locked, penalty_cents_n

    def _finalize_migration(self, problem2: PlacementProblem,
                            assignment: Assignment,
                            cur_l: np.ndarray, cur_k: np.ndarray,
                            old_stored: np.ndarray,
                            penalty_cents_n: np.ndarray) -> MigrationPlan:
        """Billing + per-move cents bookkeeping after the assignment solve."""
        table = self.table
        safe_l = np.maximum(cur_l, 0)
        report = self.billing(problem2, assignment)
        new_plan = PlacementPlan(problem2, assignment, report)

        new_l = assignment.tier.astype(int)
        new_k = assignment.scheme.astype(int)
        moved = (cur_l >= 0) & ((new_l != cur_l) | (new_k != cur_k))
        new_stored = new_plan.stored_gb
        # Transfer: read the old payload out of its tier; if the destination
        # tier belongs to a different provider, the old payload additionally
        # pays the source provider's egress (charged exactly once, on the
        # bytes that actually cross the provider boundary); then write the
        # (possibly re-compressed) payload into the destination tier.
        write_gb = np.where(new_k == cur_k, old_stored, new_stored)
        egress_gb = move_egress_cents_gb(table, cur_l, new_l)    # (N,)
        egress_n = np.where(moved, old_stored * egress_gb, 0.0)
        transfer_n = np.where(
            moved,
            old_stored * table.read_cents_gb[safe_l]
            + write_gb * table.write_cents_gb[new_l], 0.0)
        pen_n = np.where(moved, penalty_cents_n, 0.0)
        egress = float(egress_n.sum())
        migration = egress + float(transfer_n.sum())
        penalty = float(pen_n.sum())
        return MigrationPlan(
            plan=new_plan, moved=moved, old_tier=cur_l, new_tier=new_l,
            old_scheme=cur_k, new_scheme=new_k,
            migration_cents=migration, penalty_cents=penalty,
            egress_cents=egress, candidate=moved.copy(),
            move_transfer_cents=transfer_n, move_egress_cents=egress_n,
            move_penalty_cents=pen_n,
            old_stored_gb=np.asarray(old_stored, np.float64))

    def _solve_migration(self, problem2: PlacementProblem,
                         cur_l: np.ndarray, cur_k: np.ndarray,
                         old_stored: np.ndarray,
                         months_held: "float | np.ndarray",
                         lock_unchanged: bool, rho_rel_tol: float,
                         rho_ref: np.ndarray,
                         rho_abs_tol: float = 0.0) -> MigrationPlan:
        """Shared migration core for :meth:`reoptimize` (and, in the
        reference, its streaming engine). ``cur_l``/``cur_k`` may contain
        -1 for partitions that are new to the placement (no penalty, no transfer — pure ingestion via
        the cost tensor's Delta_{-1,l} row); ``rho_ref`` is the access rate
        each partition's current scheme was chosen under (drift-lock base).
        """
        extra, locked, penalty_cents_n = self._migration_terms(
            problem2, cur_l, cur_k, old_stored, months_held, lock_unchanged,
            rho_rel_tol, rho_ref, rho_abs_tol)
        assignment = self.assign(problem2, extra_cost=extra,
                                 locked_scheme=locked)
        return self._finalize_migration(problem2, assignment, cur_l, cur_k,
                                        old_stored, penalty_cents_n)


# --------------------------------------------------------------- streaming
def compredict_rd_fn(predictor, file_rows: Dict[str, Tuple[Table, np.ndarray]],
                     *, layout: str = "col",
                     feature_backend: Optional[str] = None,
                     device: str = "cuda") -> Callable:
    """Build a streaming ``rd_fn(parts, schemes) -> (R, D)`` from a fitted
    ``CompressionPredictor``, extracting features on ``device``.

    Each batch, the current partitions are materialized from ``file_rows``
    (as in :class:`PartitionStage`) and the predictor's batched
    ``predict_matrix`` — feature extraction in one device dispatch under
    ``feature_backend`` — supplies (R, D) so per-batch re-prediction stays
    off the N×K Python-loop path. Materialized tables and serialized sizes
    are cached by partition file-set identity (the same key the engine
    carries placement state under), so partitions that survive a fold pay
    no re-materialization or re-serialization on later batches; the cache
    is pruned to the live partition set each call. Returned D is
    whole-partition seconds, as :class:`PlacementProblem` expects."""
    resolve(device)
    cache: Dict[FrozenSet[str], Tuple[Table, int]] = {}

    def rd_fn(parts: List[datapart.Partition],
              schemes: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        missing = [p for p in parts if p.files not in cache]
        if missing:
            for p, t in zip(missing,
                            PartitionStage._partition_tables(missing,
                                                             file_rows)):
                cache[p.files] = (t, t.nbytes(layout))
        for stale in set(cache) - {p.files for p in parts}:
            del cache[stale]
        tables = [cache[p.files][0] for p in parts]
        sizes = [cache[p.files][1] for p in parts]
        spans_gb = np.array([p.span for p in parts], np.float64)
        R, Dm = predictor.predict_matrix(tables, schemes, layout, sizes=sizes,
                                         feature_backend=feature_backend,
                                         device=device)
        return R, Dm * spans_gb[:, None]
    return rd_fn
