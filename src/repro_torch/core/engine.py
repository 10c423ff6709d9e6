"""PlacementEngine — the SCOPe pipeline (paper §VII) as composable stages.

Port of ``repro.core.engine``'s batch path. Four stages exchange typed
payloads::

    PartitionStage   (parts, file_rows)      -> PartitionedData
    CompressStage    PartitionedData         -> PlacementProblem
    AssignStage      PlacementProblem        -> Assignment
    BillingStage     (problem, assignment)   -> PipelineReport

``ScopeConfig.device`` (default ``"cuda"``) is where the device parts run:
G-PART's overlap matrix (``partition_backend="device"``), COMPREDICT's
batched features (``feature_backend="device"``) and the solvers' argmin and
dual ascent. Asking for the card where there is none raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import datapart
from repro_torch.core.cache import (CacheConfig, cache_access_adjustment,
                                    cache_cents, forecast_admission,
                                    served_latency_terms, weighted_p99_ms)
from repro_torch.core.costs import (CostTable, Weights, cost_tensor,
                                    latency_feasible, sla_penalty_tensor)
from repro_torch.core.optassign import (Assignment, capacitated_assign,
                                        greedy_assign)
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

    def cost_and_feasibility(self, problem: PlacementProblem,
                             ) -> Tuple[np.ndarray, np.ndarray]:
        cfg, table = self.cfg, self.table
        N = problem.n
        cost = cost_tensor(problem.spans_gb, problem.rho, problem.current_tier,
                           problem.R, problem.D, table, cfg.weights,
                           months=cfg.months)
        _, serving = self.serving_terms(problem)
        if serving is not None:
            cost = cost + serving
        feas = latency_feasible(problem.D, np.full(N, cfg.latency_sla_sec),
                                table)
        if cfg.tier_whitelist is not None:
            allowed = np.zeros(table.num_tiers, bool)
            allowed[list(cfg.tier_whitelist)] = True
            feas &= allowed[None, :, None]
        if not cfg.use_tiering:
            fixed = cfg.fixed_tier if cfg.fixed_tier is not None else 0
            only = np.zeros(table.num_tiers, bool)
            only[fixed] = True
            feas &= only[None, :, None]
        return cost, feas

    def __call__(self, problem: PlacementProblem) -> Assignment:
        """Greedy when the config sets no capacities (exact, Thm 3), else
        the capacitated solver."""
        cost, feas = self.cost_and_feasibility(problem)
        if self.cfg.capacity_gb is None:
            return greedy_assign(cost, feas, device=self.cfg.device)
        return capacitated_assign(cost, feas, problem.stored_matrix(),
                                  np.asarray(self.cfg.capacity_gb, np.float64),
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
        return PipelineReport(
            storage_cents=storage, decomp_cents=decomp, read_cents=read,
            total_cents=storage + decomp + read + cache_spend,
            read_latency_ttfb=ttfb_acc / max(rho_tot, 1e-12),
            decomp_latency_ms=1e3 * dlat_acc / max(rho_tot, 1e-12),
            tiering_scheme=[int(c) for c in counts],
            n_partitions=problem.n, assignment=assignment,
            spans_gb=problem.spans_gb, rho=rho, schemes=problem.schemes,
            sla_penalty=sla_penalty, p99_latency_ms=p99,
            cache_cents=cache_spend,
            n_cached=int(cached.sum()) if cached is not None else 0)


# ------------------------------------------------------------------ engine
class PlacementEngine:
    """Staged SCOPe pipeline (batch path). Resolves ``cfg.device`` up front,
    so asking for the card where there is none raises here."""

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
