"""Enterprise data-lake workload generator (paper §I Figs 1–2, §III).

A copy of ``repro.data.workloads`` (numpy only): the same seed and the
same generator give the same datasets, access series and query logs.

Generates datasets with log-normal sizes (GB..PB) and monthly access series
drawn from the access-pattern families the paper documents on the Adobe
Experience Platform data lake:

 * ``decreasing``  — read volume decays with dataset age (Fig 2 top-left);
 * ``constant``    — flat read volume (Fig 2 top-right);
 * ``periodic``    — seasonal peaks, e.g. year-on-year analysis (Fig 2 bottom-left);
 * ``spike``       — one-time activation: read+write burst then silence (§I);
 * ``cold``        — zero/near-zero accesses (the skew mass of Fig 1a).

Popularity across datasets is Zipf-like (Fig 1a: few datasets dominate).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

PATTERNS = ("decreasing", "constant", "periodic", "spike", "cold")


@dataclasses.dataclass
class DatasetTrace:
    name: str
    size_gb: float
    created_month: int            # month index when ingested
    pattern: str
    reads: np.ndarray             # (n_months,) read ops per month
    writes: np.ndarray            # (n_months,) write ops per month

    def age_at(self, month: int) -> int:
        return max(month - self.created_month, 0)


@dataclasses.dataclass
class Workload:
    datasets: List[DatasetTrace]
    n_months: int

    def reads_in(self, lo: int, hi: int) -> np.ndarray:
        """Total reads per dataset in months [lo, hi)."""
        return np.array([d.reads[lo:hi].sum() for d in self.datasets])


def generate_workload(n_datasets: int = 200, n_months: int = 24,
                      seed: int = 0,
                      size_lognorm=(4.0, 2.0),
                      pattern_probs: Optional[Dict[str, float]] = None,
                      rng: Optional[np.random.Generator] = None
                      ) -> Workload:
    """``size_lognorm``=(mu, sigma) of ln(size in GB): defaults span
    ~1 GB .. ~1 PB with a heavy right tail, matching Enterprise Data I.

    All randomness flows through ``rng`` (an explicit
    ``np.random.Generator``); ``seed`` only applies when ``rng`` is None,
    so callers sharing one generator get reproducible composed streams.
    """
    rng = np.random.default_rng(seed) if rng is None else rng
    probs = pattern_probs or {"decreasing": 0.3, "constant": 0.15,
                              "periodic": 0.15, "spike": 0.1, "cold": 0.3}
    names = list(probs)
    p = np.array([probs[k] for k in names])
    p = p / p.sum()
    # Zipf base popularity (Fig 1a): a few datasets get most accesses.
    ranks = np.arange(1, n_datasets + 1, dtype=float)
    zipf_w = ranks ** -1.1
    zipf_w = zipf_w / zipf_w.sum() * n_datasets
    rng.shuffle(zipf_w)

    datasets: List[DatasetTrace] = []
    for i in range(n_datasets):
        size_gb = float(np.exp(rng.normal(*size_lognorm)))
        created = int(rng.integers(0, max(n_months - 2, 1)))
        pattern = names[rng.choice(len(names), p=p)]
        base = 40.0 * zipf_w[i]
        months = np.arange(n_months)
        rel = months - created
        active = rel >= 0
        if pattern == "decreasing":
            lam = rng.uniform(0.15, 0.5)
            mean = base * np.exp(-lam * np.maximum(rel, 0))
        elif pattern == "constant":
            mean = base * np.ones(n_months) * 0.6
        elif pattern == "periodic":
            period = rng.choice([6, 12])
            phase = rng.integers(0, period)
            mean = base * (0.15 + 1.7 * ((rel + phase) % period == 0))
        elif pattern == "spike":
            mean = np.where(rel <= 1, base * 3.0, 0.02 * base)
        else:  # cold
            mean = np.full(n_months, 0.02)
        mean = np.where(active, mean, 0.0)
        reads = rng.poisson(np.maximum(mean, 0.0)).astype(float)
        writes = np.zeros(n_months)
        if pattern == "spike":
            writes[created:created + 2] = rng.poisson(base, 2)
        else:
            writes[created] = max(1.0, rng.poisson(3))
            writes += rng.poisson(np.maximum(mean * 0.1, 0.0))
        writes = np.where(active, writes, 0.0)
        datasets.append(DatasetTrace(f"ds{i:04d}", size_gb, created, pattern,
                                     reads, writes))
    return Workload(datasets, n_months)


def feature_matrix(w: Workload, at_month: int, history: int = 4) -> np.ndarray:
    """Paper §IV-C features: (i) size, (ii) age in months, (iii/iv) monthly
    read and write aggregates for the last ``history`` months.

    ``at_month`` is clamped to ``[0, n_months]``: before month 0 there is
    no history (the window is all zeros), and a negative index must never
    reach the slice below — ``reads[0:-1]`` would silently read from the
    *end* of the trace and poison the training features.
    """
    if history < 0:
        raise ValueError(f"history must be >= 0, got {history}")
    at_month = min(max(int(at_month), 0), w.n_months)
    rows = []
    for d in w.datasets:
        lo = max(at_month - history, 0)
        reads = d.reads[lo:at_month]
        writes = d.writes[lo:at_month]
        pad = history - len(reads)
        reads = np.concatenate([np.zeros(pad), reads])
        writes = np.concatenate([np.zeros(pad), writes])
        rows.append(np.concatenate([[np.log1p(d.size_gb), d.age_at(at_month)],
                                    reads, writes]))
    return np.stack(rows)


# ---------------------------------------------------- streaming access logs
QueryFamilies = List[Tuple[Tuple[str, ...], float]]


def n_files_of(d: DatasetTrace, max_files: int = 12,
               file_gb: float = 256.0) -> int:
    """Datasets are stored as contiguous 'files' of ~``file_gb`` each,
    capped at ``max_files`` — the unit DATAPART partitions over."""
    return int(np.clip(np.ceil(d.size_gb / file_gb), 1, max_files))


def dataset_file_sizes(w: Workload, max_files: int = 12,
                       file_gb: float = 256.0) -> Dict[str, float]:
    """file_id -> size in GB for every dataset in the workload."""
    sizes: Dict[str, float] = {}
    for d in w.datasets:
        n = n_files_of(d, max_files, file_gb)
        for j in range(n):
            sizes[f"{d.name}/{j:03d}"] = d.size_gb / n
    return sizes


def monthly_query_log(w: Workload, month: int, rng: np.random.Generator,
                      queries_per_active: int = 3, max_files: int = 12,
                      file_gb: float = 256.0) -> QueryFamilies:
    """One month's access log as (files-touched, rho) query families.

    Each dataset active in ``month`` splits its read volume across one
    full-dataset scan plus ``queries_per_active - 1`` contiguous file-range
    scans (data lakes ingest time-ordered events, so range predicates touch
    contiguous file runs — same structure as the TPC-H chunking).

    ``rng`` is required: all emitter randomness flows through the caller's
    generator so streaming tests and benchmarks are reproducible.
    """
    out: QueryFamilies = []
    for d in w.datasets:
        reads = float(d.reads[month]) if month < len(d.reads) else 0.0
        if reads <= 0.0:
            continue
        n = n_files_of(d, max_files, file_gb)
        files = [f"{d.name}/{j:03d}" for j in range(n)]
        q = max(int(queries_per_active), 1)
        shares = rng.dirichlet(np.ones(q)) * reads
        out.append((tuple(files), float(shares[0])))          # full scan
        for s in shares[1:]:
            lo = int(rng.integers(0, n))
            hi = lo + int(rng.integers(1, n - lo + 1))
            out.append((tuple(files[lo:hi]), float(s)))
    return out


def stream_query_log(w: Workload, rng: np.random.Generator,
                     months: Optional[int] = None,
                     queries_per_active: int = 3, max_files: int = 12,
                     file_gb: float = 256.0) -> Iterator[QueryFamilies]:
    """Month-by-month access-log emitter driving ``StreamingEngine``:
    yields one ``monthly_query_log`` batch per month of the trace."""
    for m in range(months if months is not None else w.n_months):
        yield monthly_query_log(w, m, rng, queries_per_active, max_files,
                                file_gb)
