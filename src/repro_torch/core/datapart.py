"""DATAPART — access-pattern-aware data partitioning (paper §VI).

Port of ``repro.core.datapart``. Only the dense overlap sweep
(``PartitionIndex.overlap_matrix``) runs on the device, through
:mod:`repro_torch.kernels.ops`; over a mesh its row slabs are spread over
the ranks of the mesh's first dimension (:func:`_overlap_matrix_sharded`).

* Initial partitions = query families (the file sets each distinct query
  touches), built from access logs.
* G-PART (Algorithm 1): greedy max-heap merging on fractional-overlap edge
  weights, with access-comparability feasibility and an S_thresh span cap.
* Ordered (time-series) case: exact pseudo-polynomial DP (Thm 5) + the
  epsilon-bucketed (1, 1+N*eps) bi-criteria approximation (Thm 6), host
  numpy and Python as in the reference.

Array-native core: :class:`PartitionIndex` interns file ids into int32
codes and stores family membership as a CSR matrix. :func:`g_part`
rebuilds Algorithm 1 on top of it — candidate-graph construction (an
inverted-index join, the device overlap-matrix kernel, or a MinHash-style
row-sampled estimator) followed by the *identical* lazy-deletion heap
merge semantics — and :func:`g_part_ref` keeps the original pair-by-pair
``frozenset`` implementation as the equivalence oracle: on any instance
whose edge weights are distinct the two return identical partitions.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import (Dict, FrozenSet, Iterable, List, Optional, Sequence,
                    Set, Tuple)

import numpy as np

from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed import ctx
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Partition:
    """A set of files with sizes; rho = projected access count."""

    files: FrozenSet[str]
    rho: float
    sizes: "FileSizes"

    @property
    def span(self) -> float:
        return self.sizes.span(self.files)


class FileSizes:
    """File-id -> size lookup shared by all partitions of a dataset.

    ``span`` is memoized per frozenset: the merge loops re-query the same
    unions. Summation iterates files in sorted order so the result is
    PYTHONHASHSEED-independent. The cache holds every distinct frozenset
    queried over the object's lifetime.
    """

    def __init__(self, sizes: Dict[str, float]):
        self._s = dict(sizes)
        self._span_cache: Dict[FrozenSet[str], float] = {}

    def span(self, files: FrozenSet[str]) -> float:
        v = self._span_cache.get(files)
        if v is None:
            s = 0.0
            for f in sorted(files):
                s += self._s[f]
            v = self._span_cache[files] = float(s)
        return v

    def __getitem__(self, f: str) -> float:
        return self._s[f]

    def items(self):
        return self._s.items()


def make_partitions(query_files: Sequence[Tuple[Tuple[str, ...], float]],
                    sizes: Dict[str, float]) -> List[Partition]:
    """Collapse queries touching identical file sets into query families."""
    fs = FileSizes(sizes)
    fam: Dict[FrozenSet[str], float] = {}
    for files, rho in query_files:
        key = frozenset(files)
        if not key:
            continue
        fam[key] = fam.get(key, 0.0) + rho
    return [Partition(k, r, fs) for k, r in fam.items()]


def overlap(a: Partition, b: Partition) -> float:
    return a.sizes.span(a.files & b.files)


def fractional_overlap(a: Partition, b: Partition) -> float:
    # exact-zero for disjoint sets: summing spans in set-iteration order is
    # PYTHONHASHSEED-dependent, and a +1e-16 residue here would let G-PART
    # merge unrelated partitions (also a fast path — most pairs are disjoint)
    if not (a.files & b.files):
        return 0.0
    u = a.sizes.span(a.files | b.files)
    return (a.span + b.span - u) / max(u, 1e-12)


def feasible_pair(a: Partition, b: Partition, rho_c: float,
                  rho_c_abs: float) -> bool:
    """Access-comparability (paper §VI-A): ratio within rho_c OR abs diff
    within rho_c_abs."""
    hi = max(a.rho, b.rho)
    lo = max(min(a.rho, b.rho), 1e-12)
    return (hi / lo) <= rho_c or abs(a.rho - b.rho) <= rho_c_abs


def read_cost(parts: Sequence[Partition]) -> float:
    """C(Z) = sum Sp(M) * rho(M) — expected scan volume."""
    return float(sum(p.span * p.rho for p in parts))


def duplication(parts: Sequence[Partition]) -> float:
    """1 - distinct/total span (paper Fig 7 footnote)."""
    total = sum(p.span for p in parts)
    if total <= 0:
        return 0.0
    distinct_files = frozenset(itertools.chain.from_iterable(p.files for p in parts))
    distinct = parts[0].sizes.span(distinct_files) if parts else 0.0
    return 1.0 - distinct / total


# ------------------------------------------------------- array-native index
class FileInterner:
    """file id <-> dense int32 code, with a parallel f64 size array.

    Codes are assigned in first-intern order;
    ``PartitionIndex.from_partitions`` interns each family's files in
    sorted order as the family is first seen.
    """

    def __init__(self):
        self._code: Dict[str, int] = {}
        self._ids: List[str] = []
        self._size_list: List[float] = []
        self._sizes_arr: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self._ids)

    @property
    def file_ids(self) -> List[str]:
        return self._ids

    @property
    def sizes(self) -> np.ndarray:
        """(F,) float64 size per code (cached; rebuilt after growth)."""
        if self._sizes_arr is None or len(self._sizes_arr) != len(self._ids):
            self._sizes_arr = np.asarray(self._size_list, np.float64)
        return self._sizes_arr

    def intern(self, fid: str, size: float) -> int:
        c = self._code.get(fid)
        if c is None:
            c = len(self._ids)
            self._code[fid] = c
            self._ids.append(fid)
            self._size_list.append(float(size))
        return c

    def codes_of(self, files: Iterable[str], sizes: FileSizes) -> np.ndarray:
        """Ascending int32 codes of ``files`` (interning new ids)."""
        out = [self.intern(f, sizes[f]) for f in sorted(files)]
        out.sort()
        return np.asarray(out, np.int32)


@dataclasses.dataclass
class PartitionIndex:
    """CSR view of a partition list over interned int32 file codes.

    ``indices[indptr[i]:indptr[i+1]]`` are partition *i*'s file codes in
    ascending order; ``rho`` carries access rates; ``interner`` maps codes
    back to file ids and sizes.
    """

    indptr: np.ndarray                 # (N+1,) int64
    indices: np.ndarray                # (nnz,) int32, ascending per row
    rho: np.ndarray                    # (N,)  float64
    interner: FileInterner

    @classmethod
    def from_partitions(cls, parts: Sequence[Partition],
                        interner: Optional[FileInterner] = None,
                        ) -> "PartitionIndex":
        interner = interner or FileInterner()
        rows = [interner.codes_of(p.files, p.sizes) for p in parts]
        indptr = np.zeros(len(parts) + 1, np.int64)
        if rows:
            np.cumsum([len(r) for r in rows], out=indptr[1:])
        indices = (np.concatenate(rows) if rows
                   else np.zeros(0, np.int32)).astype(np.int32)
        rho = np.asarray([p.rho for p in parts], np.float64)
        return cls(indptr, indices, rho, interner)

    # ------------------------------------------------------------- basics
    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_files(self) -> int:
        return len(self.interner)

    def row(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i]:self.indptr[i + 1]]

    # --------------------------------------------------- vectorized lookups
    def span(self) -> np.ndarray:
        """(N,) partition spans — one segmented reduction over the CSR."""
        if self.n == 0:
            return np.zeros(0)
        sizes = self.interner.sizes
        out = np.add.reduceat(
            np.concatenate([sizes[self.indices], [0.0]]),
            np.minimum(self.indptr[:-1], len(self.indices)))
        out[self.indptr[:-1] == self.indptr[1:]] = 0.0
        return out[: self.n]

    def pair_overlap_spans(self, pi: np.ndarray, pj: np.ndarray,
                           ) -> np.ndarray:
        """(P,) intersection spans for the pair list — one vectorized
        key-join over both sides' CSR rows (no Python per-pair loop)."""
        pi = np.asarray(pi, np.int64)
        pj = np.asarray(pj, np.int64)
        F = np.int64(max(self.n_files, 1))
        pos = np.arange(len(pi), dtype=np.int64)

        def keys(rows):
            lens = self.indptr[rows + 1] - self.indptr[rows]
            owner = np.repeat(pos, lens)
            cat = _gather_rows(self.indices, self.indptr, rows)
            return owner * F + cat
        common = np.intersect1d(keys(pi), keys(pj), assume_unique=True)
        inter = np.zeros(len(pi))
        np.add.at(inter, common // F, self.interner.sizes[common % F])
        return inter

    # ------------------------------------------------------ kernel layout
    def padded_codes(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense ``(codes (N, M) int32 -1-padded, file sizes (F,) f32,
        spans (N,) f32)`` — the overlap-kernel input layout, ``M`` the
        longest row (at least 1)."""
        lens = np.diff(self.indptr)
        M = max(int(lens.max()) if self.n else 0, 1)
        codes = np.full((self.n, M), -1, np.int32)
        mask = np.arange(M)[None, :] < lens[:, None]
        codes[mask] = self.indices
        return (codes, self.interner.sizes.astype(np.float32),
                self.span().astype(np.float32))

    # ------------------------------------------------- candidate generation
    def candidate_pairs(self, sample: Optional[float] = None, seed: int = 0,
                        max_degree: Optional[int] = None,
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(i, j) candidate edges (i < j): every pair sharing >= 1 sampled
        file code, via an inverted-index join — the dense (N, N) matrix is
        never materialized.

        ``sample=None`` (or 1.0, no degree cap) keeps every code: the
        candidate set is then *exactly* ``{(i, j): overlap > 0}``.
        ``sample=r`` keeps each code with probability r (MinHash-style row
        sampling), and ``max_degree`` subsamples the partition group of
        hot codes — both shrink the join for N >= 1e6 files at the cost of
        possibly missing low-overlap edges.
        """
        if self.n < 2 or len(self.indices) == 0:
            e = np.zeros(0, np.int64)
            return e, e
        row_of = np.repeat(np.arange(self.n, dtype=np.int64),
                           np.diff(self.indptr))
        codes = self.indices.astype(np.int64)
        if sample is not None and sample < 1.0:
            rng = np.random.default_rng(seed)
            keep_code = rng.random(self.n_files) < sample
            m = keep_code[codes]
            codes, row_of = codes[m], row_of[m]
        if len(codes) == 0:
            e = np.zeros(0, np.int64)
            return e, e
        order = np.lexsort((row_of, codes))
        codes, rows = codes[order], row_of[order]
        starts = np.flatnonzero(np.diff(codes, prepend=codes[0] - 1))
        counts = np.diff(np.append(starts, len(codes)))
        if max_degree is not None and int(counts.max()) > max_degree:
            rng = np.random.default_rng(seed + 1)
            keep = np.ones(len(rows), bool)
            for s, c in zip(starts[counts > max_degree],
                            counts[counts > max_degree]):
                drop = rng.choice(c, c - max_degree, replace=False)
                keep[s + drop] = False
            rows = rows[keep]
            codes = codes[keep]
            starts = np.flatnonzero(np.diff(codes, prepend=codes[0] - 1))
            counts = np.diff(np.append(starts, len(codes)))
        # all intra-group pairs, vectorized by shift distance k
        start_rep = np.repeat(starts, counts)
        posn = np.arange(len(rows)) - start_rep
        cnt_rep = np.repeat(counts, counts)
        ai, bj = [], []
        for k in range(1, int(counts.max())):
            sel = posn + k < cnt_rep
            if not sel.any():
                break
            ai.append(rows[np.flatnonzero(sel)])
            bj.append(rows[np.flatnonzero(sel) + k])
        if not ai:
            e = np.zeros(0, np.int64)
            return e, e
        a = np.concatenate(ai)
        b = np.concatenate(bj)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        m = lo != hi
        key = np.unique(lo[m] * np.int64(self.n) + hi[m])
        return key // self.n, key % self.n

    # ------------------------------------------------------- matrix sweeps
    def overlap_matrix(self, device: DeviceLike = "cuda", *,
                       mesh=None) -> np.ndarray:
        """(N, N) float32 fractional-overlap matrix from
        :func:`repro_torch.kernels.ops.fractional_overlap_matrix` on
        ``device``: the CUDA kernel on the card, its plain version on the
        CPU. With a ``mesh`` (a DeviceMesh), row slabs are spread over the
        ranks of its first dimension (:func:`_overlap_matrix_sharded`);
        every rank returns the whole matrix."""
        codes, sizes, spans = self.padded_codes()
        if mesh is not None:
            return _overlap_matrix_sharded(codes, sizes, spans, mesh,
                                           device)[: self.n, : self.n]
        w = ops.fractional_overlap_matrix(codes, sizes, spans, device=device)
        return w.cpu().numpy()[: self.n, : self.n]

def _gather_rows(indices: np.ndarray, indptr: np.ndarray,
                 rows: np.ndarray) -> np.ndarray:
    """Concatenate CSR rows ``rows`` (order preserved) without a loop."""
    lens = indptr[rows + 1] - indptr[rows]
    offs = np.repeat(indptr[rows], lens)
    local = np.arange(int(lens.sum()), dtype=np.int64) \
        - np.repeat(np.cumsum(lens) - lens, lens)
    return indices[offs + local]


def _pair_weights(span_a: np.ndarray, span_b: np.ndarray,
                  inter: np.ndarray) -> np.ndarray:
    """Fractional overlap from spans + intersection span; exact 0 for
    disjoint pairs (``inter == 0`` propagates, no fp residue)."""
    den = span_a + span_b - inter
    return np.where(inter > 0.0, inter / np.maximum(den, 1e-12), 0.0)


def _feasible_mask(rho_a, rho_b, rho_c: float, rho_c_abs: float):
    """Vectorized :func:`feasible_pair` (same ops, same guards)."""
    hi = np.maximum(rho_a, rho_b)
    lo = np.maximum(np.minimum(rho_a, rho_b), 1e-12)
    return (hi / lo <= rho_c) | (np.abs(rho_a - rho_b) <= rho_c_abs)


class _NodeStore:
    """Mutable merge-time state of array ``g_part``: per-node ascending
    code arrays + span + rho, with vectorized one-vs-many overlap weights
    against the live set."""

    def __init__(self, interner: FileInterner):
        self.interner = interner
        self.codes: Dict[int, np.ndarray] = {}   # insertion-ordered
        self.span: Dict[int, float] = {}
        self.rho: Dict[int, float] = {}

    def add(self, nid: int, codes: np.ndarray, rho: float,
            span: Optional[float] = None) -> None:
        self.codes[nid] = codes
        if span is None:
            # sequential reduction in ascending-code order — the SAME
            # summation ``PartitionIndex.span`` performs (reduceat), so
            # merged nodes and initial rows see bit-identical spans
            s = self.interner.sizes[codes]
            span = float(np.add.reduceat(s, [0])[0]) if len(s) else 0.0
        self.span[nid] = float(span)
        self.rho[nid] = float(rho)

    def remove(self, nid: int) -> None:
        del self.codes[nid], self.span[nid], self.rho[nid]

    def merge(self, i: int, j: int, mid: int) -> None:
        codes = np.union1d(self.codes[i], self.codes[j])
        rho = self.rho[i] + self.rho[j]
        self.remove(i)
        self.remove(j)
        self.add(mid, codes.astype(np.int32), rho)

    def weights_against(self, q: int, others: Sequence[int],
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """``(weights, feasible_and_positive_mask_inputs)`` — fractional
        overlap of node ``q`` vs each of ``others`` in one vectorized
        pass (mask over interned codes + a single bincount)."""
        others = list(others)
        if not others:
            return np.zeros(0), np.zeros(0)
        sizes = self.interner.sizes
        mask = np.zeros(len(self.interner), bool)
        mask[self.codes[q]] = True
        cat = np.concatenate([self.codes[o] for o in others])
        seg = np.repeat(np.arange(len(others)),
                        [len(self.codes[o]) for o in others])
        hit = mask[cat]
        inter = np.bincount(seg[hit], weights=sizes[cat[hit]],
                            minlength=len(others))
        span_o = np.asarray([self.span[o] for o in others])
        w = _pair_weights(np.full(len(others), self.span[q]), span_o, inter)
        return w, np.asarray([self.rho[o] for o in others])


def _merge_loop(store: _NodeStore, heap: List[Tuple[float, int, int]],
                next_id: int, s_thresh: float, rho_c: float,
                rho_c_abs: float, neighbors: Dict[int, Set[int]]) -> int:
    """Algorithm 1's lazy-deletion heap loop over a :class:`_NodeStore`.

    Operationally identical to :func:`g_part_ref`'s loop: pop the max
    stale-tolerant edge, re-check access-comparability with current rho,
    merge, and (iff the product's span is under ``s_thresh``) push fresh
    edges from the product. New-edge targets come from ``neighbors``
    (the candidate graph is closed under merging: the product overlaps k
    iff i or j did). Returns the number of merges.
    """
    n_merges = 0
    dead: Set[int] = set()
    while heap:
        _, i, j = heapq.heappop(heap)
        if i in dead or j in dead:
            continue
        if not _feasible_mask(store.rho[i], store.rho[j], rho_c, rho_c_abs):
            continue
        mid = next_id
        next_id += 1
        store.merge(i, j, mid)
        dead.update((i, j))
        n_merges += 1
        nb = (neighbors.pop(i, set()) | neighbors.pop(j, set())) - dead
        nb.discard(mid)
        neighbors[mid] = nb
        for k in nb:
            neighbors[k].add(mid)
        targets = sorted(nb)
        if store.span[mid] >= s_thresh or not targets:
            continue
        w, rho_o = store.weights_against(mid, targets)
        ok = (w > 0.0) & _feasible_mask(store.rho[mid], rho_o,
                                        rho_c, rho_c_abs)
        for t in np.flatnonzero(ok):
            k = targets[t]
            heapq.heappush(heap, (-float(w[t]), min(mid, k), max(mid, k)))
    return n_merges


# --------------------------------------------------------------------- G-PART
def g_part_ref(parts: List[Partition], s_thresh: float, rho_c: float = 4.0,
               rho_c_abs: float = 10.0) -> List[Partition]:
    """Algorithm 1, original pair-by-pair form — the equivalence oracle.
    Lazy-deletion max-heap keyed on fractional overlap."""
    parts = list(parts)
    live: Dict[int, Partition] = dict(enumerate(parts))
    next_id = len(parts)
    heap: List[Tuple[float, int, int]] = []

    def push_edges(i: int) -> None:
        pi = live[i]
        for j, pj in live.items():
            if j == i:
                continue
            if not feasible_pair(pi, pj, rho_c, rho_c_abs):
                continue
            w = fractional_overlap(pi, pj)
            if w > 0.0:
                heapq.heappush(heap, (-w, min(i, j), max(i, j)))

    ids = list(live)
    for a_i in range(len(ids)):
        pi = live[ids[a_i]]
        for b_i in range(a_i + 1, len(ids)):
            pj = live[ids[b_i]]
            if feasible_pair(pi, pj, rho_c, rho_c_abs):
                w = fractional_overlap(pi, pj)
                if w > 0.0:
                    heapq.heappush(heap, (-w, ids[a_i], ids[b_i]))

    dead: set = set()
    while heap:
        negw, i, j = heapq.heappop(heap)
        if i in dead or j in dead:
            continue
        a, b = live[i], live[j]
        # weight may be stale after other merges — recheck feasibility
        if not feasible_pair(a, b, rho_c, rho_c_abs):
            continue
        merged = Partition(a.files | b.files, a.rho + b.rho, a.sizes)
        dead.update((i, j))
        del live[i], live[j]
        mid = next_id
        next_id += 1
        live[mid] = merged
        if merged.span < s_thresh:
            push_edges(mid)
    return list(live.values())


def g_part(parts: List[Partition], s_thresh: float, rho_c: float = 4.0,
           rho_c_abs: float = 10.0, *, backend: str = "numpy",
           sample: Optional[float] = None, sample_seed: int = 0,
           max_degree: Optional[int] = None, device: DeviceLike = "cuda",
           mesh=None) -> List[Partition]:
    """Algorithm 1 on the array-native core.

    Candidate edges (pairs with positive overlap) come from ``backend``:

    * ``'ref'`` — delegate entirely to :func:`g_part_ref` (no index);
    * ``'numpy'`` (default) — exact inverted-index join on the CSR, no
      dense matrix;
    * ``'device'`` — the batched fractional-overlap matrix
      (``repro_torch.kernels.overlap``) on ``device``: one CUDA kernel
      launch on the card, the plain tensor version on the CPU; ``mesh``
      spreads its row slabs over the ranks of the mesh's first dimension.

    ``device`` is resolved first whatever the backend, so asking for the
    card where there is none raises.

    ``sample`` (with any backend but 'ref') switches to the MinHash-style
    row-sampled estimator: only pairs sharing a *sampled* code enter the
    heap, so the candidate graph for N >= 1e6 files never goes quadratic.
    Heap weights are always recomputed in f64 from the index, and the
    merge loop replays :func:`g_part_ref`'s semantics exactly — with
    exact candidates the two implementations return identical partitions
    whenever edge weights are distinct (all pinned test instances).
    """
    resolve(device)
    if backend not in ("ref", "numpy", "device"):
        raise ValueError(f"backend must be 'ref', 'numpy' or 'device', "
                         f"got {backend!r}")
    if backend == "ref":
        return g_part_ref(parts, s_thresh, rho_c, rho_c_abs)
    if not parts:
        return []
    index = PartitionIndex.from_partitions(parts)
    if sample is not None or backend == "numpy":
        pi, pj = index.candidate_pairs(sample=sample, seed=sample_seed,
                                       max_degree=max_degree)
    else:
        w_mat = index.overlap_matrix(device=device, mesh=mesh)
        pi, pj = np.nonzero(np.triu(w_mat, 1) > 0.0)
    spans = index.span()
    inter = index.pair_overlap_spans(pi, pj)
    w = _pair_weights(spans[pi], spans[pj], inter)
    ok = (w > 0.0) & _feasible_mask(index.rho[pi], index.rho[pj],
                                    rho_c, rho_c_abs)

    store = _NodeStore(index.interner)
    for i in range(index.n):
        store.add(i, index.row(i), float(index.rho[i]),
                  span=float(spans[i]))
    neighbors: Dict[int, Set[int]] = {i: set() for i in range(index.n)}
    for a, b in zip(pi, pj):           # the w>0 graph, kept for merges
        neighbors[int(a)].add(int(b))
        neighbors[int(b)].add(int(a))
    heap = [(-float(w[t]), int(pi[t]), int(pj[t]))
            for t in np.flatnonzero(ok)]
    heapq.heapify(heap)
    _merge_loop(store, heap, index.n, s_thresh, rho_c, rho_c_abs, neighbors)
    fs = parts[0].sizes
    ids = index.interner.file_ids
    return [Partition(frozenset(ids[c] for c in codes),
                      store.rho[nid], fs)
            for nid, codes in store.codes.items()]


def merge_all(parts: List[Partition]) -> List[Partition]:
    """Baseline: one partition with everything."""
    if not parts:
        return []
    files = frozenset(itertools.chain.from_iterable(p.files for p in parts))
    return [Partition(files, sum(p.rho for p in parts), parts[0].sizes)]


# --------------------------------------------------- ordered (time-series) DP
@dataclasses.dataclass
class OrderedSolution:
    groups: List[Tuple[int, int]]   # inclusive [lo, hi] runs over partition idx
    space: float
    cost: float


def _run_spans(parts: List[Partition]) -> np.ndarray:
    """span[i][k] = Sp(P_{i-k} u ... u P_i), shape (N, N) (upper-tri by k<=i).

    Derived from the interned index: each row extends a running
    seen-files mask instead of re-summing the frozenset union at every
    (i, k) — O(N * nnz) rather than O(N^2 * union size).
    """
    N = len(parts)
    spans = np.zeros((N, N))
    if N == 0:
        return spans
    index = PartitionIndex.from_partitions(parts)
    sizes = index.interner.sizes
    seen = np.zeros(index.n_files, bool)
    for i in range(N):
        seen.fill(False)
        acc = 0.0
        for k in range(i + 1):
            c = index.row(i - k)
            new = c[~seen[c]]
            acc += float(sizes[new].sum())
            seen[c] = True
            spans[i, k] = acc
    return spans


def ordered_dp(parts: List[Partition], c_thresh: float,
               n_buckets: int = 200) -> Optional[OrderedSolution]:
    """Thm 5 DP with cost discretized onto ``n_buckets`` units.

    ALG[i][c] = min span to cover P_1..P_i within cost budget c.
    Exact in the bucketed cost; Thm 6's scheme = call with
    n_buckets = ceil(N/eps) and budget stretched to (1+N*eps)*C.
    """
    N = len(parts)
    if N == 0:
        return OrderedSolution([], 0.0, 0.0)
    spans = _run_spans(parts)
    rho_prefix = np.concatenate([[0.0], np.cumsum([p.rho for p in parts])])
    unit = c_thresh / n_buckets if c_thresh > 0 else 1.0

    def cost_units(i: int, k: int) -> int:
        rho = rho_prefix[i + 1] - rho_prefix[i - k]
        return int(np.ceil(spans[i, k] * rho / unit - 1e-12))

    INF = float("inf")
    # dp[i][c] = min space covering first i partitions (i in 0..N) w/ budget c
    dp = np.full((N + 1, n_buckets + 1), INF)
    choice = np.full((N + 1, n_buckets + 1), -1, int)
    dp[0, :] = 0.0
    for i in range(1, N + 1):
        for k in range(i):                  # merge [i-k .. i] (1-indexed)
            cu = cost_units(i - 1, k)
            if cu > n_buckets:
                continue
            sp = spans[i - 1, k]
            prev = i - k - 1
            for c in range(cu, n_buckets + 1):
                cand = dp[prev, c - cu] + sp
                if cand < dp[i, c] - 1e-12:
                    dp[i, c] = cand
                    choice[i, c] = k
    if not np.isfinite(dp[N, n_buckets]):
        return None
    # backtrack
    groups: List[Tuple[int, int]] = []
    i, c = N, n_buckets
    total_cost = 0.0
    while i > 0:
        k = choice[i, c]
        groups.append((i - k - 1, i - 1))
        cu = cost_units(i - 1, k)
        rho = rho_prefix[i] - rho_prefix[i - k - 1]
        total_cost += spans[i - 1, k] * rho
        i, c = i - k - 1, c - cu
    groups.reverse()
    return OrderedSolution(groups, float(dp[N, n_buckets]), total_cost)


def ordered_approx(parts: List[Partition], c_thresh: float,
                   eps: float) -> Optional[OrderedSolution]:
    """Thm 6: (1, 1+N*eps) bi-criteria — bucket by eps*C, extend budget."""
    N = len(parts)
    stretched = c_thresh * (1.0 + N * eps)
    n_buckets = int(np.ceil((1.0 + N * eps) / eps))
    return ordered_dp(parts, stretched, n_buckets=n_buckets)


def ordered_brute_force(parts: List[Partition],
                        c_thresh: float) -> Optional[OrderedSolution]:
    """Exact oracle over all contiguous groupings (2^(N-1)) — tests only."""
    N = len(parts)
    spans = _run_spans(parts)
    rho_prefix = np.concatenate([[0.0], np.cumsum([p.rho for p in parts])])
    best: Optional[OrderedSolution] = None
    for cuts in itertools.product([0, 1], repeat=max(N - 1, 0)):
        groups, lo = [], 0
        for i, c in enumerate(cuts):
            if c:
                groups.append((lo, i))
                lo = i + 1
        groups.append((lo, N - 1))
        space = cost = 0.0
        for a, b in groups:
            sp = spans[b, b - a]
            rho = rho_prefix[b + 1] - rho_prefix[a]
            space += sp
            cost += sp * rho
        if cost <= c_thresh + 1e-9 and (best is None or space < best.space - 1e-12):
            best = OrderedSolution(groups, space, cost)
    return best


# ---------------------------------------------------------- sharded matrix
def _overlap_matrix_sharded(codes: np.ndarray, sizes: np.ndarray,
                            spans: np.ndarray, mesh,
                            device: DeviceLike = "cuda") -> np.ndarray:
    """Row-slab-sharded overlap matrix, the counterpart of
    ``repro/core/datapart.py``'s ``_overlap_matrix_sharded``: the code
    rows are padded with -1 (spans with 0) to a multiple of the size of
    ``mesh``'s first dimension; each of its ranks computes its slab of
    rows against every row on ``device`` (K1's rectangular sweep on the
    card), and the slabs are all-gathered over that dimension. A row's
    entries are the same bits in a slab as in the whole matrix: K1 adds a
    pair's shared sizes in ascending code order whatever the rows beside
    it, and the plain version on the CPU sums them exactly before one
    rounding, whatever the shape of its products or the number of
    threads. So a mesh of one rank gives the unsharded call, bit for bit.
    Returns the padded (N', N') float32 matrix on the host."""
    group, n, r = ctx.first_axis(mesh)
    N = codes.shape[0]
    pad = (-N) % n
    codes_p = np.pad(codes, ((0, pad), (0, 0)), constant_values=-1)
    spans_p = np.pad(spans, (0, pad))
    per = codes_p.shape[0] // n
    rows = slice(r * per, (r + 1) * per)
    slab = ops.fractional_overlap_matrix(
        codes_p[rows], sizes, spans_p[rows], codes_b=codes_p,
        spans_b=spans_p, device=device)
    if n > 1:
        slab = ctx.all_gather_rows(slab, group)
    return slab.cpu().numpy()
