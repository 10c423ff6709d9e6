"""Streaming G-PART — incremental access-log ingestion (paper §VI, online).

Port of ``repro.core.stream``. It is host code, as in the reference: the
fold's heap merge and compaction take their edge weights from the port's
:class:`~repro_torch.core.datapart._NodeStore`, never from the device
overlap kernel.

DATAPART's G-PART (Algorithm 1) partitions from a *static* access log, but
the paper's premise — temporal access predictions feeding the optimizer —
implies logs arrive continuously. :class:`StreamingPartitioner` maintains the
G-PART partition state across :meth:`~StreamingPartitioner.ingest` calls,
LSM-tree style: new query families are *folded* into the existing partitions
with the same fractional-overlap max-heap merge rule, and a family-level log
(the "memtable of evidence") is kept alongside so :meth:`compact` can run a
full re-merge when accumulated drift exceeds a threshold.

Overlap queries route through the array-native core shared with batch
:func:`repro_torch.core.datapart.g_part`: files are interned once into int32
codes (:class:`~repro_torch.core.datapart.FileInterner`, first-seen order — the
same assignment a batch rebuild of the concatenated log produces) and every
edge weight comes from one vectorized one-vs-many pass over the live set
(:class:`~repro_torch.core.datapart._NodeStore`) instead of per-pair
``frozenset`` intersections.

Correctness contract (pinned down by ``tests/test_torch_stream.py``):

* total rho is conserved exactly by folding (merges sum rho, repeated
  families accumulate into their owning partition);
* with no decay, no window, and compaction after every batch, the streaming
  state is **exactly** batch ``g_part`` on the concatenated log — compaction
  replays Algorithm 1 over the family log with identical heap tie-breaking,
  and the shared store makes the weights bit-identical, not just equal-order;
* between compactions the objective (``datapart.read_cost``) tracks the
  batch answer within a drift-bounded tolerance.

Rolling-window semantics: ``decay`` exponentially ages all accumulated rho
once per ingest; ``window=W`` additionally retires the contribution of
batches older than ``W`` ingests (delta-subtraction, view-maintenance
style). Both leave partition *structure* untouched until the next compact.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import (Deque, Dict, FrozenSet, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from repro_torch.core.datapart import (FileInterner, FileSizes, Partition,
                                       _feasible_mask, _NodeStore,
                                       feasible_pair)

QueryFamilies = Sequence[Tuple[Tuple[str, ...], float]]


def occurrence_keys(parts: Sequence[Partition],
                    ) -> List[Tuple[FrozenSet[str], int]]:
    """Stable per-partition identity: ``(file set, occurrence index)``.

    Two live partitions can share a file set (a query family can coexist
    with a merge producing the same union when access-comparability blocks
    folding them), so bare file sets are not unique; duplicates get an
    occurrence index in plan order. This is THE disambiguation rule for
    anything keyed by partition identity across re-partitionings —
    ``TieredStore.plan_keys`` object keys and the re-optimization daemon's
    deferral/forecast bookkeeping both derive from it.
    """
    keys: List[Tuple[FrozenSet[str], int]] = []
    seen: Dict[FrozenSet[str], int] = {}
    for p in parts:
        c = seen.get(p.files, 0)
        seen[p.files] = c + 1
        keys.append((p.files, c))
    return keys


@dataclasses.dataclass
class StreamStats:
    """Counters for the ingest/compact lifecycle (benchmarks report these)."""

    n_batches: int = 0
    n_families_ingested: int = 0
    n_fold_merges: int = 0
    n_compactions: int = 0
    n_compact_merges: int = 0


class StreamingPartitioner:
    """Incremental G-PART over an unbounded stream of query families.

    Parameters mirror :func:`repro_torch.core.datapart.g_part` (``s_thresh``,
    ``rho_c``, ``rho_c_abs``); ``decay``/``window`` define the rolling
    window, ``drift_threshold`` gates automatic compaction: ``compact()``
    re-merges once the rho mass ingested (or retired) since the last
    compaction exceeds that fraction of the total.
    """

    def __init__(self, sizes: Union[FileSizes, Dict[str, float]],
                 s_thresh: float, rho_c: float = 4.0,
                 rho_c_abs: float = 10.0, decay: float = 1.0,
                 window: Optional[int] = None,
                 drift_threshold: float = 0.5):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.sizes = sizes if isinstance(sizes, FileSizes) else FileSizes(sizes)
        self.s_thresh = float(s_thresh)
        self.rho_c = float(rho_c)
        self.rho_c_abs = float(rho_c_abs)
        self.decay = float(decay)
        self.window = window
        self.drift_threshold = float(drift_threshold)
        self.stats = StreamStats()
        # family log: insertion-ordered, so compaction replays the
        # concatenated stream exactly like datapart.make_partitions would
        self._families: Dict[FrozenSet[str], float] = {}
        self._live: Dict[int, Partition] = {}
        self._owner: Dict[FrozenSet[str], int] = {}     # family -> live id
        self._owned: Dict[int, List[FrozenSet[str]]] = {}  # live id -> families
        self._next_id = 0
        # the array-native mirror of _live: same node ids, int32 code rows,
        # spans/rho — all edge weights come from here, one vectorized
        # one-vs-many pass per query instead of per-pair frozenset math
        self._interner = FileInterner()
        self._store = _NodeStore(self._interner)
        self._codes: Dict[FrozenSet[str], np.ndarray] = {}  # family codes
        # merge products at/over the span cap: Algorithm 1 never pushes new
        # edges from them, and no later-arriving node may link to them either
        # (in batch, a family node only ever has edges to its coevals) — the
        # seal is what keeps incremental folds from growing giants unboundedly
        self._sealed: set = set()
        self._history: Deque[Dict[FrozenSet[str], float]] = collections.deque()
        self._rho_drift = 0.0            # rho ingested/retired since compact

    # ------------------------------------------------------------- inspection
    @property
    def partitions(self) -> List[Partition]:
        return list(self._live.values())

    @property
    def n_partitions(self) -> int:
        return len(self._live)

    @property
    def n_families(self) -> int:
        return len(self._families)

    def total_rho(self) -> float:
        return float(sum(p.rho for p in self._live.values()))

    def drift(self) -> float:
        """Fraction of the current rho mass that arrived (or was retired)
        since the last compaction — the compaction trigger metric."""
        return self._rho_drift / max(self.total_rho(), 1e-12)

    # --------------------------------------------------------------- ingest
    def ingest(self, query_files: QueryFamilies) -> List[Partition]:
        """Fold one access-log batch into the partition state.

        Families seen before route their rho straight to the partition that
        owns them (delta propagation); genuinely new families enter as fresh
        nodes and are greedily merged against the live set with the same
        heap rule as Algorithm 1. Returns the current partitions.
        """
        self.stats.n_batches += 1
        if self.decay != 1.0:
            self._apply_decay()
        if self.window is not None:
            self._retire_expired()

        batch: Dict[FrozenSet[str], float] = {}
        touched: List[int] = []
        new_ids: List[int] = []
        for files, rho in query_files:
            key = frozenset(files)
            if not key:
                continue
            self.stats.n_families_ingested += 1
            rho = float(rho)
            self._families[key] = self._families.get(key, 0.0) + rho
            batch[key] = batch.get(key, 0.0) + rho
            self._rho_drift += rho
            owner = self._owner.get(key)
            if owner is not None:
                p = self._live[owner]
                self._live[owner] = Partition(p.files, p.rho + rho, p.sizes)
                self._store.rho[owner] = p.rho + rho
                touched.append(owner)
            else:
                nid = self._next_id
                self._next_id += 1
                self._live[nid] = Partition(key, rho, self.sizes)
                self._store.add(nid, self._family_codes(key), rho)
                self._owner[key] = nid
                self._owned[nid] = [key]
                new_ids.append(nid)
        if self.window is not None:
            self._history.append(batch)
        if touched or new_ids:
            seeds = sorted(set(touched) | set(new_ids))
            self.stats.n_fold_merges += self._merge(self._seed_edges(seeds))
        return self.partitions

    def _family_codes(self, key: FrozenSet[str]) -> np.ndarray:
        codes = self._codes.get(key)
        if codes is None:
            codes = self._codes[key] = self._interner.codes_of(key, self.sizes)
        return codes

    def _apply_decay(self) -> None:
        d = self.decay
        for key in self._families:
            self._families[key] *= d
        for i, p in self._live.items():
            self._live[i] = Partition(p.files, p.rho * d, p.sizes)
            self._store.rho[i] = p.rho * d
        for hist in self._history:
            for key in hist:
                hist[key] *= d
        self._rho_drift *= d

    def _retire_expired(self) -> None:
        """Subtract the contribution of batches older than the window."""
        while len(self._history) >= self.window:
            expired = self._history.popleft()
            for key, rho in expired.items():
                held = self._families.get(key, 0.0)
                take = min(rho, held)          # guard fp drift on re-decayed rho
                if held - take <= 1e-12:
                    take = held
                    self._families.pop(key, None)
                else:
                    self._families[key] = held - take
                owner = self._owner.get(key)
                if owner is not None:
                    p = self._live[owner]
                    new_rho = max(p.rho - take, 0.0)
                    self._live[owner] = Partition(p.files, new_rho, p.sizes)
                    self._store.rho[owner] = new_rho
                self._rho_drift += take

    # ---------------------------------------------------------- merge machinery
    def _push_from(self, heap: List[Tuple[float, int, int]], i: int,
                   targets: List[int]) -> None:
        """Push every feasible positive-overlap edge (i, t) — one vectorized
        weight pass through the shared store."""
        if not targets:
            return
        w, rho_o = self._store.weights_against(i, targets)
        ok = (w > 0.0) & _feasible_mask(self._store.rho[i], rho_o,
                                        self.rho_c, self.rho_c_abs)
        for t in np.flatnonzero(ok):
            k = targets[t]
            heapq.heappush(heap, (-float(w[t]), min(i, k), max(i, k)))

    def _seed_edges(self, seeds: Sequence[int]) -> List[Tuple[float, int, int]]:
        """Heap edges from each seed node to every live partner (the bounded
        local neighbourhood a fold has to consider)."""
        heap: List[Tuple[float, int, int]] = []
        seed_set = set(seeds)
        for i in seeds:
            if i in self._sealed:
                continue
            # both-seed pairs pushed once (from the smaller id)
            targets = [j for j in self._live
                       if j != i and j not in self._sealed
                       and not (j in seed_set and j < i)]
            self._push_from(heap, i, targets)
        return heap

    def _all_edges(self) -> List[Tuple[float, int, int]]:
        """All-pairs edges — Algorithm 1's construction, one vectorized
        row per node instead of a Python pair loop."""
        heap: List[Tuple[float, int, int]] = []
        ids = list(self._live)
        for a_i in range(len(ids)):
            self._push_from(heap, ids[a_i], ids[a_i + 1:])
        return heap

    def _merge(self, heap: List[Tuple[float, int, int]]) -> int:
        """Lazy-deletion heap merge loop — operationally identical to
        ``datapart.g_part`` so compaction reproduces it bit-for-bit."""
        n_merges = 0
        dead: set = set()
        store = self._store
        while heap:
            _, i, j = heapq.heappop(heap)
            if i in dead or j in dead:
                continue
            a, b = self._live[i], self._live[j]
            if not feasible_pair(a, b, self.rho_c, self.rho_c_abs):
                continue
            merged = Partition(a.files | b.files, a.rho + b.rho, a.sizes)
            dead.update((i, j))
            del self._live[i], self._live[j]
            mid = self._next_id
            self._next_id += 1
            self._live[mid] = merged
            store.merge(i, j, mid)
            fams = self._owned.pop(i, []) + self._owned.pop(j, [])
            self._owned[mid] = fams
            for key in fams:
                self._owner[key] = mid
            n_merges += 1
            if store.span[mid] >= self.s_thresh:
                self._sealed.add(mid)
            else:
                self._push_from(heap, mid,
                                [k for k in self._live if k != mid])
        return n_merges

    # --------------------------------------------------------------- compact
    def compact(self, force: bool = False) -> bool:
        """Full re-merge from the family log when drift warrants it.

        Rebuilds one node per accumulated family (in first-seen order) and
        replays Algorithm 1's heap construction exactly, which is what makes
        the compacted state equal batch ``g_part`` on the concatenated
        (decayed / windowed) log. Returns True if a compaction ran.
        """
        if not force and self.drift() <= self.drift_threshold:
            return False
        self._live = {}
        self._owner = {}
        self._owned = {}
        self._sealed = set()
        self._store = _NodeStore(self._interner)
        for i, (key, rho) in enumerate(self._families.items()):
            self._live[i] = Partition(key, rho, self.sizes)
            self._store.add(i, self._family_codes(key), rho)
            self._owner[key] = i
            self._owned[i] = [key]
        self._next_id = len(self._families)
        self.stats.n_compact_merges += self._merge(self._all_edges())
        self.stats.n_compactions += 1
        self._rho_drift = 0.0
        return True
