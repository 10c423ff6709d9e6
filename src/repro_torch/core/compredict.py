"""COMPREDICT — compression ratio / decompression-speed prediction (paper §V).

Port of ``repro.core.compredict``: the weighted-entropy features (per
partition in numpy, or batched on the device), sampling, label generation
from measured codecs, the evaluation harness (:func:`train_eval`) and the
fitted :class:`CompressionPredictor`. The batched backend ``'device'`` runs
:func:`repro_torch.kernels.ops.weighted_entropy_features` on ``device``:
the CUDA kernel on the card, its plain tensor version on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ml
from repro_torch.data.tables import (ClassCodes, Table, dtype_class,
                                     encode_dtype_classes, DTYPE_CLASSES)
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import ops
from repro_torch.storage.codecs import Codec, default_codecs, measure

#: 'numpy' is the per-partition string/unique loop; 'device' is the batched
#: weighted-entropy kernel over a one-pass dictionary encoding.
FEATURE_BACKENDS = ("numpy", "device")


def _bucket_edges(n: int, n_buckets: int) -> np.ndarray:
    """Exact integer bucket edges: edge[b] = floor(b*n/n_buckets)."""
    return (np.arange(n_buckets + 1, dtype=np.int64) * int(n)) // n_buckets


# ------------------------------------------------------------------ features
def weighted_entropy(table: Table) -> Dict[str, float]:
    """H(P,d) = -sum_{s in P[:,d]} len(s) * pr(s) * log pr(s), one per dtype.

    pr(s) is the empirical probability of string value s among the values of
    all columns with dtype-class d; len(s) its string length (paper §V).
    """
    by_dtype: Dict[str, List[np.ndarray]] = {d: [] for d in DTYPE_CLASSES}
    for name, col in table.columns.items():
        by_dtype[dtype_class(col)].append(table._col_str(col))
    out = {}
    for d, cols in by_dtype.items():
        if not cols:
            out[d] = 0.0
            continue
        vals = np.concatenate(cols)
        uniq, counts = np.unique(vals, return_counts=True)
        pr = counts / counts.sum()
        lens = np.char.str_len(uniq.astype(str))
        out[d] = float(-(lens * pr * np.log(pr + 1e-300)).sum())
    return out


def bucketed_weighted_entropy(table: Table, n_buckets: int = 5) -> List[float]:
    """Entropy of each successive 1/n_buckets of rows (paper's sorted-data
    feature): captures local repetition that column sorting creates."""
    n = table.num_rows
    feats: List[float] = []
    edges = _bucket_edges(n, n_buckets)
    for lo, hi in zip(edges[:-1], edges[1:]):
        h = weighted_entropy(table.select(slice(lo, hi)))
        feats.extend(h[d] for d in DTYPE_CLASSES)
    return feats


def _entropy_block(table: Table) -> List[float]:
    """Per-dtype feature block: [H(P,d), plain entropy, distinct fraction,
    mean value length, #columns] for d in {int,float,str}."""
    by_dtype: Dict[str, List[np.ndarray]] = {d: [] for d in DTYPE_CLASSES}
    for col in table.columns.values():
        by_dtype[dtype_class(col)].append(table._col_str(col))
    feats: List[float] = []
    for d in DTYPE_CLASSES:
        cols = by_dtype[d]
        if not cols:
            feats += [0.0] * 5
            continue
        vals = np.concatenate(cols)
        uniq, counts = np.unique(vals, return_counts=True)
        pr = counts / max(counts.sum(), 1)    # 0-row partitions: all zeros
        lens = np.char.str_len(uniq.astype(str))
        feats += [float(-(lens * pr * np.log(pr + 1e-300)).sum()),   # H(P,d)
                  float(-(pr * np.log(pr + 1e-300)).sum()),
                  len(uniq) / max(len(vals), 1),
                  float(lens @ pr),
                  float(len(cols))]
    return feats


def extract_features(table: Table, layout: str, kind: str = "weighted_entropy",
                     *, size: Optional[int] = None,
                     n_buckets: int = 5) -> np.ndarray:
    """Feature vector for one partition. ``size`` short-circuits the
    serialized-size probe when the caller already holds the raw bytes."""
    if size is None:
        size = table.nbytes(layout)
    n_rows = max(table.num_rows, 1)
    if kind == "size":
        return np.array([np.log1p(size), np.log1p(n_rows),
                         len(table.columns)], float)
    base = [np.log1p(size), np.log1p(n_rows), size / n_rows]
    if kind == "weighted_entropy":
        return np.array(base + _entropy_block(table), float)
    if kind == "bucketed":
        return np.array(base + _entropy_block(table)
                        + bucketed_weighted_entropy(table, n_buckets), float)
    raise ValueError(kind)


# ------------------------------------------------------- batched extraction
def _batched_entropy_columns(cc: ClassCodes, n_buckets: int,
                             device: DeviceLike,
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(summary (N,4), bucket_H (N,n_buckets)) for one dtype class."""
    summary, buck = ops.weighted_entropy_features(
        cc.codes, cc.n_valid, cc.n_rows, cc.n_cols, cc.lengths,
        n_buckets=n_buckets, device=device)
    return (summary.cpu().numpy().astype(np.float64),
            buck.cpu().numpy().astype(np.float64))


def extract_features_batch(tables: Sequence[Table], layout: str,
                           kind: str = "weighted_entropy",
                           backend: str = "numpy", *,
                           sizes: Optional[Sequence[int]] = None,
                           n_buckets: int = 5,
                           encoded: Optional[Dict[str, ClassCodes]] = None,
                           device: DeviceLike = "cuda") -> np.ndarray:
    """(N, F) feature matrix for N partitions in one pass.

    backend 'numpy' loops :func:`extract_features`; 'device'
    dictionary-encodes all partitions once (or reuses ``encoded`` from
    :func:`repro_torch.data.tables.encode_dtype_classes`) and computes every
    entropy feature with one weighted-entropy launch per dtype class on
    ``device``. ``device`` is resolved first whatever the backend.
    """
    resolve(device)
    if backend not in FEATURE_BACKENDS:
        raise ValueError(f"backend must be one of {FEATURE_BACKENDS}, "
                         f"got {backend!r}")
    N = len(tables)
    if sizes is None:
        sizes = [t.nbytes(layout) for t in tables]
    if N == 0:
        width = {"size": 3, "weighted_entropy": 3 + 5 * len(DTYPE_CLASSES),
                 "bucketed": 3 + (5 + n_buckets) * len(DTYPE_CLASSES)}[kind]
        return np.zeros((0, width), float)
    if backend == "numpy" or kind == "size":
        return np.stack([extract_features(t, layout, kind, size=s,
                                          n_buckets=n_buckets)
                         for t, s in zip(tables, sizes)])
    if kind not in ("weighted_entropy", "bucketed"):
        raise ValueError(kind)
    enc = encoded if encoded is not None else encode_dtype_classes(tables)
    per_class = {d: _batched_entropy_columns(
        enc[d], n_buckets if kind == "bucketed" else 1, device)
        for d in DTYPE_CLASSES}
    sizes_a = np.asarray(sizes, float)
    n_rows = np.maximum(np.array([t.num_rows for t in tables], float), 1.0)
    cols = [np.log1p(sizes_a), np.log1p(n_rows), sizes_a / n_rows]
    for d in DTYPE_CLASSES:
        summary, _ = per_class[d]
        has = (enc[d].n_cols > 0).astype(float)    # no columns -> all zeros
        cols += [summary[:, 0] * has, summary[:, 1] * has,
                 summary[:, 2] * has, summary[:, 3] * has,
                 enc[d].n_cols.astype(float)]
    if kind == "bucketed":
        for b in range(n_buckets):
            for d in DTYPE_CLASSES:
                _, buck = per_class[d]
                cols.append(buck[:, b] * (enc[d].n_cols > 0))
    return np.stack(cols, axis=1)


# ------------------------------------------------------------------ sampling
def random_samples(table: Table, n_samples: int, rows_each: int,
                   seed: int = 0) -> List[Table]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_samples):
        k = min(rows_each, table.num_rows)
        idx = rng.choice(table.num_rows, size=k, replace=False)
        out.append(table.select(np.sort(idx)))
    return out


def query_samples(queries, db_tables: Dict[str, Table],
                  max_rows: int = 4000) -> List[Table]:
    """Partitions derived from query results — the paper's better sampler."""
    out = []
    for q in queries:
        t = db_tables[q.table]
        rows = q.rows[:max_rows]
        if len(rows) == 0:
            continue
        out.append(t.select(rows))
    return out


# -------------------------------------------------------------------- labels
@dataclasses.dataclass
class LabeledSet:
    X: np.ndarray                  # (n, f) features
    ratio: np.ndarray              # (n,)   compression ratio R
    dspeed: np.ndarray             # (n,)   decompression sec/GB D'
    scheme: str
    layout: str
    feature_kind: str


def build_dataset(samples: Sequence[Table], codec: Codec, layout: str,
                  feature_kind: str = "weighted_entropy") -> LabeledSet:
    X, R, D = [], [], []
    for t in samples:
        raw = t.serialize(layout)
        if len(raw) < 64:
            continue
        m = measure(codec, raw)
        X.append(extract_features(t, layout, feature_kind))
        R.append(m.ratio)
        D.append(m.decompress_sec_per_gb)
    return LabeledSet(np.stack(X), np.array(R), np.array(D),
                      codec.name, layout, feature_kind)


# ------------------------------------------------------------------ pipeline
#: model name -> constructor taking the device a model trains on (only the
#: MLP uses it; the others are numpy)
MODELS = {
    "Averaging": lambda device: ml.Averaging(),
    "RandomForest": lambda device: ml.RandomForest(n_trees=30, max_depth=12),
    "NeuralNetwork": lambda device: ml.MLP(hidden=(64, 64), epochs=500,
                                           device=device),
    "SVR": lambda device: ml.KernelRidge(alpha=1e-2),
}


@dataclasses.dataclass
class EvalResult:
    model: str
    target: str               # 'ratio' | 'dspeed'
    mae: float
    mape: float
    r2: float


def train_eval(ds: LabeledSet, model_name: str, target: str,
               train_frac: float = 0.7, seed: int = 0, *,
               device: DeviceLike = "cuda") -> Tuple[object, EvalResult]:
    """Fit ``model_name`` on a seeded ``train_frac`` split of ``ds`` and
    score it on the rest; the MLP trains on ``device``."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    n = len(ds.X)
    order = rng.permutation(n)
    cut = max(int(n * train_frac), 1)
    tr, te = order[:cut], order[cut:]
    y = ds.ratio if target == "ratio" else ds.dspeed
    model = MODELS[model_name](dev)
    model.fit(ds.X[tr], y[tr])
    pred = model.predict(ds.X[te] if len(te) else ds.X[tr])
    ytrue = y[te] if len(te) else y[tr]
    res = EvalResult(model_name, target, ml.mae(ytrue, pred),
                     ml.mape(ytrue, pred), ml.r2(ytrue, pred))
    return model, res


class CompressionPredictor:
    """Per-(scheme, layout) models predicting (ratio, decompression sec/GB)
    from weighted-entropy features.

    ``feature_backend`` selects how :meth:`predict_matrix` extracts
    features for a batch of partitions ('numpy' | 'device', see
    :func:`extract_features_batch`); training always uses the numpy path.
    ``models`` maps ``(scheme, layout, target)`` to a fitted model, target
    being 'ratio' or 'dspeed'. ``device`` is where an ``"NeuralNetwork"``
    predictor's MLPs train and predict; the numpy models ignore it."""

    def __init__(self, feature_kind: str = "weighted_entropy",
                 model_name: str = "RandomForest",
                 feature_backend: str = "numpy",
                 device: DeviceLike = "cuda"):
        if feature_backend not in FEATURE_BACKENDS:
            raise ValueError(f"feature_backend must be one of "
                             f"{FEATURE_BACKENDS}, got {feature_backend!r}")
        self.feature_kind = feature_kind
        self.model_name = model_name
        self.feature_backend = feature_backend
        self.device = device
        self.models: Dict[Tuple[str, str, str], object] = {}

    def fit(self, samples: Sequence[Table], layouts: Sequence[str] = ("row", "col"),
            codecs: Optional[Sequence[Codec]] = None) -> "CompressionPredictor":
        codecs = codecs or [c for c in default_codecs() if c.name != "none"]
        for layout in layouts:
            for codec in codecs:
                ds = build_dataset(samples, codec, layout, self.feature_kind)
                for target in ("ratio", "dspeed"):
                    m = MODELS[self.model_name](self.device)
                    y = ds.ratio if target == "ratio" else ds.dspeed
                    m.fit(ds.X, y)
                    self.models[(codec.name, layout, target)] = m
        return self

    def predict_matrix(self, tables: Sequence[Table], schemes: Sequence[str],
                       layout: str, *,
                       sizes: Optional[Sequence[int]] = None,
                       feature_backend: Optional[str] = None,
                       device: DeviceLike = "cuda",
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(N,K) ratio and decompression-sec/GB matrices for OPTASSIGN.

        Features are extracted once for all N partitions via
        :func:`extract_features_batch` on ``device`` and each
        per-(scheme, target) model predicts the whole batch in one call.
        ``sizes`` forwards known serialized byte counts."""
        N, K = len(tables), len(schemes)
        R = np.ones((N, K))
        D = np.zeros((N, K))
        if N == 0:
            return R, D
        backend = feature_backend or self.feature_backend
        X = extract_features_batch(tables, layout, self.feature_kind,
                                   backend, sizes=sizes, device=device)
        for k, s in enumerate(schemes):
            if s == "none":
                continue                       # (1, 0) by definition
            R[:, k] = np.maximum(
                self.models[(s, layout, "ratio")].predict(X), 1.0)
            D[:, k] = np.maximum(
                self.models[(s, layout, "dspeed")].predict(X), 0.0)
        return R, D
