"""Columnar table abstraction + row/column serialization.

Stands in for parquet (column-major) vs CSV (row-major) in COMPREDICT's
layout study (§V "Row vs Column Oriented Storage"). A table is a dict of
named NumPy columns with dtype classes {int, float, str}.

:func:`encode_dtype_classes` additionally provides the device-transfer view
used by the batched COMPREDICT feature backends: per dtype class, every
partition's values rendered once to strings, dictionary-encoded against a
shared vocabulary, and laid out as padded int32 code matrices that
:mod:`repro_torch.kernels.entropy_features` can histogram in one launch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

DTYPE_CLASSES = ("int", "float", "str")


def dtype_class(col: np.ndarray) -> str:
    if col.dtype.kind in "iu":
        return "int"
    if col.dtype.kind == "f":
        return "float"
    return "str"


@dataclasses.dataclass
class Table:
    name: str
    columns: Dict[str, np.ndarray]

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def select(self, mask_or_idx) -> "Table":
        return Table(self.name, {k: v[mask_or_idx] for k, v in self.columns.items()})

    def head(self, n: int) -> "Table":
        return self.select(slice(0, n))

    def concat(self, other: "Table") -> "Table":
        return Table(self.name, {k: np.concatenate([v, other.columns[k]])
                                 for k, v in self.columns.items()})

    def sort_by(self, col: str) -> "Table":
        return self.select(np.argsort(self.columns[col], kind="stable"))

    # -------------------------------------------------------- serialization
    def _str_cols(self) -> List[np.ndarray]:
        out = []
        for v in self.columns.values():
            if dtype_class(v) == "float":
                out.append(np.char.mod("%.4f", v))
            elif dtype_class(v) == "int":
                out.append(np.char.mod("%d", v))
            else:
                out.append(v.astype(str))
        return out

    def to_row_bytes(self) -> bytes:
        """CSV-like row-major layout: rows of comma-joined fields."""
        cols = self._str_cols()
        if not cols:
            return b""
        joined = cols[0]
        for c in cols[1:]:
            joined = np.char.add(np.char.add(joined, ","), c)
        return ("\n".join(joined.tolist()) + "\n").encode()

    def to_col_bytes(self) -> bytes:
        """Parquet-like column-major layout: each column contiguous."""
        chunks = []
        for name, v in self.columns.items():
            header = f"#{name}\n".encode()
            body = ("\n".join(np.asarray(self._col_str(v)).tolist()) + "\n").encode()
            chunks.append(header + body)
        return b"".join(chunks)

    def _col_str(self, v: np.ndarray) -> np.ndarray:
        if dtype_class(v) == "float":
            return np.char.mod("%.4f", v)
        if dtype_class(v) == "int":
            return np.char.mod("%d", v)
        return v.astype(str)

    def serialize(self, layout: str) -> bytes:
        if layout == "row":
            return self.to_row_bytes()
        if layout == "col":
            return self.to_col_bytes()
        raise ValueError(layout)

    # ---------------------------------------------------------------- sizes
    def nbytes(self, layout: str = "row") -> int:
        return len(self.serialize(layout))


# --------------------------------------------------- device-transfer views
@dataclasses.dataclass
class ClassCodes:
    """Integer view of one dtype class across N partitions, device-ready.

    Values are the string renderings (``Table._col_str``) of every column of
    the class, dictionary-encoded once against a vocabulary shared by all N
    partitions (``global_codes`` / ``global_lengths`` — histograms over
    these are additive under partition concatenation), then *localized*:
    ``codes`` index each partition's own compact vocabulary so histogram
    width scales with per-partition distinct counts, not the dataset-wide
    cardinality (high-precision float columns would otherwise blow the
    vocabulary into the 1e5 range). Within a partition the layout is
    row-major (position ``r * n_cols + c``), which makes the bucketed
    20%-of-rows entropy a histogram over contiguous code ranges.
    """

    codes: np.ndarray          # (N, M)    int32 local codes, -1 padded
    n_valid: np.ndarray        # (N,)      int32, values per partition
    n_rows: np.ndarray         # (N,)      int32, rows per partition
    n_cols: np.ndarray         # (N,)      int32, columns of this class
    lengths: np.ndarray        # (N, Vmax) float32, len(s) per local slot
    vocab: np.ndarray          # (N, Vmax) int32, global code per local slot
    n_distinct: np.ndarray     # (N,)      int32, live local slots
    global_codes: np.ndarray   # (N, M)    int32 shared-vocab codes, -1 pad
    global_lengths: np.ndarray  # (V,)     float32, len(s) per global entry

    @property
    def vocab_size(self) -> int:
        return int(self.global_lengths.shape[0])


def encode_dtype_classes(tables: Sequence["Table"]) -> Dict[str, ClassCodes]:
    """One-pass dictionary encoding of N partitions for the feature kernels.

    Returns ``{dtype_class: ClassCodes}``. This is COMPREDICT's "one-time
    full scan" (paper §V): strings are rendered and uniqued exactly once
    here (the NumPy feature path re-renders every column per bucket);
    localization and every subsequent feature extraction — including
    per-batch re-prediction on the streaming hot path — are pure integer
    work (see ``repro_torch.core.compredict.extract_features_batch``).
    """
    out: Dict[str, ClassCodes] = {}
    N = len(tables)
    for d in DTYPE_CLASSES:
        flats: List[np.ndarray] = []
        n_rows = np.zeros(N, np.int32)
        n_cols = np.zeros(N, np.int32)
        for i, t in enumerate(tables):
            cols = [t._col_str(v) for v in t.columns.values()
                    if dtype_class(v) == d]
            n_rows[i] = t.num_rows
            n_cols[i] = len(cols)
            flats.append(np.stack(cols, axis=1).reshape(-1) if cols
                         else np.empty(0, "<U1"))
        n_valid = np.array([f.shape[0] for f in flats], np.int32)
        total = int(n_valid.sum())
        if total:
            uniq, inv = np.unique(np.concatenate(flats), return_inverse=True)
            global_lengths = np.char.str_len(
                uniq.astype(str)).astype(np.float32)
        else:
            inv = np.zeros(0, np.int64)
            global_lengths = np.zeros(1, np.float32)
        M = max(int(n_valid.max()) if N else 0, 1)
        global_codes = np.full((N, M), -1, np.int32)
        locals_: List[Tuple[np.ndarray, np.ndarray]] = []
        off = 0
        for i, nv in enumerate(n_valid):
            g = inv[off:off + nv]
            global_codes[i, :nv] = g
            locals_.append(np.unique(g, return_inverse=True))
            off += nv
        n_distinct = np.array([len(lu) for lu, _ in locals_], np.int32)
        Vmax = max(int(n_distinct.max()) if N else 0, 1)
        codes = np.full((N, M), -1, np.int32)
        vocab = np.full((N, Vmax), -1, np.int32)
        lengths = np.zeros((N, Vmax), np.float32)
        for i, (lu, linv) in enumerate(locals_):
            codes[i, :n_valid[i]] = linv
            vocab[i, :len(lu)] = lu
            lengths[i, :len(lu)] = global_lengths[lu]
        out[d] = ClassCodes(codes=codes, n_valid=n_valid, n_rows=n_rows,
                            n_cols=n_cols, lengths=lengths, vocab=vocab,
                            n_distinct=n_distinct, global_codes=global_codes,
                            global_lengths=global_lengths)
    return out
