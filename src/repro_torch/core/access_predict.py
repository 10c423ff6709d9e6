"""Access-pattern / optimal-tier prediction (paper §IV-C).

A RandomForest classifier maps (size, age, recent monthly read/write
aggregates) to the *optimal tier* label, where ground-truth labels are
produced by running OPTASSIGN with the true future access counts — exactly
the paper's training procedure ("We used OPTASSIGN to assign the ground truth
label encoding (i.e. the optimal tier) for each dataset while training").

Out-of-time evaluation: train at month t on labels from [t, t+h), test at
month t+h on labels from [t+h, t+2h).

Port of ``repro.core.access_predict``: the labels' greedy argmin runs on
``device`` (default ``"cuda"``), the forest on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ml
from repro_torch.core.costs import (TIER_NAMES, CostTable, Weights,
                                    cost_tensor, latency_feasible)
from repro_torch.core.optassign import greedy_assign
from repro_torch.data.workloads import Workload, feature_matrix
from repro_torch.device import DeviceLike


def optimal_tiers(w: Workload, table: CostTable, lo: int, hi: int,
                  tiers: Sequence[int], read_fraction: float = 1.0,
                  latency_sla: float = np.inf, *,
                  device: DeviceLike = "cuda") -> np.ndarray:
    """Ground-truth labels: per-dataset cost-optimal tier for months [lo,hi),
    restricted to the given tier subset (e.g. Hot/Cool for Table III); the
    greedy argmin runs on ``device``."""
    lo, hi = int(lo), int(hi)
    if hi <= lo:
        raise ValueError(f"optimal_tiers needs a non-empty month window: "
                         f"got [{lo}, {hi})")
    if lo < 0 or hi > w.n_months:
        raise ValueError(f"label window [{lo}, {hi}) falls outside the "
                         f"workload's [0, {w.n_months}) months")
    spans = np.array([d.size_gb for d in w.datasets])
    rho = w.reads_in(lo, hi) * read_fraction
    months = hi - lo
    N = len(spans)
    R = np.ones((N, 1))
    D = np.zeros((N, 1))
    cur = np.full(N, -1)
    cost = cost_tensor(spans, rho, cur, R, D, table, Weights(), months=months)
    feas = latency_feasible(D, np.full(N, latency_sla), table)
    allowed = np.zeros(table.num_tiers, bool)
    allowed[list(tiers)] = True
    feas = feas & allowed[None, :, None]
    a = greedy_assign(cost, feas, device=device)
    return a.tier


@dataclasses.dataclass
class TierPredictionReport:
    confusion: np.ndarray
    f1: float
    accuracy: float
    label_names: Tuple[str, ...]


def train_tier_predictor(
    w: Workload, table: CostTable, train_month: int, horizon: int,
    tiers: Sequence[int] = (1, 2), history: int = 4,
    model: Optional[object] = None, *, device: DeviceLike = "cuda",
) -> Tuple[object, TierPredictionReport]:
    """Out-of-time: fit on [train_month, +h) labels, test on the next window.

    Requires ``train_month + horizon < w.n_months`` so the test window
    ``[t+h, min(t+2h, n_months))`` is non-empty — otherwise the metrics
    would be computed on zero labels (or an inverted slice).
    """
    train_month, horizon = int(train_month), int(horizon)
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1 month, got {horizon}")
    if train_month < 0:
        raise ValueError(f"train_month must be >= 0, got {train_month}")
    if train_month + horizon >= w.n_months:
        raise ValueError(
            f"out-of-time test window [{train_month + horizon}, "
            f"{min(train_month + 2 * horizon, w.n_months)}) is empty: "
            f"train_month + horizon must be < n_months "
            f"(= {w.n_months}); shrink train_month or horizon")
    tiers = list(tiers)
    y_tr = optimal_tiers(w, table, train_month, train_month + horizon, tiers,
                         device=device)
    y_te = optimal_tiers(w, table, train_month + horizon,
                         min(train_month + 2 * horizon, w.n_months), tiers,
                         device=device)
    X_tr = feature_matrix(w, train_month, history)
    X_te = feature_matrix(w, train_month + horizon, history)
    # map tier ids -> class indices
    tier_to_class = {t: i for i, t in enumerate(tiers)}
    c_tr = np.array([tier_to_class[t] for t in y_tr])
    c_te = np.array([tier_to_class[t] for t in y_te])
    clf = model or ml.RandomForest(n_trees=40, max_depth=10, task="clf",
                                   n_classes=len(tiers))
    clf.fit(X_tr, c_tr)
    pred = clf.predict(X_te).astype(int)
    conf = ml.confusion(c_te, pred, len(tiers))
    # binary F1 when 2 tiers; macro-F1 otherwise
    if len(tiers) == 2:
        f1 = ml.f1_binary(c_te, pred)
    else:
        f1s = []
        for c in range(len(tiers)):
            f1s.append(ml.f1_binary((c_te == c).astype(int),
                                    (pred == c).astype(int)))
        f1 = float(np.mean(f1s))
    acc = float((pred == c_te).mean())
    return clf, TierPredictionReport(conf, f1, acc,
                                     tuple(TIER_NAMES[t] for t in tiers))


def predicted_tiers(clf, w: Workload, at_month: int,
                    tiers: Sequence[int] = (1, 2),
                    history: int = 4) -> np.ndarray:
    X = feature_matrix(w, at_month, history)
    cls = clf.predict(X).astype(int)
    return np.array([list(tiers)[c] for c in cls])
