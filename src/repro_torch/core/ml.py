"""COMPREDICT's regression models, in numpy.

Copies of the regression models of ``repro.core.ml`` that the placement
path fits and predicts with: CART trees and a random forest, RBF kernel
ridge regression (the paper's SVR stand-in) and the averaging baseline,
plus the metric functions. A fitted tree is kept as flat node arrays
(``feature``, ``thresh``, ``left``, ``right``, ``value``), which is also
the form :mod:`repro_torch.convert` builds trees from; predictions take
the same comparisons as ``repro``'s node walk.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

# ------------------------------------------------------------------- metrics


def mae(y, p):
    return float(np.mean(np.abs(np.asarray(y) - np.asarray(p))))


def mape(y, p):
    y, p = np.asarray(y), np.asarray(p)
    return float(np.mean(np.abs(y - p) / np.maximum(np.abs(y), 1e-9))) * 100.0


def r2(y, p):
    y, p = np.asarray(y), np.asarray(p)
    ss_res = float(np.sum((y - p) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    return 1.0 - ss_res / max(ss_tot, 1e-12)


# ---------------------------------------------------------------- CART trees
class DecisionTree:
    """CART regression tree (variance reduction), stored as flat arrays:
    node ``n`` is a leaf when ``left[n] < 0``; otherwise rows with
    ``x[feature[n]] <= thresh[n]`` go to ``left[n]``, the rest to
    ``right[n]``."""

    def __init__(self, max_depth: int = 8, min_leaf: int = 2,
                 n_features: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None):
        self.max_depth, self.min_leaf = max_depth, min_leaf
        self.n_features = n_features
        self.rng = rng or np.random.default_rng(0)

    @classmethod
    def from_arrays(cls, feature, thresh, left, right, value) -> "DecisionTree":
        t = cls()
        t.feature = np.asarray(feature, np.int64)
        t.thresh = np.asarray(thresh, np.float64)
        t.left = np.asarray(left, np.int64)
        t.right = np.asarray(right, np.int64)
        t.value = np.asarray(value, np.float64)
        return t

    @staticmethod
    def _impurity(y: np.ndarray) -> float:
        return float(y.var()) * len(y)

    def _split(self, X: np.ndarray, y: np.ndarray, depth: int,
               nodes: List[list]) -> int:
        """Append the subtree for (X, y) in preorder; return its node id."""
        nid = len(nodes)
        nodes.append([-1, 0.0, -1, -1, float(y.mean())])
        if depth >= self.max_depth or len(y) < 2 * self.min_leaf or \
                np.all(y == y[0]):
            return nid
        d = X.shape[1]
        feats = self.rng.permutation(d)[: (self.n_features or d)]
        parent = self._impurity(y)
        best_gain, best = 1e-12, None
        for f in feats:
            order = np.argsort(X[:, f], kind="stable")
            xs, ys = X[order, f], y[order]
            # candidate thresholds between distinct values
            distinct = np.nonzero(np.diff(xs) > 1e-12)[0]
            if len(distinct) == 0:
                continue
            # subsample candidate split points for speed
            cand = distinct if len(distinct) <= 32 else \
                distinct[np.linspace(0, len(distinct) - 1, 32).astype(int)]
            for i in cand:
                nl = i + 1
                if nl < self.min_leaf or len(y) - nl < self.min_leaf:
                    continue
                gain = parent - self._impurity(ys[:nl]) - self._impurity(ys[nl:])
                if gain > best_gain:
                    best_gain = gain
                    best = (f, (xs[i] + xs[i + 1]) / 2.0)
        if best is None:
            return nid
        f, t = best
        mask = X[:, f] <= t
        left = self._split(X[mask], y[mask], depth + 1, nodes)
        right = self._split(X[~mask], y[~mask], depth + 1, nodes)
        nodes[nid][:4] = [int(f), float(t), left, right]
        return nid

    def fit(self, X: np.ndarray, y: np.ndarray) -> "DecisionTree":
        nodes: List[list] = []
        self._split(np.asarray(X, float), np.asarray(y, float), 0, nodes)
        cols = list(zip(*nodes))
        self.feature = np.asarray(cols[0], np.int64)
        self.thresh = np.asarray(cols[1], np.float64)
        self.left = np.asarray(cols[2], np.int64)
        self.right = np.asarray(cols[3], np.int64)
        self.value = np.asarray(cols[4], np.float64)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, float)
        rows = np.arange(X.shape[0])
        node = np.zeros(X.shape[0], np.int64)
        while True:
            inner = self.left[node] >= 0
            if not inner.any():
                return self.value[node]
            f = np.where(inner, self.feature[node], 0)
            go_left = X[rows, f] <= self.thresh[node]
            node = np.where(inner, np.where(go_left, self.left[node],
                                            self.right[node]), node)


class RandomForest:
    """Bootstrap-aggregated CART forest (paper's best model, §IV-C & §V)."""

    def __init__(self, n_trees: int = 40, max_depth: int = 10,
                 min_leaf: int = 2, seed: int = 0):
        self.seed, self.n_trees = seed, n_trees
        self.max_depth, self.min_leaf = max_depth, min_leaf
        self.trees: List[DecisionTree] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForest":
        X, y = np.asarray(X, float), np.asarray(y)
        rng = np.random.default_rng(self.seed)
        n, d = X.shape
        mfeat = max(1, d // 3 + 1)
        self.trees = []
        for i in range(self.n_trees):
            idx = rng.integers(0, n, n)
            t = DecisionTree(self.max_depth, self.min_leaf, mfeat,
                             np.random.default_rng(self.seed + i))
            self.trees.append(t.fit(X[idx], y[idx]))
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.mean([t.predict(X) for t in self.trees], axis=0)


class KernelRidge:
    """RBF kernel ridge regression — the offline stand-in for the paper's SVR."""

    def __init__(self, alpha: float = 1e-2, gamma: Optional[float] = None):
        self.alpha, self.gamma = alpha, gamma

    def _kernel(self, A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-self.g * d2)

    def fit(self, X, y):
        X = np.asarray(X, float)
        self.mu, self.sd = X.mean(0), X.std(0) + 1e-8
        self.Xtr = (X - self.mu) / self.sd
        self.g = self.gamma or 1.0 / X.shape[1]
        K = self._kernel(self.Xtr, self.Xtr)
        self.coef = np.linalg.solve(K + self.alpha * np.eye(len(K)),
                                    np.asarray(y, float))
        return self

    def predict(self, X):
        Xs = (np.asarray(X, float) - self.mu) / self.sd
        return self._kernel(Xs, self.Xtr) @ self.coef


class Averaging:
    """Paper's naive baseline: predict the training mean."""

    def fit(self, X, y):
        self.mean = float(np.mean(y))
        return self

    def predict(self, X):
        return np.full(len(X), self.mean)
