"""Self-contained ML models for COMPREDICT and access prediction.

Port of ``repro.core.ml``: CART trees and a random forest for regression
and classification, the isotonic calibrator, RBF kernel ridge regression
(the paper's SVR stand-in), the averaging baseline and the metrics, all in
numpy; and the MLP regressor/classifier, an ``nn.Module`` trained with the
reference's hand-rolled full-batch Adam on ``device``. A fitted tree is
kept as flat node arrays (``feature``, ``thresh``, ``left``, ``right``,
``value``, and ``probs`` for classification), which is also the form
:mod:`repro_torch.convert` builds trees from; predictions take the same
comparisons as ``repro``'s node walk.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve

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


def f1_binary(y, p) -> float:
    y, p = np.asarray(y).astype(int), np.asarray(p).astype(int)
    tp = int(np.sum((y == 1) & (p == 1)))
    fp = int(np.sum((y == 0) & (p == 1)))
    fn = int(np.sum((y == 1) & (p == 0)))
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return 2 * prec * rec / max(prec + rec, 1e-12)


def confusion(y, p, n_classes: int) -> np.ndarray:
    m = np.zeros((n_classes, n_classes), int)
    for a, b in zip(np.asarray(y).astype(int), np.asarray(p).astype(int)):
        m[a, b] += 1
    return m


def reliability_bins(p, y, n_bins: int = 10):
    """Reliability diagram data for binary probabilities: per bin over
    [0, 1], (count, mean predicted p, empirical positive fraction).
    Empty bins report count 0 and NaN means."""
    p = np.asarray(p, np.float64)
    y = np.asarray(y, np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    idx = np.clip(np.digitize(p, edges[1:-1]), 0, n_bins - 1)
    count = np.bincount(idx, minlength=n_bins).astype(float)
    with np.errstate(invalid="ignore"):
        mean_p = np.bincount(idx, weights=p, minlength=n_bins) \
            / np.where(count > 0, count, np.nan)
        frac_pos = np.bincount(idx, weights=y, minlength=n_bins) \
            / np.where(count > 0, count, np.nan)
    return count, mean_p, frac_pos


def expected_calibration_error(p, y, n_bins: int = 10) -> float:
    """ECE: count-weighted mean |empirical frequency - mean predicted p|
    over occupied probability bins. 0 = perfectly calibrated."""
    count, mean_p, frac_pos = reliability_bins(p, y, n_bins)
    occ = count > 0
    if not occ.any():
        return 0.0
    gap = np.abs(frac_pos[occ] - mean_p[occ])
    return float((gap * count[occ]).sum() / count[occ].sum())


# ---------------------------------------------------------------- CART trees
class DecisionTree:
    """CART: variance reduction (regression) / gini (classification),
    stored as flat arrays: node ``n`` is a leaf when ``left[n] < 0``;
    otherwise rows with ``x[feature[n]] <= thresh[n]`` go to ``left[n]``,
    the rest to ``right[n]``. ``value`` is the node's mean (regression) or
    most probable class (classification), and ``probs`` (classification
    only) its class frequencies."""

    def __init__(self, max_depth: int = 8, min_leaf: int = 2,
                 n_features: Optional[int] = None, task: str = "reg",
                 n_classes: int = 2, rng: Optional[np.random.Generator] = None):
        self.max_depth, self.min_leaf = max_depth, min_leaf
        self.n_features, self.task, self.n_classes = n_features, task, n_classes
        self.rng = rng or np.random.default_rng(0)
        self.probs: Optional[np.ndarray] = None

    @classmethod
    def from_arrays(cls, feature, thresh, left, right, value,
                    probs=None) -> "DecisionTree":
        """A fitted tree from its node arrays; ``probs`` (n_nodes,
        n_classes) makes it a classification tree."""
        t = cls()
        t.feature = np.asarray(feature, np.int64)
        t.thresh = np.asarray(thresh, np.float64)
        t.left = np.asarray(left, np.int64)
        t.right = np.asarray(right, np.int64)
        t.value = np.asarray(value, np.float64)
        if probs is not None:
            t.probs = np.asarray(probs, np.float64)
            t.task, t.n_classes = "clf", t.probs.shape[1]
        return t

    def _class_probs(self, y: np.ndarray) -> np.ndarray:
        return np.bincount(y.astype(int), minlength=self.n_classes) / len(y)

    def _impurity(self, y: np.ndarray) -> float:
        if self.task == "reg":
            return float(y.var()) * len(y)
        p = self._class_probs(y)
        return float(1.0 - np.sum(p ** 2)) * len(y)

    def _split(self, X: np.ndarray, y: np.ndarray, depth: int,
               nodes: List[list]) -> int:
        """Append the subtree for (X, y) in preorder; return its node id."""
        nid = len(nodes)
        if self.task == "reg":
            nodes.append([-1, 0.0, -1, -1, float(y.mean()), None])
        else:
            probs = self._class_probs(y)
            nodes.append([-1, 0.0, -1, -1, float(probs.argmax()), probs])
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
        y = np.asarray(y, float) if self.task == "reg" else np.asarray(y)
        self._split(np.asarray(X, float), y, 0, nodes)
        cols = list(zip(*nodes))
        self.feature = np.asarray(cols[0], np.int64)
        self.thresh = np.asarray(cols[1], np.float64)
        self.left = np.asarray(cols[2], np.int64)
        self.right = np.asarray(cols[3], np.int64)
        self.value = np.asarray(cols[4], np.float64)
        self.probs = None if self.task == "reg" else np.stack(cols[5])
        return self

    def _leaves(self, X: np.ndarray) -> np.ndarray:
        """(n,) leaf node id of each row of ``X``."""
        rows = np.arange(X.shape[0])
        node = np.zeros(X.shape[0], np.int64)
        while True:
            inner = self.left[node] >= 0
            if not inner.any():
                return node
            f = np.where(inner, self.feature[node], 0)
            go_left = X[rows, f] <= self.thresh[node]
            node = np.where(inner, np.where(go_left, self.left[node],
                                            self.right[node]), node)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.value[self._leaves(np.asarray(X, float))]

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        return self.probs[self._leaves(np.asarray(X, float))]


class RandomForest:
    """Bootstrap-aggregated CART forest (paper's best model, §IV-C & §V)."""

    def __init__(self, n_trees: int = 40, max_depth: int = 10,
                 min_leaf: int = 2, task: str = "reg", n_classes: int = 2,
                 seed: int = 0):
        self.task, self.n_classes = task, n_classes
        self.seed, self.n_trees = seed, n_trees
        self.max_depth, self.min_leaf = max_depth, min_leaf
        self.trees: List[DecisionTree] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForest":
        X, y = np.asarray(X, float), np.asarray(y)
        rng = np.random.default_rng(self.seed)
        n, d = X.shape
        mfeat = max(1, int(np.ceil(np.sqrt(d)))) if self.task == "clf" \
            else max(1, d // 3 + 1)
        self.trees = []
        for i in range(self.n_trees):
            idx = rng.integers(0, n, n)
            t = DecisionTree(self.max_depth, self.min_leaf, mfeat, self.task,
                             self.n_classes,
                             np.random.default_rng(self.seed + i))
            self.trees.append(t.fit(X[idx], y[idx]))
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.task == "reg":
            return np.mean([t.predict(X) for t in self.trees], axis=0)
        return self.predict_proba(X).argmax(1)

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """(n, n_classes) vote fractions across the forest. These are NOT
        calibrated probabilities — run them through a fitted
        :class:`IsotonicCalibrator` before treating them as such."""
        if self.task != "clf":
            raise ValueError("predict_proba is classification-only "
                             "(task='clf')")
        if not self.trees:
            raise ValueError("predict_proba before fit")
        return np.mean([t.predict_proba(X) for t in self.trees], axis=0)


class IsotonicCalibrator:
    """Monotone probability calibration by isotonic regression (PAVA).

    Maps raw classifier scores (e.g. :class:`RandomForest` vote fractions)
    to calibrated P(y=1): fit finds the least-squares *non-decreasing*
    function of the score on held-out (score, outcome) pairs via
    pool-adjacent-violators, so score ranking is preserved while the
    outputs become empirical frequencies. ``predict`` interpolates
    linearly between the fitted block means and clips to [0, 1] — the
    isotonic cousin of binned Platt scaling, but bin placement is learned
    from the violator structure instead of fixed.
    """

    def __init__(self):
        self.x_: Optional[np.ndarray] = None   # block score positions
        self.v_: Optional[np.ndarray] = None   # block calibrated values

    def fit(self, scores, outcomes) -> "IsotonicCalibrator":
        s = np.asarray(scores, np.float64).ravel()
        y = np.asarray(outcomes, np.float64).ravel()
        if s.shape != y.shape:
            raise ValueError(f"scores {s.shape} vs outcomes {y.shape}")
        if len(s) == 0:
            raise ValueError("cannot calibrate on an empty set")
        order = np.argsort(s, kind="stable")
        xs, ys = s[order], y[order]
        # pool adjacent violators: merge blocks while means decrease
        bx: List[float] = []     # weighted mean score per block
        bv: List[float] = []     # weighted mean outcome per block
        bw: List[float] = []     # block weight
        for x, t in zip(xs, ys):
            bx.append(float(x)); bv.append(float(t)); bw.append(1.0)
            while len(bv) > 1 and bv[-2] >= bv[-1]:
                w = bw[-2] + bw[-1]
                bv[-2] = (bv[-2] * bw[-2] + bv[-1] * bw[-1]) / w
                bx[-2] = (bx[-2] * bw[-2] + bx[-1] * bw[-1]) / w
                bw[-2] = w
                del bv[-1], bx[-1], bw[-1]
        x_ = np.asarray(bx)
        # interpolation needs strictly increasing x: nudge ties apart
        # (duplicate scores always land in one block, so ties are rare)
        for i in range(1, len(x_)):
            if x_[i] <= x_[i - 1]:
                x_[i] = np.nextafter(x_[i - 1], np.inf)
        self.x_ = x_
        self.v_ = np.clip(np.asarray(bv), 0.0, 1.0)
        return self

    def predict(self, scores) -> np.ndarray:
        if self.x_ is None:
            raise ValueError("predict before fit")
        s = np.asarray(scores, np.float64)
        return np.clip(np.interp(s, self.x_, self.v_), 0.0, 1.0)


# ----------------------------------------------------------------------- MLP
MLPParams = List[Dict[str, np.ndarray]]   # per layer {"w": (a, b), "b": (b,)}


class _Net(torch.nn.Module):
    """The reference's MLP: ``x @ w + b`` per layer, tanh-approximated GELU
    between layers (``jax.nn.gelu`` is the tanh form), weights laid out
    (in, out) as in the reference's pytree."""

    def __init__(self, params: MLPParams, dev: torch.device):
        super().__init__()
        # torch.tensor copies: training updates in place, and must not
        # write into the caller's init arrays
        self.w = torch.nn.ParameterList(
            torch.tensor(np.asarray(p["w"], np.float32), device=dev)
            for p in params)
        self.b = torch.nn.ParameterList(
            torch.tensor(np.asarray(p["b"], np.float32), device=dev)
            for p in params)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _mlp_apply(self.w, self.b, x)

    def arrays(self) -> MLPParams:
        return [{"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
                for w, b in zip(self.w, self.b)]


def _mlp_apply(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    for w, b in zip(ws[:-1], bs[:-1]):
        x = F.gelu(x @ w + b, approximate="tanh")
    return x @ ws[-1] + bs[-1]


def _mlp_init(sizes: Sequence[int], seed: int = 0) -> MLPParams:
    """He-normal weights and zero biases for layer ``sizes``, drawn from a
    ``torch.Generator`` seeded by ``seed`` (the reference draws from
    ``jax.random``, so the two inits differ; pass the reference's to
    :class:`MLP` as ``init_params`` to start from the same point)."""
    gen = torch.Generator().manual_seed(int(seed))
    out = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=gen, dtype=torch.float32)
        out.append({"w": (w * float(np.sqrt(2.0 / a))).numpy(),
                    "b": np.zeros(b, np.float32)})
    return out


class MLP:
    """MLP regressor/classifier, trained full-batch with the reference's
    hand-rolled Adam on ``device``; inputs (and regression targets)
    standardized with float32 numpy statistics (population std).

    One Adam step per epoch: ``m = b1 m + (1 - b1) g``, ``v = b2 v +
    (1 - b2) g^2``, bias-corrected ``mh = m / (1 - b1^t)``, ``vh = v /
    (1 - b2^t)``, then ``p -= lr mh / (sqrt(vh) + eps)`` with ``eps``
    outside the square root (``torch.optim.Adam`` differs there).
    ``init_params`` (numpy, per layer ``{"w": (in, out), "b": (out,)}``)
    replaces the seeded initial weights."""

    def __init__(self, hidden: Tuple[int, ...] = (64, 64), task: str = "reg",
                 n_classes: int = 2, lr: float = 3e-3, epochs: int = 600,
                 seed: int = 0, *, init_params: Optional[MLPParams] = None,
                 device: DeviceLike = "cuda"):
        self.hidden, self.task, self.n_classes = hidden, task, n_classes
        self.lr, self.epochs, self.seed = lr, epochs, seed
        self.init_params = init_params
        self.device = resolve(device)
        self.net: Optional[_Net] = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "MLP":
        dev = self.device
        X = np.asarray(X, np.float32)
        self.mu, self.sd = X.mean(0), X.std(0) + 1e-8
        Xs = (X - self.mu) / self.sd
        if self.task == "reg":
            y = np.asarray(y, np.float32)[:, None]
            self.ymu, self.ysd = y.mean(), y.std() + 1e-8
            ys = (y - self.ymu) / self.ysd
            out = 1
        else:
            ys = np.asarray(y, np.int64)
            out = self.n_classes
        sizes = (X.shape[1], *self.hidden, out)
        params = (self.init_params if self.init_params is not None
                  else _mlp_init(sizes, self.seed))
        net = _Net(params, dev)
        xb = torch.as_tensor(Xs, device=dev)
        yb = torch.as_tensor(ys, device=dev)
        lr, b1, b2, eps = self.lr, 0.9, 0.999, 1e-8
        ps = list(net.parameters())
        m = [torch.zeros_like(p) for p in ps]
        v = [torch.zeros_like(p) for p in ps]
        for t in range(1, self.epochs + 1):
            out_b = net(xb)
            if self.task == "reg":
                loss = ((out_b - yb) ** 2).mean()
            else:
                logp = torch.log_softmax(out_b, dim=-1)
                loss = -logp.gather(1, yb[:, None]).mean()
            grads = torch.autograd.grad(loss, ps)
            with torch.no_grad():
                # bias corrections in float32, as the reference's jit
                c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(t))
                          for b in (b1, b2))
                for p, mm, vv, g in zip(ps, m, v, grads):
                    mm.mul_(b1).add_((1 - b1) * g)
                    vv.mul_(b2).add_((1 - b2) * g * g)
                    p.sub_(lr * (mm / c1) / ((vv / c2).sqrt() + eps))
        self.net = net
        return self

    @property
    def params(self) -> MLPParams:
        """The fitted parameters as numpy, laid out as ``init_params``."""
        return self.net.arrays()

    def _raw(self, X) -> np.ndarray:
        Xs = (np.asarray(X, np.float32) - self.mu) / self.sd
        with torch.no_grad():
            return self.net(torch.as_tensor(Xs, device=self.device)) \
                .cpu().numpy()

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = self._raw(X)
        if self.task == "reg":
            return out[:, 0] * float(self.ysd) + float(self.ymu)
        return out.argmax(1)


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
