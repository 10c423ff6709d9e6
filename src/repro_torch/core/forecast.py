"""Calibrated access forecasting — closing the paper's §IV-C loop.

The paper trains a RandomForest that maps per-dataset features (size, age,
recent monthly read/write aggregates) to the *OPTASSIGN-optimal tier* on
the future access window ("We used OPTASSIGN to assign the ground truth
label encoding (i.e. the optimal tier) for each dataset while training").
:class:`AccessForecaster` packages that model as a daemon-compatible
``forecast_fn``: instead of reacting to last month's observed rho, the
re-optimization daemon places partitions against
a *projected* rho, pre-warming them before a predicted spike lands.

Three layers keep the projection trustworthy enough to feed straight into
the ``budgeted_moves`` knapsack and min-stay deferral math:

1. **model** — the §IV-C forest, fitted out-of-time on
   :func:`~repro_torch.data.workloads.feature_matrix` rows with
   :func:`~repro_torch.core.access_predict.optimal_tiers` labels computed on the
   future window ``[t, t+horizon)``;
2. **reliability** — an :class:`~repro_torch.core.ml.IsotonicCalibrator` fitted
   on a held-out *later* slice of training months, so the forest's vote
   fraction for the hot tier becomes an empirical probability. The
   projection is then the calibrated expectation
   ``(1-p)·trend + p·max(trend, hot-level)``, which is exactly the rho
   under which the cost optimizer makes the expected-cost-optimal call;
3. **sanity** — :func:`clamp_rho`: forecasts are forced finite and
   non-negative and capped at ``spike_mult`` times the larger of the
   partition's own historical peak and the fleet-wide hot level, so an
   uncalibrated tree can never trigger phantom migrations.

The module owns the *shared sanity layer* of every forecasting path:
:func:`clamp_rho` and :func:`linear_trend_forecast` live here; the
reference's ``core/daemon.py`` re-exports them (its default building
block), and so does the port's (:mod:`repro_torch.core.daemon`).

Port of ``repro.core.forecast``: the labels' greedy argmin runs on the
forecaster's ``device`` (default ``"cuda"``), the forest, the calibrator
and the projection on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ml
from repro_torch.core.access_predict import optimal_tiers
from repro_torch.core.costs import CostTable
from repro_torch.data.workloads import Workload, feature_matrix
from repro_torch.device import DeviceLike, resolve


# ------------------------------------------------------------- sanity layer
def clamp_rho(rho, lo: float = 0.0, hi=None):
    """Sanity-clamp projected access rates before they reach the cost
    model: non-finite values collapse to ``lo``, everything is bounded
    below by ``lo`` (negative rho would flow into ``cost_tensor`` as
    negative access cost) and optionally above by ``hi`` (the bounded
    spike multiplier). Scalars in, float out; arrays in, array out."""
    r = np.asarray(rho, np.float64)
    r = np.where(np.isfinite(r), r, lo)
    r = np.maximum(r, lo)
    if hi is not None:
        r = np.minimum(r, np.asarray(hi, np.float64))
    return float(r) if r.ndim == 0 else r


def linear_trend_forecast(history: Sequence, horizon: float = 1.0,
                          clip_min: float = 0.0):
    """Least-squares linear trend over a rho history, extrapolated
    ``horizon`` cycles ahead (clamped non-negative).

    ``history`` is a sequence of per-cycle observations — scalars in
    streaming mode (one partition's rho per cycle), (N,) vectors in batch
    mode. The default daemon ``forecast_fn`` building block; swap in an
    :class:`AccessForecaster` for feature-driven projection.

    Every return path goes through :func:`clamp_rho`: a single-entry or
    all-constant history returns the last value clamped at ``clip_min``,
    and a steep negative trend clamps to ``clip_min`` instead of
    extrapolating below zero.
    """
    h = np.asarray(history, np.float64)
    T = h.shape[0]
    if T == 0:
        raise ValueError("cannot forecast from an empty history")
    if T < 2:
        return clamp_rho(h[-1], lo=clip_min)
    t = np.arange(T, dtype=np.float64)
    tm = t.mean()
    ctr = (t - tm).reshape((T,) + (1,) * (h.ndim - 1))
    slope = (ctr * (h - h.mean(0))).sum(0) / (ctr * ctr).sum()
    return clamp_rho(h[-1] + horizon * slope, lo=clip_min)


# ------------------------------------------------------------- fit report
@dataclasses.dataclass
class ForecastFitReport:
    """What one :meth:`AccessForecaster.fit` call trained and measured.

    ``label_windows`` records every ``[lo, hi)`` month window whose reads
    produced a training/calibration label — the out-of-time contract is
    ``hi <= fit_month`` for all of them (pinned by tests).
    """

    fit_month: int
    train_months: Tuple[int, ...]
    cal_months: Tuple[int, ...]
    label_windows: Tuple[Tuple[int, int], ...]
    n_rows: int
    accuracy: float          # hot-vs-rest accuracy on the calibration slice
    ece_raw: float           # calibration error of raw forest votes
    ece_cal: float           # ... after the isotonic reliability layer
    hot_rho: float           # fleet-wide hot-level rho (median hot future)
    calibrated: bool


class AccessForecaster:
    """Paper-§IV-C access forecaster packaged as a daemon ``forecast_fn``.

    Usage (batch mode)::

        fc = AccessForecaster(table, horizon=2, history=4)
        fc.fit(workload, fit_month=12)       # out-of-time: labels < month 12
        fc.bind(month0=11)                   # month of the first observation
        daemon = ReoptimizationDaemon(engine, plan=plan0,
                                      forecast_fn=fc.forecast_rho)

    ``forecast_rho(history)`` receives the daemon's rolling window of
    observed (N,) rho vectors and returns the projected (N,) rho for the
    coming cycle. When constructed with ``refit_every=k``, every k-th
    forecast cycle refits the forest out-of-time on everything observed so
    far (recorded in ``refits_``). Streaming mode uses
    :meth:`stream_forecast_fn` (per-partition scalar histories keyed by
    file-set identity, sizes via the daemon's context protocol); fleet
    mode passes one bound forecaster per tenant as a ``forecast_fn`` list.

    ``tiers`` must be sorted hottest-first (ascending tier index); the
    calibrated probability is for ``tiers[0]``, the hot class. The labels'
    greedy argmin runs on ``device`` (default ``"cuda"``; asking for the
    card where there is none raises here).
    """

    def __init__(self, table: CostTable, *, tiers: Sequence[int] = (1, 2),
                 horizon: int = 2, history: int = 4, n_trees: int = 24,
                 max_depth: int = 10, seed: int = 0,
                 spike_mult: float = 8.0, refit_every: int = 0,
                 cal_frac: float = 0.25, min_cal_rows: int = 20,
                 device: DeviceLike = "cuda"):
        self.device = resolve(device)
        tiers = tuple(int(t) for t in tiers)
        if len(tiers) < 2 or list(tiers) != sorted(set(tiers)):
            raise ValueError(f"tiers must be >= 2 distinct indices sorted "
                             f"hottest-first, got {tiers}")
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1 month, got {horizon}")
        if spike_mult < 1.0:
            raise ValueError(f"spike_mult < 1 would cap forecasts below "
                             f"the observed peak, got {spike_mult}")
        self.table = table
        self.tiers = tiers
        self.horizon = int(horizon)
        self.history = int(history)
        self.n_trees, self.max_depth, self.seed = n_trees, max_depth, seed
        self.spike_mult = float(spike_mult)
        self.refit_every = int(refit_every)
        self.cal_frac = float(cal_frac)
        self.min_cal_rows = int(min_cal_rows)

        self.model: Optional[ml.RandomForest] = None
        self.calibrator: Optional[ml.IsotonicCalibrator] = None
        self.fit_report: Optional[ForecastFitReport] = None
        self.hot_rho_ = 0.0          # fleet-wide hot level (rho / month)
        self.med_size_gb_ = 1.0      # imputation when size is unknown
        self.refits_: List[int] = []
        self._w: Optional[Workload] = None
        self._fit_month = -1
        self.month0 = 0
        self._calls = 0

    # -------------------------------------------------------------- fitting
    def fit(self, w: Workload, *, fit_month: Optional[int] = None,
            ) -> ForecastFitReport:
        """Fit forest + reliability layer on months strictly before
        ``fit_month`` (default: the whole trace).

        Rows are (feature_matrix at t, optimal tier on [t, t+horizon))
        pairs over every usable month t; the *latest* ``cal_frac`` of those
        months is held out (out-of-time) to fit the isotonic calibrator
        and measure reliability, the rest trains the forest.
        """
        fit_month = w.n_months if fit_month is None else int(fit_month)
        if fit_month > w.n_months:
            raise ValueError(f"fit_month {fit_month} beyond the trace "
                             f"({w.n_months} months)")
        months = list(range(1, fit_month - self.horizon + 1))
        if len(months) < 2:
            raise ValueError(
                f"need >= 2 usable train months (1 <= t <= fit_month - "
                f"horizon = {fit_month - self.horizon}) to fit out-of-time")
        n_cal = max(1, int(round(self.cal_frac * len(months))))
        n_cal = min(n_cal, len(months) - 1)
        train_months, cal_months = months[:-n_cal], months[-n_cal:]

        t2c = {t: i for i, t in enumerate(self.tiers)}

        def rows(ms):
            X, c, fut = [], [], []
            for t in ms:
                X.append(feature_matrix(w, t, self.history))
                lab = optimal_tiers(w, self.table, t, t + self.horizon,
                                    self.tiers, device=self.device)
                c.append(np.array([t2c[v] for v in lab]))
                fut.append(w.reads_in(t, t + self.horizon)
                           / float(self.horizon))
            return np.vstack(X), np.concatenate(c), np.concatenate(fut)

        X_tr, c_tr, fut_tr = rows(train_months)
        X_cal, c_cal, fut_cal = rows(cal_months)

        clf = ml.RandomForest(n_trees=self.n_trees, max_depth=self.max_depth,
                              task="clf", n_classes=len(self.tiers),
                              seed=self.seed)
        clf.fit(X_tr, c_tr)
        raw = clf.predict_proba(X_cal)[:, 0]
        y_hot = (c_cal == 0).astype(float)
        calibrated = bool(len(y_hot) >= self.min_cal_rows
                          and 0.0 < y_hot.mean() < 1.0)
        cal = ml.IsotonicCalibrator().fit(raw, y_hot) if calibrated else None
        p_cal = cal.predict(raw) if cal is not None else raw

        # fleet-wide hot level: an upper-quartile future monthly rho of rows
        # the oracle labeled hot — the magnitude a predicted-hot partition is
        # pre-warmed toward when its own history has never spiked. P75 rather
        # than the median: with a calibrated-but-modest p, a median anchor
        # leaves the expected-cost projection just under the hot break-even
        # for exactly the spike onsets pre-warming exists for.
        fut_all = np.concatenate([fut_tr, fut_cal])
        hot_all = np.concatenate([c_tr, c_cal]) == 0
        self.hot_rho_ = float(np.percentile(fut_all[hot_all], 75)
                              if hot_all.any() else np.median(fut_all))
        self.med_size_gb_ = float(np.median(
            [d.size_gb for d in w.datasets])) if w.datasets else 1.0

        self.model, self.calibrator = clf, cal
        self._w, self._fit_month = w, fit_month
        wins = tuple((t, t + self.horizon) for t in months)
        self.fit_report = ForecastFitReport(
            fit_month=fit_month,
            train_months=tuple(train_months), cal_months=tuple(cal_months),
            label_windows=wins, n_rows=len(c_tr) + len(c_cal),
            accuracy=float(((raw >= 0.5) == (y_hot >= 0.5)).mean()),
            ece_raw=ml.expected_calibration_error(raw, y_hot),
            ece_cal=ml.expected_calibration_error(p_cal, y_hot),
            hot_rho=self.hot_rho_, calibrated=calibrated)
        return self.fit_report

    def bind(self, w: Optional[Workload] = None,
             month0: Optional[int] = None) -> "AccessForecaster":
        """Anchor the forecaster's clock: ``month0`` is the workload month
        of the FIRST observation the daemon will feed it (so the t-th
        forecast call targets month ``month0 + t``). Resets the cycle
        counter; optionally rebinds the workload used for size/age/write
        features and refits."""
        if w is not None:
            self._w = w
        if month0 is not None:
            self.month0 = int(month0)
        self._calls = 0
        return self

    def maybe_refit(self, at_month: int) -> bool:
        """Refit out-of-time at ``at_month`` if the refit cadence says so:
        only label windows ending <= at_month are used, so the daemon
        never trains on months it has not yet observed."""
        if self.refit_every <= 0 or self._w is None:
            return False
        if at_month - self._fit_month < self.refit_every:
            return False
        fm = min(int(at_month), self._w.n_months)
        if fm == self._fit_month or fm - self.horizon < 2:
            return False
        self.fit(self._w, fit_month=fm)
        self.refits_.append(fm)
        return True

    # ----------------------------------------------------------- projection
    def predict_p_hot(self, X: np.ndarray) -> np.ndarray:
        """Calibrated P(hot tier is cost-optimal on the coming window)."""
        if self.model is None:
            return np.zeros(len(X))
        raw = self.model.predict_proba(np.asarray(X, float))[:, 0]
        return (self.calibrator.predict(raw)
                if self.calibrator is not None else raw)

    def _project(self, reads_win: np.ndarray, base: np.ndarray,
                 hist_max: np.ndarray, sizes: np.ndarray, ages: np.ndarray,
                 writes_win: np.ndarray) -> np.ndarray:
        """The calibrated-expectation projection with the sanity clamp.
        ``reads_win``/``writes_win`` are (history, N); the rest (N,)."""
        X = np.concatenate([np.log1p(sizes)[:, None], ages[:, None],
                            reads_win.T, writes_win.T], axis=1)
        p = self.predict_p_hot(X)
        # stash for serving-cache admission: forecast_admission(...,
        # p_hot=fc.last_p_hot_) gates the cache on the calibrated
        # probability behind the projection just returned
        self.last_p_hot_ = p
        hot_level = np.maximum(hist_max, self.hot_rho_)
        proj = (1.0 - p) * base + p * np.maximum(base, hot_level)
        cap = self.spike_mult * np.maximum(hist_max, self.hot_rho_)
        return clamp_rho(proj, 0.0, cap)

    def _pad_window(self, arr: np.ndarray) -> np.ndarray:
        """Last ``history`` rows of a (T, N) series, zero-padded on the
        left — months before the first observation carry no accesses."""
        T, N = arr.shape
        if T >= self.history:
            return arr[T - self.history:]
        return np.vstack([np.zeros((self.history - T, N)), arr])

    def forecast_rho(self, history: Sequence) -> np.ndarray:
        """Daemon-compatible ``forecast_fn``: the rolling window of
        observed rho (scalars, or (N,) vectors in batch mode) in, the
        projected rho for the coming cycle out.

        Stateful: each call advances the forecaster's month clock by one
        cycle (the daemon calls it exactly once per cycle; re-anchor with
        :meth:`bind` before reuse). The daemon's ``forecast_window`` should
        be >= ``history`` so the feature window is fully populated.
        """
        if len(history) == 0:
            raise ValueError("cannot forecast from an empty history")
        self._calls += 1
        at = self.month0 + self._calls
        self.maybe_refit(at)

        h = [np.atleast_1d(np.asarray(x, np.float64)) for x in history]
        scalar = all(x.ndim == 1 and x.shape[0] == 1 for x in h) \
            and np.ndim(history[-1]) == 0
        arr = np.stack(h)                        # (T, N)
        N = arr.shape[1]
        base = np.atleast_1d(np.asarray(
            linear_trend_forecast(arr), np.float64))
        hist_max = arr.max(axis=0)
        reads_win = self._pad_window(arr)

        w = self._w
        if w is not None and N == len(w.datasets):
            # bound batch mode: the workload IS the observation record for
            # months < at, so take the feature window and the historical
            # peak from it — the daemon's rolling window starts empty at
            # month0 and would zero-pad away the previous spike (no
            # leakage: strictly-past months only, same rows training used)
            at_w = min(at, w.n_months)
            lo = max(at_w - self.history, 0)
            reads_win = self._pad_window(
                np.stack([d.reads[lo:at_w] for d in w.datasets], axis=1))
            hist_max = np.maximum(
                hist_max,
                np.array([float(d.reads[:at_w].max()) if at_w else 0.0
                          for d in w.datasets]))
            sizes = np.array([d.size_gb for d in w.datasets])
            ages = np.array([float(d.age_at(at)) for d in w.datasets])
            wr = np.stack([d.writes[lo:at_w] for d in w.datasets], axis=1)
            writes_win = self._pad_window(wr)
        else:
            sizes = np.full(N, self.med_size_gb_)
            ages = np.full(N, float(len(h)))
            writes_win = np.zeros((self.history, N))

        out = self._project(reads_win, base, hist_max, sizes, ages,
                            writes_win)
        return float(out[0]) if scalar else out

    __call__ = forecast_rho

    def stream_forecast_fn(self) -> Callable:
        """A streaming-mode ``forecast_fn``: per-partition scalar
        histories, keyed by file-set identity. Opts into the daemon's
        context protocol (``stream_context = True``) so each call receives
        ``key=`` (the partition's file-set key — ages survive
        re-partitioning exactly like the daemon's own deferral ages) and
        ``span_gb=`` (the partition's stored size, the paper's strongest
        feature). Write aggregates are unobservable on the query stream
        and imputed as zero."""
        ages: Dict = {}

        def fn(history, key=None, span_gb=None):
            if len(history) == 0:
                raise ValueError("cannot forecast from an empty history")
            if key is not None:
                ages[key] = ages.get(key, 0) + 1
            age = float(ages.get(key, len(history)))
            arr = np.asarray(list(history), np.float64)[:, None]   # (T, 1)
            base = np.atleast_1d(np.asarray(
                linear_trend_forecast(arr), np.float64))
            out = self._project(
                self._pad_window(arr), base, arr.max(axis=0),
                np.array([float(span_gb) if span_gb else
                          self.med_size_gb_]),
                np.array([age]), np.zeros((self.history, 1)))
            return float(out[0])

        fn.stream_context = True
        return fn
