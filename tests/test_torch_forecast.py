"""The port's access forecasting against ``repro``'s, on seeded traces.

* ``data/workloads.py``: ``generate_workload``, ``feature_matrix``,
  ``monthly_query_log`` and ``stream_query_log`` give identical arrays;
* ``core/access_predict.py``: ``optimal_tiers`` (labels and errors) and
  ``train_tier_predictor`` (identical predictions, confusion and F1);
* ``core/forecast.py``: ``clamp_rho``, ``linear_trend_forecast`` and
  ``AccessForecaster`` — ``fit``, ``maybe_refit``, ``forecast_rho`` and
  ``stream_forecast_fn``, called directly — with identical outputs
  (float64, exact).

The port's labels take their greedy argmin on ``device="cpu"`` here.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import access_predict as jap
from repro.core import costs as jcosts
from repro.core import forecast as jfc
from repro.data import workloads as jwl
from repro_torch.core import access_predict as tap
from repro_torch.core import costs as tcosts
from repro_torch.core import forecast as tfc
from repro_torch.data import workloads as twl

SPIKY = {"decreasing": 0.2, "constant": 0.1, "periodic": 0.35,
         "spike": 0.15, "cold": 0.2}
CPU = {"device": "cpu"}


def _workloads(n=60, months=18, seed=7, **kw):
    return (jwl.generate_workload(n_datasets=n, n_months=months, seed=seed,
                                  **kw),
            twl.generate_workload(n_datasets=n, n_months=months, seed=seed,
                                  **kw))


def _forecasters(n=60, months=18, wseed=7, fit_month=12, **kw):
    kw.setdefault("n_trees", 10)
    wj, wt = _workloads(n, months, wseed, pattern_probs=SPIKY)
    fj = jfc.AccessForecaster(jcosts.azure_table(), tiers=(1, 2), horizon=2,
                              history=4, **kw)
    ft = tfc.AccessForecaster(tcosts.azure_table(), tiers=(1, 2), horizon=2,
                              history=4, device="cpu", **kw)
    rj, rt = fj.fit(wj, fit_month=fit_month), ft.fit(wt, fit_month=fit_month)
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    return (fj, wj), (ft, wt)


# ----------------------------------------------------------------- workloads
@pytest.mark.parametrize("kw", [
    dict(n=50, months=12, seed=0),
    dict(n=80, months=24, seed=7, size_lognorm=(4.5, 2.0)),
    dict(n=40, months=16, seed=11, pattern_probs=SPIKY)])
def test_workload_arrays_match_repro(kw):
    n, months, seed = kw.pop("n"), kw.pop("months"), kw.pop("seed")
    wj, wt = _workloads(n, months, seed, **kw)
    assert wt.n_months == wj.n_months
    for a, b in zip(wt.datasets, wj.datasets):
        assert (a.name, a.size_gb, a.created_month, a.pattern) == \
            (b.name, b.size_gb, b.created_month, b.pattern)
        np.testing.assert_array_equal(a.reads, b.reads)
        np.testing.assert_array_equal(a.writes, b.writes)
    for m in (-2, 0, 1, months // 2, months, months + 3):
        np.testing.assert_array_equal(twl.feature_matrix(wt, m, 4),
                                      jwl.feature_matrix(wj, m, 4))
    np.testing.assert_array_equal(wt.reads_in(2, 7), wj.reads_in(2, 7))
    assert twl.dataset_file_sizes(wt) == jwl.dataset_file_sizes(wj)
    assert twl.monthly_query_log(wt, months // 2, np.random.default_rng(3)) \
        == jwl.monthly_query_log(wj, months // 2, np.random.default_rng(3))
    assert list(twl.stream_query_log(wt, np.random.default_rng(5))) \
        == list(jwl.stream_query_log(wj, np.random.default_rng(5)))
    with pytest.raises(ValueError):
        twl.feature_matrix(wt, 3, -1)


# ------------------------------------------------------------ access_predict
@pytest.mark.parametrize("window,tiers", [((4, 8), (1, 2)), ((0, 3), (0, 1, 2)),
                                          ((6, 10), (1, 2, 3))])
def test_optimal_tiers_match_repro(window, tiers):
    wj, wt = _workloads(30, 10)
    a = tap.optimal_tiers(wt, tcosts.azure_table(), *window, tiers, **CPU)
    b = jap.optimal_tiers(wj, jcosts.azure_table(), *window, tiers)
    np.testing.assert_array_equal(a, b)
    assert set(a.tolist()) <= set(tiers)


@pytest.mark.parametrize("lo,hi,match", [(5, 5, "non-empty"),
                                         (6, 4, "non-empty"),
                                         (6, 9, "outside"),
                                         (-1, 3, "outside")])
def test_optimal_tiers_rejects_degenerate_windows(lo, hi, match):
    _, wt = _workloads(10, 8)
    with pytest.raises(ValueError, match=match):
        tap.optimal_tiers(wt, tcosts.azure_table(), lo, hi, (1, 2), **CPU)


@pytest.mark.parametrize("train_month,horizon,tiers", [
    (12, 2, (1, 2)), (8, 3, (1, 2, 3))])
def test_train_tier_predictor_matches_repro(train_month, horizon, tiers):
    wj, wt = _workloads(120, 20, seed=5, size_lognorm=(4.5, 2.0))
    cj, rj = jap.train_tier_predictor(wj, jcosts.azure_table(), train_month,
                                      horizon, tiers)
    ct, rt = tap.train_tier_predictor(wt, tcosts.azure_table(), train_month,
                                      horizon, tiers, **CPU)
    np.testing.assert_array_equal(rt.confusion, rj.confusion)
    assert (rt.f1, rt.accuracy, rt.label_names) == \
        (rj.f1, rj.accuracy, rj.label_names)
    m = train_month + horizon
    np.testing.assert_array_equal(ct.predict(twl.feature_matrix(wt, m)),
                                  cj.predict(jwl.feature_matrix(wj, m)))
    np.testing.assert_array_equal(
        tap.predicted_tiers(ct, wt, m, tiers),
        jap.predicted_tiers(cj, wj, m, tiers))


@pytest.mark.parametrize("t,h,match", [(8, 2, "train_month \\+ horizon"),
                                       (9, 2, "train_month \\+ horizon"),
                                       (4, 0, "horizon"),
                                       (-1, 2, "train_month")])
def test_train_tier_predictor_validates_window(t, h, match):
    _, wt = _workloads(12, 10)
    with pytest.raises(ValueError, match=match):
        tap.train_tier_predictor(wt, tcosts.azure_table(), train_month=t,
                                 horizon=h, **CPU)


# -------------------------------------------------------------- sanity layer
@pytest.mark.parametrize("args,kw", [
    ((-3.0,), {}), ((np.nan,), {}), ((np.inf,), dict(hi=5.0)), ((2.0,), {}),
    ((np.array([2.0, -1.0, np.nan]),), dict(hi=1.5)),
    ((np.array([5.0, 5.0]),), dict(hi=np.array([3.0, 10.0]))),
    ((np.array([0.5, 7.0]),), dict(lo=1.0))])
def test_clamp_rho_matches_repro(args, kw):
    a, b = tfc.clamp_rho(*args, **kw), jfc.clamp_rho(*args, **kw)
    assert type(a) is type(b)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hist,kw", [
    ([3.0], {}), ([-5.0], {}), ([2.0, 2.0, 2.0], {}), ([9.0, 3.0, 0.1], {}),
    ([1.0, np.nan], {}), ([1.0, 4.0, 2.0, 8.0], dict(horizon=2.5)),
    ([np.array([4.0, 1.0]), np.array([1.0, 2.0])], {}),
    ([np.array([4.0, 1.0, 3.0]), np.array([1.0, 2.0, 3.0]),
      np.array([0.5, 6.0, 3.0])], dict(clip_min=0.25))])
def test_linear_trend_forecast_matches_repro(hist, kw):
    np.testing.assert_array_equal(tfc.linear_trend_forecast(hist, **kw),
                                  jfc.linear_trend_forecast(hist, **kw))
    with pytest.raises(ValueError):
        tfc.linear_trend_forecast([])


# --------------------------------------------------------- AccessForecaster
def test_forecaster_fit_matches_repro_and_is_out_of_time():
    (fj, wj), (ft, wt) = _forecasters()
    rep = ft.fit_report
    assert all(hi <= rep.fit_month for _, hi in rep.label_windows)
    assert min(rep.cal_months) > max(rep.train_months)
    X = twl.feature_matrix(wt, 13, 4)
    np.testing.assert_array_equal(ft.predict_p_hot(X), fj.predict_p_hot(X))
    assert (ft.hot_rho_, ft.med_size_gb_) == (fj.hot_rho_, fj.med_size_gb_)
    with pytest.raises(ValueError, match="beyond the trace"):
        ft.fit(wt, fit_month=99)
    with pytest.raises(ValueError, match="usable train months"):
        ft.fit(wt, fit_month=3)


def test_forecaster_calibration_matches_repro():
    (fj, _), (ft, wt) = _forecasters(120, 20, wseed=5, n_trees=16, seed=1)
    rep = ft.fit_report
    assert rep.calibrated and rep.ece_cal <= rep.ece_raw + 0.05
    p = ft.predict_p_hot(twl.feature_matrix(wt, 13, 4))
    assert p.min() >= 0.0 and p.max() <= 1.0


@pytest.mark.parametrize("refit_every", [0, 3])
def test_forecast_rho_and_refits_match_repro(refit_every):
    """Batch mode, bound to the workload: each cycle's projection is
    identical, and the refit cadence fires at the same months."""
    (fj, wj), (ft, wt) = _forecasters(refit_every=refit_every)
    for f in (fj, ft):
        f.bind(month0=11)
    hist = [np.array([d.reads[m] for d in wj.datasets], float)
            for m in range(11, 18)]
    for t in range(1, len(hist) + 1):
        np.testing.assert_array_equal(ft.forecast_rho(hist[:t]),
                                      fj.forecast_rho(hist[:t]))
        np.testing.assert_array_equal(ft.last_p_hot_, fj.last_p_hot_)
    assert ft.refits_ == fj.refits_
    assert bool(ft.refits_) == bool(refit_every)
    assert dataclasses.asdict(ft.fit_report) == \
        dataclasses.asdict(fj.fit_report)


def test_maybe_refit_matches_repro():
    (fj, _), (ft, _) = _forecasters(refit_every=2)
    for at in (12, 13, 14, 15, 18, 30):
        assert ft.maybe_refit(at) == fj.maybe_refit(at)
    assert ft.refits_ == fj.refits_ and ft.refits_


def test_unbound_forecast_and_untrained_fallback_match_repro():
    (fj, _), (ft, _) = _forecasters()
    hist = [np.array([5.0, 1.0, 30.0]), np.array([7.0, 0.5, 0.0]),
            np.array([2.0, 0.0, 90.0])]
    for f in (fj, ft):
        f.bind(month0=3)
    np.testing.assert_array_equal(ft.forecast_rho(hist),
                                  fj.forecast_rho(hist))
    assert ft.forecast_rho([4.0, 6.0]) == fj.forecast_rho([4.0, 6.0])
    bare = [m.AccessForecaster(c.azure_table(), horizon=2, history=4, **kw)
            for m, c, kw in ((jfc, jcosts, {}), (tfc, tcosts, CPU))]
    out = [f.forecast_rho([np.array([5.0, 1.0]), np.array([7.0, 0.5])])
           for f in bare]
    np.testing.assert_array_equal(out[1], out[0])
    np.testing.assert_allclose(out[1], [9.0, 0.0])


def test_stream_forecast_fn_matches_repro():
    (fj, _), (ft, _) = _forecasters()
    fns = [fj.stream_forecast_fn(), ft.stream_forecast_fn()]
    assert all(getattr(f, "stream_context", False) for f in fns)
    calls = [([3.0], "a", 12.0), ([3.0, 9.0], "a", 12.0),
             ([0.0, 0.0, 1.0], "b", None), ([40.0, 2.0, 60.0, 1.0], "a", 0.5),
             ([7.0], None, 300.0)]
    for hist, key, span in calls:
        assert fns[1](hist, key=key, span_gb=span) == \
            fns[0](hist, key=key, span_gb=span)
    with pytest.raises(ValueError):
        fns[1]([])


@pytest.mark.parametrize("kw", [dict(tiers=(2, 1)), dict(tiers=(1,)),
                                dict(horizon=0), dict(spike_mult=0.5)])
def test_forecaster_rejects_bad_parameters(kw):
    with pytest.raises(ValueError):
        tfc.AccessForecaster(tcosts.azure_table(), device="cpu", **kw)
