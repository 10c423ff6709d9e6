"""The rest of COMPREDICT's models in the port, against ``repro``:

* classification trees and forests: the same predictions and class
  probabilities;
* the metrics and ``IsotonicCalibrator``: equal within 1e-12;
* the MLP started from the reference's initial parameters: parameters
  within 1e-5 after 1 and 10 full-batch Adam steps (measured: 3.7e-8 and
  1.8e-7 for regression, 7.6e-7 for both in classification); after a
  full fit of 500 steps, regression predictions within rel 1e-4
  (measured 2.0e-7 of the largest) and classification logits within 1e-3
  (measured 1.9e-4) with the same labels; float32 on one CPU thread;
* an ``"NeuralNetwork"`` predictor carried across by ``convert``;
* ``random_samples`` and ``train_eval``: the same samples, and the same
  metrics for the numpy models;
* ``ReactiveLRUCache``, driven as ``tests/test_sla.py`` drives it.
"""

import jax
import numpy as np
import pytest
from _torch_parity import mlp_param_arrays, model_arrays, predictor_arrays

from repro.core import cache as jcache
from repro.core import compredict as jcp
from repro.core import ml as jml
from repro.data import tpch as jtpch
from repro_torch import convert
from repro_torch.core import cache as tcache
from repro_torch.core import compredict as tcp
from repro_torch.core import ml as tml
from repro_torch.data import tpch as ttpch


def _clf_data(seed, n=120, d=6, k=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5).astype(int)
    y = np.minimum(y, k - 1)
    return X, y, rng.normal(size=(40, d))


@pytest.mark.parametrize("k", [2, 3])
def test_classification_tree_matches_repro(k):
    X, y, Xq = _clf_data(0, k=k)
    j = jml.DecisionTree(max_depth=6, task="clf", n_classes=k).fit(X, y)
    t = tml.DecisionTree(max_depth=6, task="clf", n_classes=k).fit(X, y)
    np.testing.assert_array_equal(t.predict(Xq), j.predict(Xq))
    np.testing.assert_array_equal(t.predict_proba(Xq), j.predict_proba(Xq))


@pytest.mark.parametrize("k", [2, 3])
def test_classification_forest_matches_repro(k):
    X, y, Xq = _clf_data(1, k=k)
    j = jml.RandomForest(n_trees=12, max_depth=6, task="clf",
                         n_classes=k, seed=3).fit(X, y)
    t = tml.RandomForest(n_trees=12, max_depth=6, task="clf",
                         n_classes=k, seed=3).fit(X, y)
    np.testing.assert_array_equal(t.predict(Xq), j.predict(Xq))
    np.testing.assert_allclose(t.predict_proba(Xq), j.predict_proba(Xq),
                               rtol=1e-12, atol=1e-12)
    # carried across as arrays
    c = convert.model_from_arrays(model_arrays(j))
    np.testing.assert_allclose(c.predict_proba(Xq), j.predict_proba(Xq),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        tml.RandomForest(task="reg").fit(X, y.astype(float)).predict_proba(Xq)
    with pytest.raises(ValueError):
        tml.RandomForest(task="clf").predict_proba(Xq)


def test_metrics_match_repro():
    rng = np.random.default_rng(2)
    y = rng.integers(0, 2, 200)
    p = rng.integers(0, 2, 200)
    prob = rng.uniform(0, 1, 200)
    assert tml.f1_binary(y, p) == pytest.approx(jml.f1_binary(y, p),
                                                abs=1e-12)
    np.testing.assert_array_equal(tml.confusion(y, p, 2),
                                  jml.confusion(y, p, 2))
    for nb in (5, 10, 17):
        for a, b in zip(tml.reliability_bins(prob, y, nb),
                        jml.reliability_bins(prob, y, nb)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        assert tml.expected_calibration_error(prob, y, nb) == pytest.approx(
            jml.expected_calibration_error(prob, y, nb), abs=1e-12)
    assert tml.expected_calibration_error(np.zeros(0), np.zeros(0)) == 0.0


def test_isotonic_calibrator_matches_repro():
    rng = np.random.default_rng(4)
    s = np.round(rng.uniform(0, 1, 300), 2)      # ties in the scores
    y = (rng.uniform(0, 1, 300) < s ** 2).astype(float)
    j = jml.IsotonicCalibrator().fit(s, y)
    t = tml.IsotonicCalibrator().fit(s, y)
    np.testing.assert_allclose(t.x_, j.x_, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t.v_, j.v_, rtol=1e-12, atol=1e-12)
    q = np.linspace(-0.2, 1.2, 57)
    np.testing.assert_allclose(t.predict(q), j.predict(q), rtol=1e-12,
                               atol=1e-12)
    assert (np.diff(t.predict(np.sort(q))) >= 0).all()
    with pytest.raises(ValueError):
        tml.IsotonicCalibrator().predict(q)
    with pytest.raises(ValueError):
        tml.IsotonicCalibrator().fit([], [])


# ----------------------------------------------------------------------- MLP
def _mlp_data(seed, n=80, d=18):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 20.0, d)
    y = 3.0 + X[:, 0] / 10 + np.sin(X[:, 1]) + 0.1 * rng.normal(size=n)
    yc = (X[:, 0] / 10 + X[:, 2] / 5 > 0).astype(int)
    return X, y, yc, rng.normal(size=(40, d)) * 5.0


def _pair(task, epochs, seed=0):
    X, y, yc, Xq = _mlp_data(seed)
    yy = y if task == "reg" else yc
    out = 1 if task == "reg" else 2
    init = mlp_param_arrays(jml._mlp_init(jax.random.PRNGKey(0),
                                          (X.shape[1], 64, 64, out)))
    j = jml.MLP(hidden=(64, 64), task=task, epochs=epochs).fit(X, yy)
    t = tml.MLP(hidden=(64, 64), task=task, epochs=epochs, init_params=init,
                device="cpu").fit(X, yy)
    return j, t, Xq, init


@pytest.mark.parametrize("task", ["reg", "clf"])
@pytest.mark.parametrize("epochs", [1, 10])
def test_mlp_adam_steps_match_repro(task, epochs):
    j, t, _, init = _pair(task, epochs)
    for a, b in zip(mlp_param_arrays(j.params), t.params):
        for k in ("w", "b"):
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t.mu, j.mu)
    np.testing.assert_array_equal(t.sd, j.sd)
    assert t.mu.dtype == np.float32
    if task == "reg":
        assert (t.ymu, t.ysd) == (j.ymu, j.ysd)
    # the caller's init arrays are not written by training
    again = mlp_param_arrays(jml._mlp_init(jax.random.PRNGKey(0),
                                           tuple(a["w"].shape[0]
                                                 for a in init)
                                           + (init[-1]["w"].shape[1],)))
    for a, b in zip(init, again):
        np.testing.assert_array_equal(a["w"], b["w"])


@pytest.mark.parametrize("task", ["reg", "clf"])
def test_mlp_full_fit_matches_repro(task):
    j, t, Xq, _ = _pair(task, 500, seed=1)
    if task == "reg":
        pj, pt = j.predict(Xq), t.predict(Xq)
        np.testing.assert_allclose(pt, pj, rtol=1e-4,
                                   atol=1e-4 * np.abs(pj).max())
    else:
        np.testing.assert_allclose(t._raw(Xq), j._raw(Xq), rtol=0, atol=1e-3)
        np.testing.assert_array_equal(t.predict(Xq), j.predict(Xq))


def test_mlp_seeded_init_is_reproducible():
    X, y, _, Xq = _mlp_data(2)
    a = tml.MLP(epochs=20, seed=5, device="cpu").fit(X, y).predict(Xq)
    b = tml.MLP(epochs=20, seed=5, device="cpu").fit(X, y).predict(Xq)
    c = tml.MLP(epochs=20, seed=6, device="cpu").fit(X, y).predict(Xq)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


# -------------------------------------------------------- COMPREDICT harness
@pytest.fixture(scope="module")
def tables():
    jdb = jtpch.generate(scale_rows=900, seed=2)
    tdb = ttpch.generate(scale_rows=900, seed=2)
    return jdb, tdb


def test_random_samples_match_repro(tables):
    jdb, tdb = tables
    for name in sorted(jdb.tables):
        js = jcp.random_samples(jdb.tables[name], 5, 120, seed=3)
        ts = tcp.random_samples(tdb.tables[name], 5, 120, seed=3)
        assert len(js) == len(ts) == 5
        for a, b in zip(js, ts):
            assert list(a.columns) == list(b.columns)
            for c in a.columns:
                np.testing.assert_array_equal(b.columns[c], a.columns[c])


def _labeled(pkg, seed=5, n=60, d=18):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    ratio = 1.0 + np.abs(X[:, 0] * 2 + X[:, 1]) + 0.1 * rng.random(n)
    dspeed = 5.0 + np.abs(X[:, 2]) + 0.1 * rng.random(n)
    return pkg.LabeledSet(X, ratio, dspeed, "zlib-6", "col",
                          "weighted_entropy")


@pytest.mark.parametrize("model", ["Averaging", "RandomForest", "SVR"])
@pytest.mark.parametrize("target", ["ratio", "dspeed"])
def test_train_eval_matches_repro_for_numpy_models(model, target):
    _, jr = jcp.train_eval(_labeled(jcp), model, target, seed=4)
    _, tr = tcp.train_eval(_labeled(tcp), model, target, seed=4,
                           device="cpu")
    assert isinstance(tr, tcp.EvalResult)
    assert (tr.model, tr.target) == (jr.model, jr.target)
    for f in ("mae", "mape", "r2"):
        assert getattr(tr, f) == pytest.approx(getattr(jr, f), rel=1e-12,
                                               abs=1e-12), f


def test_train_eval_neural_network_runs_on_the_cpu():
    ds = _labeled(tcp)
    m, r = tcp.train_eval(ds, "NeuralNetwork", "ratio", device="cpu")
    assert isinstance(m, tml.MLP) and m.device.type == "cpu"
    assert np.isfinite([r.mae, r.mape, r.r2]).all()
    # 42 training rows of 18 features: it fits them, whatever it scores
    tr = np.random.default_rng(0).permutation(60)[:42]
    assert tml.r2(ds.ratio[tr], m.predict(ds.X[tr])) > 0.99


def test_neural_network_predictor_carried_across(tables, monkeypatch):
    """An MLP predictor converted from the reference's arrays predicts what
    the reference's does. Decompression speeds are fixed per codec (the
    ratios stay measured): a timed speed puts the host's load into the
    targets, and an outlier there can scale the fitted outputs past what
    a float32 comparison at these tolerances holds."""
    from repro.storage import codecs as jcodecs
    jdb, tdb = tables
    qs = jtpch.generate_queries(jdb, n_per_template=2, seed=3)
    samples = jcp.query_samples(qs, jdb.tables, max_rows=300)
    codecs = [c for c in jcp.default_codecs() if c.name in ("zlib-6", "lzma-1")]
    real = jcp.measure

    def det_measure(codec, raw, repeats=1):
        m = real(codec, raw, repeats=repeats)
        return jcodecs.CodecMeasurement(
            ratio=m.ratio, compress_sec=0.0,
            decompress_sec_per_gb={"zlib-6": 4.0, "lzma-1": 9.0}[codec.name])
    monkeypatch.setattr(jcp, "measure", det_measure)
    jpred = jcp.CompressionPredictor(model_name="NeuralNetwork")
    jpred.fit(samples[:24], layouts=("col",), codecs=codecs)
    tpred = convert.predictor_from_arrays(predictor_arrays(jpred),
                                          device="cpu")
    assert tpred.model_name == "NeuralNetwork"
    assert all(m.device.type == "cpu" for m in tpred.models.values())
    tsamples = tcp.query_samples(
        ttpch.generate_queries(tdb, n_per_template=2, seed=3), tdb.tables,
        max_rows=300)
    schemes = ["none", "zlib-6", "lzma-1"]
    Rj, Dj = jpred.predict_matrix(samples[24:32], schemes, "col")
    Rt, Dt = tpred.predict_matrix(tsamples[24:32], schemes, "col",
                                  device="cpu")
    np.testing.assert_allclose(Rt, Rj, rtol=1e-5)
    np.testing.assert_allclose(Dt, Dj, rtol=1e-5, atol=1e-6)


def test_neural_network_model_is_built_on_the_predictor_device():
    assert tcp.MODELS["NeuralNetwork"]("cpu").epochs == 500
    assert tcp.MODELS["NeuralNetwork"]("cpu").hidden == (64, 64)
    assert tcp.CompressionPredictor(model_name="NeuralNetwork",
                                    device="cpu").device == "cpu"


def test_reactive_lru_matches_repro():
    out = []
    for mod in (jcache, tcache):
        c = mod.ReactiveLRUCache(2.0)
        trace = [c.access(0, 1.0), c.access(0, 1.0), c.access(1, 1.0),
                 c.used_gb, c.access(2, 1.0), c.contains(0), c.contains(1),
                 c.contains(2), c.mask(3).tolist(), c.access(9, 5.0),
                 c.contains(9), c.used_gb]
        rng = np.random.default_rng(0)
        for k, gb in zip(rng.integers(0, 12, 300), rng.uniform(0.1, 1.5, 300)):
            trace.append(c.access(int(k), float(gb)))
        trace += [c.used_gb, c.mask(12).tolist()]
        out.append(trace)
    assert out[0] == out[1]
    assert out[1][:12] == [False, True, False, 2.0, False, False, True, True,
                           [False, True, True], False, False, 2.0]
