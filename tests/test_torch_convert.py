"""Carrying a fitted COMPREDICT predictor from ``repro`` into the port:
``convert.predictor_from_arrays`` reproduces ``repro``'s RandomForest, SVR
and Averaging predictions to 1e-12, and the port's own models fit to the
same predictions as ``repro``'s on the same data."""

import numpy as np
import pytest
from _torch_parity import model_arrays, predictor_arrays

from repro.core import compredict as jcp
from repro.core import ml as jml
from repro.data import tpch as jtpch
from repro_torch import convert
from repro_torch.core import ml as tml
from repro_torch.data.tables import Table

MODELS = {
    "RandomForest": (lambda: jml.RandomForest(n_trees=8, max_depth=6),
                     lambda: tml.RandomForest(n_trees=8, max_depth=6)),
    "SVR": (lambda: jml.KernelRidge(alpha=1e-2),
            lambda: tml.KernelRidge(alpha=1e-2)),
    "Averaging": (jml.Averaging, tml.Averaging),
}


def _data(seed, n=60, d=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = X[:, 0] * 2.0 - np.abs(X[:, 1]) + 0.1 * rng.normal(size=n)
    return X, y, rng.normal(size=(25, d))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_from_arrays_reproduces_repro(name):
    X, y, Xq = _data(0)
    jm = MODELS[name][0]().fit(X, y)
    tm = convert.model_from_arrays(model_arrays(jm))
    np.testing.assert_allclose(tm.predict(Xq), jm.predict(Xq),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_models_fit_like_repro(name):
    X, y, Xq = _data(1)
    jm = MODELS[name][0]().fit(X, y)
    tm = MODELS[name][1]().fit(X, y)
    np.testing.assert_allclose(tm.predict(Xq), jm.predict(Xq),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("model_name", ["RandomForest", "SVR", "Averaging"])
def test_predictor_from_arrays_reproduces_predict_matrix(model_name):
    db = jtpch.generate(scale_rows=900, seed=2)
    qs = jtpch.generate_queries(db, n_per_template=2, seed=3)
    samples = jcp.query_samples(qs, db.tables, max_rows=300)
    jpred = jcp.CompressionPredictor(model_name=model_name)
    jpred.fit(samples[:24], layouts=("col",))
    tpred = convert.predictor_from_arrays(predictor_arrays(jpred))
    assert tpred.model_name == model_name
    parts = samples[24:30]
    schemes = ["none"] + sorted({k[0] for k in jpred.models})
    jR, jD = jpred.predict_matrix(parts, schemes, "col")
    tR, tD = tpred.predict_matrix(
        [Table(t.name, dict(t.columns)) for t in parts], schemes, "col",
        device="cpu")
    np.testing.assert_allclose(tR, jR, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tD, jD, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("arrays", [
    {("zlib-1", "col", "ratio"): {"model": "MLP"}},
    {("zlib-1", "col", "ratio"): {"model": "Averaging", "mean": 2.0},
     ("zlib-1", "col", "dspeed"): {"model": "SVR"}},
])
def test_predictor_from_arrays_rejects_unknown_or_mixed_models(arrays):
    with pytest.raises(ValueError):
        convert.predictor_from_arrays(arrays)
