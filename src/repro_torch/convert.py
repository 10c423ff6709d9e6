"""Carry a fitted COMPREDICT predictor across as plain numpy arrays.

The placement path's only learned state is the fitted
:class:`~repro_torch.core.compredict.CompressionPredictor`: one regression
model per ``(scheme, layout, target)``. :func:`predictor_from_arrays`
rebuilds it from arrays, so a predictor fitted elsewhere (for example by
the JAX package, whose decompression-speed labels are wall-clock times and
so differ from fit to fit) can be used here unchanged. Each entry of
``arrays`` is a dict with a ``"model"`` key:

* ``"RandomForest"``: ``"trees"``, a list of dicts of flat node arrays
  ``feature``, ``thresh``, ``left``, ``right``, ``value`` (preorder; a
  node is a leaf when ``left < 0``);
* ``"SVR"`` (kernel ridge): ``mu``, ``sd``, ``Xtr``, ``g``, ``coef``;
* ``"Averaging"``: ``mean``.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np

from repro_torch.core import ml
from repro_torch.core.compredict import CompressionPredictor

Key = Tuple[str, str, str]          # (scheme, layout, 'ratio' | 'dspeed')


def model_from_arrays(a: Mapping[str, object]):
    kind = a["model"]
    if kind == "RandomForest":
        rf = ml.RandomForest(n_trees=len(a["trees"]))
        rf.trees = [ml.DecisionTree.from_arrays(
            t["feature"], t["thresh"], t["left"], t["right"], t["value"])
            for t in a["trees"]]
        return rf
    if kind == "SVR":
        kr = ml.KernelRidge()
        kr.mu = np.asarray(a["mu"], np.float64)
        kr.sd = np.asarray(a["sd"], np.float64)
        kr.Xtr = np.asarray(a["Xtr"], np.float64)
        kr.g = float(a["g"])
        kr.coef = np.asarray(a["coef"], np.float64)
        return kr
    if kind == "Averaging":
        avg = ml.Averaging()
        avg.mean = float(a["mean"])
        return avg
    raise ValueError(f"unknown model {kind!r}")


def predictor_from_arrays(arrays: Mapping[Key, Mapping[str, object]], *,
                          feature_kind: str = "weighted_entropy",
                          feature_backend: str = "numpy",
                          ) -> CompressionPredictor:
    """A fitted :class:`CompressionPredictor` from per-key model arrays."""
    kinds = {a["model"] for a in arrays.values()}
    if len(kinds) != 1:
        raise ValueError(f"one model type per predictor, got {sorted(kinds)}")
    pred = CompressionPredictor(feature_kind=feature_kind,
                                model_name=kinds.pop(),
                                feature_backend=feature_backend)
    pred.models = {tuple(k): model_from_arrays(a) for k, a in arrays.items()}
    return pred

