"""Carry learned state across as plain numpy arrays: a fitted COMPREDICT
predictor (:func:`predictor_from_arrays`), model weights
(:func:`model_params_from_arrays`) and a training state
(:func:`train_state_from_arrays`).

The placement path's only learned state is the fitted
:class:`~repro_torch.core.compredict.CompressionPredictor`: one regression
model per ``(scheme, layout, target)``. :func:`predictor_from_arrays`
rebuilds it from arrays, so a predictor fitted elsewhere (for example by
the JAX package, whose decompression-speed labels are wall-clock times and
so differ from fit to fit) can be used here unchanged. Each entry of
``arrays`` is a dict with a ``"model"`` key:

* ``"RandomForest"``: ``"trees"``, a list of dicts of flat node arrays
  ``feature``, ``thresh``, ``left``, ``right``, ``value`` (preorder; a
  node is a leaf when ``left < 0``), plus ``probs`` (n_nodes, n_classes)
  for a classification forest;
* ``"NeuralNetwork"`` (the MLP): ``params``, a list of per-layer dicts
  ``{"w": (in, out), "b": (out,)}`` of float32 arrays, the float32
  standardization ``mu`` and ``sd`` (and ``ymu``, ``ysd`` for
  regression), ``task``, ``n_classes`` and ``hidden``; its network is
  built on ``device``;
* ``"SVR"`` (kernel ridge): ``mu``, ``sd``, ``Xtr``, ``g``, ``coef``;
* ``"Averaging"``: ``mean``.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core import ml
from repro_torch.core.compredict import CompressionPredictor
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.mamba2 import FLOAT32_PARAMS
from repro_torch.training.optimizer import AdamWState

Key = Tuple[str, str, str]          # (scheme, layout, 'ratio' | 'dspeed')


def model_from_arrays(a: Mapping[str, object], device: DeviceLike = "cuda"):
    """One fitted model from its arrays; only ``"NeuralNetwork"`` touches
    ``device``."""
    kind = a["model"]
    if kind == "RandomForest":
        trees = [ml.DecisionTree.from_arrays(
            t["feature"], t["thresh"], t["left"], t["right"], t["value"],
            t.get("probs")) for t in a["trees"]]
        clf = trees[0].probs is not None
        rf = ml.RandomForest(n_trees=len(trees),
                             task="clf" if clf else "reg",
                             n_classes=trees[0].n_classes if clf else 2)
        rf.trees = trees
        return rf
    if kind == "NeuralNetwork":
        mlp = ml.MLP(hidden=tuple(a["hidden"]), task=a["task"],
                     n_classes=int(a["n_classes"]), device=device)
        mlp.net = ml._Net(a["params"], mlp.device)
        mlp.mu = np.asarray(a["mu"], np.float32)
        mlp.sd = np.asarray(a["sd"], np.float32)
        if a["task"] == "reg":
            mlp.ymu = np.float32(a["ymu"])
            mlp.ysd = np.float32(a["ysd"])
        return mlp
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
                          device: DeviceLike = "cuda",
                          ) -> CompressionPredictor:
    """A fitted :class:`CompressionPredictor` from per-key model arrays;
    an ``"NeuralNetwork"`` predictor's MLPs live on ``device``."""
    kinds = {a["model"] for a in arrays.values()}
    if len(kinds) != 1:
        raise ValueError(f"one model type per predictor, got {sorted(kinds)}")
    pred = CompressionPredictor(feature_kind=feature_kind,
                                model_name=kinds.pop(),
                                feature_backend=feature_backend,
                                device=device)
    pred.models = {tuple(k): model_from_arrays(a, device)
                   for k, a in arrays.items()}
    return pred


def model_params_from_arrays(tree: Any, cfg: ModelConfig,
                             device: DeviceLike = "cuda") -> Any:
    """Model parameters for :mod:`repro_torch.models.transformer` from a
    tree of nested dicts and tuples of float32 numpy arrays, laid out as
    ``repro``'s ``init_params`` pytree (stages as tuples of per-unit dicts
    stacked on the repeats axis, ``{}`` for a shared block's slot). Leaves
    are cast to ``cfg.dtype``, except the Mamba2 leaves that are float32 in
    every config (:data:`repro_torch.models.mamba2.FLOAT32_PARAMS`)."""
    dev = resolve(device)
    dt = dtype_of(cfg.dtype)

    def conv(node, name=""):
        if isinstance(node, Mapping):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v, name) for v in node)
        arr = np.asarray(node)
        if arr.dtype != np.float32:
            raise TypeError(f"leaf {name!r}: expected float32, got {arr.dtype}")
        t = torch.as_tensor(arr, device=dev)
        return t if name in FLOAT32_PARAMS else t.to(dt)

    return conv(tree)


def _float32_like(node: Any, ref: Any, dev: torch.device) -> Any:
    """``node`` (nested dicts and tuples of numpy arrays) as float32
    tensors in ``ref``'s structure: dict entries are matched by key, never
    by position (JAX flattens dicts in sorted-key order, the port in
    insertion order)."""
    if isinstance(ref, Mapping):
        if set(node) != set(ref):
            raise KeyError(f"keys {sorted(node)} do not match {sorted(ref)}")
        return {k: _float32_like(node[k], v, dev) for k, v in ref.items()}
    if isinstance(ref, (tuple, list)):
        if len(node) != len(ref):
            raise ValueError(f"{len(node)} entries where {len(ref)} expected")
        return tuple(_float32_like(n, r, dev) for n, r in zip(node, ref))
    arr = np.asarray(node, np.float32)
    if arr.shape != tuple(ref.shape):
        raise ValueError(f"shape {arr.shape} where {tuple(ref.shape)} "
                         f"expected")
    return torch.as_tensor(arr, device=dev).clone()


def train_state_from_arrays(state: Mapping[str, Any], cfg: ModelConfig,
                            device: DeviceLike = "cuda") -> dict:
    """The port's training state ``{'params', 'opt': AdamWState}`` from
    ``repro``'s, as numpy: ``state['params']`` as for
    :func:`model_params_from_arrays`, and ``state['opt']`` a mapping of
    ``repro``'s ``AdamWState`` fields: ``step`` (an int), ``master``,
    ``m``, ``v`` and ``err`` (None or a tree). The optimizer trees are
    float32 and follow the parameters' structure, matched by key."""
    dev = resolve(device)
    params = model_params_from_arrays(state["params"], cfg, device=dev)
    o = state["opt"]
    return {"params": params, "opt": AdamWState(
        torch.tensor(int(o["step"]), dtype=torch.int32, device=dev),
        *(_float32_like(o[k], params, dev) for k in ("master", "m", "v")),
        None if o["err"] is None else _float32_like(o["err"], params, dev))}
