"""Shared helpers for the PyTorch-port parity tests (``test_torch_*.py``).

The port may not import ``repro``, so what crosses between the packages
goes through here: the flattener that turns a fitted ``repro`` COMPREDICT
predictor into the plain arrays :func:`repro_torch.convert.predictor_from_arrays`
takes, the one that turns ``repro`` model parameters into the float32
numpy tree :func:`repro_torch.convert.model_params_from_arrays` takes, and
the one for a ``repro`` training state
(:func:`repro_torch.convert.train_state_from_arrays`).
"""

from typing import Dict, List

import numpy as np
import pytest
import torch

from repro.core import ml as jml


def _tree_arrays(tree: jml.DecisionTree) -> Dict[str, np.ndarray]:
    """Preorder flat node arrays of a fitted ``repro`` CART tree."""
    rows: List[list] = []

    def walk(node) -> int:
        nid = len(rows)
        rows.append([-1, 0.0, -1, -1, float(node.value)])
        if node.left is not None:
            left = walk(node.left)
            right = walk(node.right)
            rows[nid][:4] = [int(node.feature), float(node.thresh), left, right]
        return nid

    walk(tree.root)
    cols = list(zip(*rows))
    return {"feature": np.asarray(cols[0], np.int64),
            "thresh": np.asarray(cols[1], np.float64),
            "left": np.asarray(cols[2], np.int64),
            "right": np.asarray(cols[3], np.int64),
            "value": np.asarray(cols[4], np.float64)}


def model_arrays(m) -> Dict[str, object]:
    if isinstance(m, jml.RandomForest):
        return {"model": "RandomForest",
                "trees": [_tree_arrays(t) for t in m.trees]}
    if isinstance(m, jml.KernelRidge):
        return {"model": "SVR", "mu": m.mu, "sd": m.sd, "Xtr": m.Xtr,
                "g": m.g, "coef": m.coef}
    if isinstance(m, jml.Averaging):
        return {"model": "Averaging", "mean": m.mean}
    raise TypeError(type(m).__name__)


def predictor_arrays(pred) -> Dict[tuple, Dict[str, object]]:
    """``{(scheme, layout, target): model arrays}`` of a fitted ``repro``
    ``CompressionPredictor``."""
    return {k: model_arrays(m) for k, m in pred.models.items()}


def model_param_arrays(params):
    """``repro`` ``init_params`` pytree -> the same nesting of dicts and
    tuples with float32 numpy leaves. bfloat16 leaves are cast to float32
    first: numpy holds them as ``ml_dtypes.bfloat16``, which
    ``torch.as_tensor`` refuses."""
    if isinstance(params, dict):
        return {k: model_param_arrays(v) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return tuple(model_param_arrays(v) for v in params)
    return np.asarray(params).astype(np.float32)


def leaf_shapes(tree, prefix=""):
    """``{path: shape}`` of every leaf of a tree of dicts and tuples (numpy
    arrays, jax arrays or tensors)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaf_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaf_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape)}


def train_state_arrays(state):
    """``repro`` train state ``{'params', 'opt': AdamWState}`` -> the
    numpy form :func:`repro_torch.convert.train_state_from_arrays` takes:
    float32 trees, ``step`` an int and ``err`` None or a tree."""
    o = state["opt"]
    return {"params": model_param_arrays(state["params"]),
            "opt": {"step": int(np.asarray(o.step)),
                    "master": model_param_arrays(o.master),
                    "m": model_param_arrays(o.m),
                    "v": model_param_arrays(o.v),
                    "err": None if o.err is None
                    else model_param_arrays(o.err)}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests with one PyTorch CPU thread. Their tensors are
    small, and the suite runs several workers on the same cores, where
    PyTorch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
