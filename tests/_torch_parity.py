"""Shared helpers for the PyTorch-port parity tests (``test_torch_*.py``).

The port may not import ``repro``, so what crosses between the packages
goes through here: the flattener that turns a fitted ``repro`` COMPREDICT
predictor into the plain arrays :func:`repro_torch.convert.predictor_from_arrays`
takes.
"""

from typing import Dict, List

import numpy as np

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
