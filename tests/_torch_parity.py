"""Shared helpers for the PyTorch-port parity tests (``test_torch_*.py``).

The port may not import ``repro``, so what crosses between the packages
goes through here: the flattener that turns a fitted ``repro`` COMPREDICT
predictor into the plain arrays :func:`repro_torch.convert.predictor_from_arrays`
takes, the one that turns a ``repro`` MLP's pytree into per-layer numpy
(:func:`mlp_param_arrays`), the one that turns ``repro`` model parameters
into the float32 numpy tree :func:`repro_torch.convert.model_params_from_arrays` takes, and
the one for a ``repro`` training state
(:func:`repro_torch.convert.train_state_from_arrays`), and the shared
fixtures of the daemon and migrator tests: real-payload placement problems
(:func:`payload_plans`), a small stream with payloads
(:func:`stream_engines`) and the store signatures they compare.
"""

from typing import Dict, List

import numpy as np
import pytest
import torch

from repro.core import ml as jml


def _tree_arrays(tree: jml.DecisionTree) -> Dict[str, np.ndarray]:
    """Preorder flat node arrays of a fitted ``repro`` CART tree, with
    ``probs`` (zeros at inner nodes) for a classification tree."""
    rows: List[list] = []
    clf = tree.task == "clf"

    def walk(node) -> int:
        nid = len(rows)
        rows.append([-1, 0.0, -1, -1, float(node.value),
                     node.probs if node.probs is not None
                     else np.zeros(tree.n_classes)])
        if node.left is not None:
            left = walk(node.left)
            right = walk(node.right)
            rows[nid][:4] = [int(node.feature), float(node.thresh), left, right]
        return nid

    walk(tree.root)
    cols = list(zip(*rows))
    out = {"feature": np.asarray(cols[0], np.int64),
           "thresh": np.asarray(cols[1], np.float64),
           "left": np.asarray(cols[2], np.int64),
           "right": np.asarray(cols[3], np.int64),
           "value": np.asarray(cols[4], np.float64)}
    if clf:
        out["probs"] = np.stack(cols[5]).astype(np.float64)
    return out


def mlp_param_arrays(params) -> List[Dict[str, np.ndarray]]:
    """``repro`` MLP pytree (a list of ``{"w", "b"}`` dicts of jax arrays)
    -> the same list with float32 numpy leaves, as
    :class:`repro_torch.core.ml.MLP` takes for ``init_params``."""
    return [{"w": np.array(l["w"], np.float32),
             "b": np.array(l["b"], np.float32)} for l in params]


def model_arrays(m) -> Dict[str, object]:
    if isinstance(m, jml.RandomForest):
        return {"model": "RandomForest",
                "trees": [_tree_arrays(t) for t in m.trees]}
    if isinstance(m, jml.MLP):
        a = {"model": "NeuralNetwork", "params": mlp_param_arrays(m.params),
             "mu": m.mu, "sd": m.sd, "task": m.task,
             "n_classes": m.n_classes, "hidden": tuple(m.hidden)}
        if m.task == "reg":
            a.update(ymu=m.ymu, ysd=m.ysd)
        return a
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
    ``torch.as_tensor`` refuses. ``None`` (a cross block's cache entry)
    stays ``None``."""
    if params is None:
        return None
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


#: decompression seconds per GB, fixed per codec. A truth-mode solve times
#: decompression on the wall clock, so two of its runs differ; the
#: migrator and daemon tests give both packages these instead.
DET_DSPEED = {"zlib-1": 2.0, "lzma-1": 12.0}
PAYLOAD_SCHEMES = ("none", "zlib-1", "lzma-1")


def measured_rd(raws, schemes=PAYLOAD_SCHEMES):
    """(R, D) of real payloads: each codec's true ratio (deterministic) and
    its fixed decompression speed."""
    from repro_torch.storage.codecs import codec_by_name
    R = np.ones((len(raws), len(schemes)))
    D = np.zeros((len(raws), len(schemes)))
    for i, b in enumerate(raws):
        for k, s in enumerate(schemes):
            if s != "none":
                R[i, k] = len(b) / max(len(codec_by_name(s).compress(b)), 1)
                D[i, k] = DET_DSPEED[s] * len(b) / 1e9
    return R, D


def payload_plans(raws, rho, schemes=PAYLOAD_SCHEMES, **cfg_kw):
    """``{pkg: (PlacementEngine, PlacementPlan)}`` for ``"j"`` (``repro``)
    and ``"t"`` (the port on the CPU), both solved from one shared problem
    over real payloads (``raw_bytes``, so a store can hold the plan)."""
    from repro.core import costs as jcosts
    from repro.core import engine as jeng
    from repro_torch.core import costs as tcosts
    from repro_torch.core import engine as teng
    R, D = measured_rd(raws, schemes)
    N = len(raws)
    out = {}
    for k, (eng, costs) in {"j": (jeng, jcosts), "t": (teng, tcosts)}.items():
        kw = dict(cfg_kw, schemes=tuple(schemes))
        if k == "t":
            kw["device"] = "cpu"
        table, cfg = costs.azure_table(), eng.ScopeConfig(**kw)
        e = eng.PlacementEngine(table, cfg)
        prob = eng.PlacementProblem(
            spans_gb=np.array([len(b) / 1e9 for b in raws]),
            rho=np.asarray(rho, np.float64).copy(),
            current_tier=np.full(N, -1), R=R.copy(), D=D.copy(),
            schemes=list(schemes), table=table, cfg=cfg,
            partitions=[None] * N, raw_bytes=list(raws))
        out[k] = (e, e.solve(prob))
    return out


#: six real payloads, their access rates and the drift that moves them:
#: rho spread forces both tier moves and re-encodes
PAYLOADS = [bytes([65 + i % 8]) * (200_000 + 50_000 * i) for i in range(6)]
PAYLOAD_RHO = np.array([0.05, 0.1, 40.0, 0.02, 800.0, 5.0])


def payload_drift(rho):
    r = np.asarray(rho, np.float64).copy()
    r[0] *= 5000.0
    r[4] /= 5000.0
    return r


#: deterministic meter fields: compute and decompression time are
#: wall-clock measured (as ``tests/test_migrator.py`` compares them)
STORE_FIELDS = ("storage_cents", "read_cents", "write_cents",
                "penalty_cents", "egress_cents", "n_reads", "n_writes")


def meter_sig(store):
    return tuple(getattr(store.meter, f) for f in STORE_FIELDS)


def state_sig(store):
    return {k: (o.payload, o.tier, o.codec, o.stored_gb, o.moved_month)
            for k, o in store._objs.items()}


SMALL_SIZES = {f"d{i}/{j}": 0.5 + 0.1 * j for i in range(6) for j in range(4)}
_QUIET = [(("d0/0", "d0/1"), 400.0), (("d1/0", "d1/1", "d1/2"), 0.01),
          (("d2/0", "d2/1"), 0.01)]
_HOT = [(f, 500.0 if f[0][0] in "d1d2" else h) for f, h in _QUIET]
#: two quiet batches, then d1 and d2 turn hot
SMALL_CYCLES = [_QUIET, _QUIET, _HOT, _HOT, _HOT, _HOT]


def stream_engines(sizes=SMALL_SIZES, **kw):
    """``{pkg: StreamingEngine}`` (uncompressed, one month a batch), each on
    its own state; without ``kw`` the small stream's settings."""
    from repro.core import costs as jcosts
    from repro.core import engine as jeng
    from repro_torch.core import costs as tcosts
    from repro_torch.core import engine as teng
    kw = kw or dict(s_thresh=5.0, window=1, drift_threshold=np.inf)
    return {k: eng.StreamingEngine(
        costs.azure_table(), eng.ScopeConfig(
            use_compression=False, months=1.0,
            **({"device": "cpu"} if k == "t" else {})), dict(sizes), **kw)
        for k, (eng, costs) in {"j": (jeng, jcosts),
                                "t": (teng, tcosts)}.items()}


def stream_payload(p):
    """A partition's payload, from its file set (deterministic)."""
    return b"Z" * (1000 * sum(ord(f[-1]) for f in sorted(p.files)))
