"""PyTorch port of the batched weighted-entropy features, held against
``repro``: the plain torch version against the Pallas kernel (interpret
mode) to 1e-5 at 1 and 5 buckets, with ragged rows, an empty dtype class
and a constant payload, and ``extract_features_batch`` parity. The CUDA
kernel is held against the plain version in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from repro.core import compredict as jcp
from repro.data import tables as jtables
from repro.data import tpch as jtpch
from repro.kernels.entropy_features import weighted_entropy_features
from repro_torch.core import compredict as tcp
from repro_torch.data import tables as ttables
from repro_torch.kernels import entropy_features as tef
from repro_torch.kernels import ops

TOL = dict(rtol=1e-5, atol=1e-5)
STRS = np.array(["alpha", "beta", "gamma", "delta", "epsilon", "zz"])


def _columns(n_rows, seed, *, n_int=1, n_float=1, n_str=1, constant=False):
    rng = np.random.default_rng(seed)
    cols = {}
    for c in range(n_int):
        cols[f"i{c}"] = (np.full(n_rows, 7) if constant
                         else rng.integers(0, 222, n_rows))
    for c in range(n_float):
        cols[f"f{c}"] = (np.full(n_rows, 1.5) if constant
                         else rng.normal(size=n_rows).round(2))
    for c in range(n_str):
        cols[f"s{c}"] = (np.full(n_rows, "aaa") if constant
                         else rng.choice(STRS, n_rows))
    return cols


def _pair(n_rows, seed, **kw):
    """The same seeded columns as a ``repro`` and a ``repro_torch`` table."""
    cols = _columns(n_rows, seed, **kw)
    return (jtables.Table(f"t{seed}", dict(cols)),
            ttables.Table(f"t{seed}", dict(cols)))


def _ragged_codes(seed, N=4, V=23):
    rng = np.random.default_rng(seed)
    n_cols = np.array([2, 1, 3, 2], np.int32)[:N]
    n_rows = rng.integers(1, 60, N).astype(np.int32)
    n_valid = n_rows * n_cols
    M = int(n_valid.max()) + 5
    codes = np.full((N, M), -1, np.int32)
    for i in range(N):
        codes[i, :n_valid[i]] = rng.integers(0, V, n_valid[i])
    lengths = rng.integers(1, 9, (N, V)).astype(np.float32)
    return codes, n_valid, n_rows, n_cols, lengths


@pytest.mark.parametrize("n_buckets", [1, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shared_vocab", [False, True])
def test_plain_matches_pallas_interpret(n_buckets, seed, shared_vocab):
    codes, n_valid, n_rows, n_cols, lengths = _ragged_codes(seed)
    if shared_vocab:
        lengths = lengths[0]
    s_t, b_t = ops.weighted_entropy_features(
        codes, n_valid, n_rows, n_cols, lengths, n_buckets=n_buckets,
        device="cpu")
    s_j, b_j = weighted_entropy_features(
        codes, n_valid, n_rows, n_cols, lengths, n_buckets=n_buckets,
        block=64, interpret=True)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), **TOL)


@pytest.mark.parametrize("n_buckets", [1, 5])
@pytest.mark.parametrize("case", ["empty_class", "constant"])
def test_plain_edge_cases_match_pallas(n_buckets, case):
    if case == "empty_class":
        tabs = [jtables.Table("a", _columns(9, 1, n_int=0, n_float=0)),
                jtables.Table("b", _columns(17, 2, n_int=0, n_float=0))]
    else:
        tabs = [jtables.Table("a", _columns(50, 1, constant=True)),
                jtables.Table("b", _columns(3, 2, constant=True))]
    enc = jtables.encode_dtype_classes(tabs)
    for d in jtables.DTYPE_CLASSES:
        cc = enc[d]
        args = (cc.codes, cc.n_valid, cc.n_rows, cc.n_cols, cc.lengths)
        s_t, b_t = ops.weighted_entropy_features(*args, n_buckets=n_buckets,
                                                 device="cpu")
        s_j, b_j = weighted_entropy_features(*args, n_buckets=n_buckets,
                                             interpret=True)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), **TOL)
        if case == "constant":
            np.testing.assert_allclose(s_t.numpy()[:, :2], 0.0, atol=1e-6)


def test_plain_float64_agrees_with_float32():
    codes, n_valid, n_rows, n_cols, lengths = _ragged_codes(4)
    args = [torch.as_tensor(x) for x in (codes, n_valid, n_rows, n_cols,
                                         lengths)]
    s32, b32 = tef.weighted_entropy_features_plain(*args, n_buckets=5)
    s64, b64 = tef.weighted_entropy_features_plain(*args, n_buckets=5,
                                                   dtype=torch.float64)
    assert s64.dtype == torch.float64
    np.testing.assert_allclose(s32.numpy(), s64.numpy(), **TOL)
    np.testing.assert_allclose(b32.numpy(), b64.numpy(), **TOL)


def test_encode_dtype_classes_is_a_faithful_copy():
    jt, tt = _pair(40, 3, n_int=2)
    jt2, tt2 = _pair(7, 4, n_str=2)
    je = jtables.encode_dtype_classes([jt, jt2])
    te = ttables.encode_dtype_classes([tt, tt2])
    for d in jtables.DTYPE_CLASSES:
        for f in ("codes", "n_valid", "n_rows", "n_cols", "lengths", "vocab"):
            np.testing.assert_array_equal(getattr(te[d], f),
                                          getattr(je[d], f))


@pytest.mark.parametrize("kind", ["weighted_entropy", "bucketed"])
@pytest.mark.parametrize("mix", [
    dict(n_int=2, n_float=1, n_str=1),
    dict(n_int=0, n_float=0, n_str=3),
    dict(n_int=0, n_float=2, n_str=0),
])
def test_extract_features_batch_matches_repro(kind, mix):
    pairs = [_pair(n, 10 + n, **mix) for n in (7, 64, 129, 1)]
    jt = [p[0] for p in pairs]
    tt = [p[1] for p in pairs]
    X_pal = jcp.extract_features_batch(jt, "col", kind, "pallas")
    X_dev = tcp.extract_features_batch(tt, "col", kind, "device",
                                       device="cpu")
    X_np = tcp.extract_features_batch(tt, "col", kind, "numpy", device="cpu")
    np.testing.assert_allclose(X_dev, X_pal, **TOL)
    np.testing.assert_allclose(X_np, jcp.extract_features_batch(
        jt, "col", kind, "numpy"), rtol=0, atol=0)
    np.testing.assert_allclose(X_dev, X_np, **TOL)


def test_extract_features_batch_on_tpch_query_samples():
    db = jtpch.generate(scale_rows=600, seed=3)
    qs = jtpch.generate_queries(db, n_per_template=2, seed=4)
    jt = jcp.query_samples(qs, db.tables, max_rows=300)[:6]
    tt = [ttables.Table(t.name, dict(t.columns)) for t in jt]
    for kind in ("weighted_entropy", "bucketed"):
        X_pal = jcp.extract_features_batch(jt, "row", kind, "pallas")
        X_dev = tcp.extract_features_batch(tt, "row", kind, "device",
                                           device="cpu")
        np.testing.assert_allclose(X_dev, X_pal, **TOL)


def test_kernel_wrapper_refuses_cpu_tensors():
    args = [torch.as_tensor(x) for x in _ragged_codes(0)]
    with pytest.raises(ValueError, match="CUDA"):
        tef.weighted_entropy_features_kernel(*args)
