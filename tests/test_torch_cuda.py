"""Tests of the PyTorch port that need a CUDA card (marker ``cuda``).

Each holds a hand-written CUDA kernel, or a path through one, against the
plain tensor version on the CPU. Whether there is a card is decided inside
the ``card`` fixture, when a test runs, so every test is collected
everywhere; without a card each skips. The module imports nothing of the
JAX package, so it runs on a machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import compredict as tcp
from repro_torch.core import datapart as tdp
from repro_torch.core import optassign as topt
from repro_torch.core import scope as tscope
from repro_torch.core.costs import azure_table
from repro_torch.data import tpch
from repro_torch.data.tables import Table
from repro_torch.kernels import ops
from repro_torch.kernels import overlap as tov

TOL = dict(rtol=1e-5, atol=1e-5)
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _canon(parts):
    return sorted((tuple(sorted(p.files)), round(p.rho, 9)) for p in parts)


def _families(seed, n_parts=40, n_files=80):
    rng = np.random.default_rng(seed)
    files = [f"t/{i}" for i in range(n_files)]
    sizes = {f: float(rng.random() * 4 + 0.25) for f in files}
    qf = [(tuple(rng.choice(files, size=int(rng.integers(1, 7)),
                            replace=False)), float(rng.random() * 9 + 0.5))
          for _ in range(n_parts)]
    return tdp.make_partitions(qf, sizes)


def _ragged_codes(seed, N=4, V=23):
    rng = np.random.default_rng(seed)
    n_cols = np.array([2, 1, 3, 2], np.int32)[:N]
    n_rows = rng.integers(1, 60, N).astype(np.int32)
    n_valid = n_rows * n_cols
    codes = np.full((N, int(n_valid.max()) + 5), -1, np.int32)
    for i in range(N):
        codes[i, :n_valid[i]] = rng.integers(0, V, n_valid[i])
    return codes, n_valid, n_rows, n_cols, \
        rng.integers(1, 9, (N, V)).astype(np.float32)


def _instance(seed, N=40, L=4, K=3):
    rng = np.random.default_rng(seed)
    cost = rng.gamma(2.0, 1.0, (N, L, K))
    feas = rng.random((N, L, K)) > 0.1
    feas[:, :, 0] = True
    spans = rng.uniform(0.5, 3.0, N)
    ratio = np.concatenate([np.ones((N, 1)),
                            rng.uniform(1.2, 4.0, (N, K - 1))], axis=1)
    stored = np.repeat((spans[:, None] / ratio)[:, None, :], L, axis=1)
    g = topt.greedy_assign(cost, feas, device="cpu")
    cap = np.maximum(0.45 * topt._chosen_usage(stored, g.tier, g.scheme),
                     0.2 * stored.sum() / N)
    cap[-1] = np.inf
    return cost, feas, stored, cap


@pytest.mark.parametrize("seed", [0, 5])
def test_overlap_kernel_matches_plain(card, seed):
    codes, sizes, spans = tdp.PartitionIndex.from_partitions(
        _families(seed)).padded_codes()
    w_k = ops.fractional_overlap_matrix(codes, sizes, spans, device=card)
    w_p = tov.fractional_overlap_matrix_plain(
        *(torch.as_tensor(x, device=card) for x in (codes, sizes, spans)))
    assert (w_k - w_p).abs().max().item() <= 1e-5
    assert torch.equal(w_k > 0, w_p > 0)
    blk = ops.fractional_overlap_matrix(codes[:7], sizes, spans[:7],
                                        codes_b=codes, spans_b=spans,
                                        device=card)
    assert (blk - w_k[:7]).abs().max().item() <= 1e-5


def test_g_part_on_card_matches_cpu(card):
    parts = _families(9)
    s = 2.5 * float(np.median([p.span for p in parts]))
    assert _canon(tdp.g_part(list(parts), s, backend="device", device=card)) \
        == _canon(tdp.g_part(list(parts), s, backend="device", device="cpu"))


@pytest.mark.parametrize("n_buckets", [1, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entropy_kernel_matches_plain(card, n_buckets, seed):
    args = _ragged_codes(seed)
    for lengths in (args[4], args[4][0]):           # local and shared vocab
        a = args[:4] + (lengths,)
        s_k, b_k = ops.weighted_entropy_features(*a, n_buckets=n_buckets,
                                                 device=card)
        s_p, b_p = ops.weighted_entropy_features(*a, n_buckets=n_buckets,
                                                 device="cpu")
        np.testing.assert_allclose(s_k.cpu().numpy(), s_p.numpy(), **TOL)
        np.testing.assert_allclose(b_k.cpu().numpy(), b_p.numpy(), **TOL)


def test_extract_features_batch_on_card_matches_cpu(card):
    rng = np.random.default_rng(3)
    tabs = [Table(f"t{n}", {"i": rng.integers(0, 50, n),
                            "f": rng.normal(size=n).round(2),
                            "s": rng.choice(np.array(["ab", "cde", "f"]), n)})
            for n in (5, 80, 33)]
    for kind in ("weighted_entropy", "bucketed"):
        np.testing.assert_allclose(
            tcp.extract_features_batch(tabs, "col", kind, "device",
                                       device=card),
            tcp.extract_features_batch(tabs, "col", kind, "device",
                                       device="cpu"), **TOL)


@pytest.mark.parametrize("seed", range(3))
def test_solvers_on_card_match_cpu(card, seed):
    cost, feas, stored, cap = _instance(seed)
    g_k = topt.greedy_assign(cost, feas, device=card)
    g_c = topt.greedy_assign(cost, feas, device="cpu")
    np.testing.assert_array_equal(g_k.tier, g_c.tier)
    np.testing.assert_array_equal(g_k.scheme, g_c.scheme)
    a = topt.capacitated_assign(cost, feas, stored, cap, device=card)
    b = topt.capacitated_assign(cost, feas, stored, cap, device="cpu")
    assert a.cost == pytest.approx(b.cost, rel=1e-6)
    again = topt.capacitated_assign(cost, feas, stored, cap, device=card)
    np.testing.assert_array_equal(again.tier, a.tier)
    np.testing.assert_array_equal(again.scheme, a.scheme)


def test_pipeline_on_card_matches_cpu(card):
    db = tpch.generate(scale_rows=900, seed=0)
    qs = tpch.generate_queries(db, n_per_template=3, seed=1)
    parts, rows = tpch.partitions_from_queries(db, qs)
    pred = tcp.CompressionPredictor(model_name="SVR").fit(
        tcp.query_samples(qs, db.tables, max_rows=6000)[:40],
        layouts=("col",))
    cap = np.array([0.163, 0.326, 0.4891, np.inf]) \
        * sum(p.span for p in parts) / 1e9 * 1.2
    ops.reset_launch_counts()
    for name, cfg in tscope.paper_variants(cap).items():
        cfg = dataclasses.replace(cfg, predictor=pred,
                                  partition_backend="device",
                                  feature_backend="device", device="cpu")
        a = tscope.run_pipeline(parts, rows, azure_table(), cfg)
        b = tscope.run_pipeline(parts, rows, azure_table(),
                                dataclasses.replace(cfg, device="cuda"))
        assert a.tiering_scheme == b.tiering_scheme, name
        assert b.total_cents == pytest.approx(a.total_cents, rel=1e-6), name
    assert ops.launch_counts["overlap"] > 0
    assert ops.launch_counts["entropy_features"] > 0
