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
from repro_torch.core import engine as teng
from repro_torch.core import fleet as tfleet
from repro_torch.core import forecast as tfc
from repro_torch.core import ml as tml
from repro_torch.core import optassign as topt
from repro_torch.core import scope as tscope
from repro_torch.core.costs import (Weights, azure_table, big3_table,
                                    cost_tensor, latency_feasible)
from repro_torch.data import tpch
from repro_torch.data import workloads as twl
from repro_torch.data.tables import Table
from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import entropy_features as tef
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import overlap as tov
from repro_torch.kernels import quant_pack as tqp
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as ttr
from repro_torch.serving.decode import make_decode_step, make_prefill_step

TOL = dict(rtol=1e-5, atol=1e-5)
# attention: the JAX suite's kernel tolerances; SSD: its 1e-4 (f32 state)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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


def _overlap_rows(seed, n, F, lens):
    """Code rows of the given lengths over F files, sizes and spans."""
    rng = np.random.default_rng(seed)
    rows = [np.sort(rng.choice(F, int(k), replace=False)) for k in lens]
    codes = np.full((n, max(max(lens), 1)), -1, np.int32)
    for i, r in enumerate(rows):
        codes[i, :len(r)] = r
    sizes = rng.uniform(0.5, 2.0, F).astype(np.float32)
    spans = np.array([sizes[r].sum() for r in rows], np.float32)
    return codes, sizes, spans


def _scaling_rows(n_fams=4096, n_files=4096 * 20, seed=0):
    """The G-PART scaling benchmark's shape (chip_smoke.py's
    gpart_instance): windows of 2-8 neighbouring files."""
    rng = np.random.default_rng(seed)
    sizes = {f"s{i}": float(rng.uniform(0.5, 2.0)) for i in range(n_files)}
    w = rng.integers(2, 9, n_fams)
    lo = rng.integers(0, n_files - 9, n_fams)
    qf = [(tuple(f"s{j}" for j in range(lo[k], lo[k] + w[k])),
           float(rng.uniform(0.5, 8.0))) for k in range(n_fams)]
    return tdp.PartitionIndex.from_partitions(
        tdp.make_partitions(qf, sizes)).padded_codes()


def _main_like_rows():
    """217 rows over 1,732 files, 1-250 codes each and one of 1,200."""
    lens = np.random.default_rng(1).integers(1, 250, 217)
    lens[11] = 1200
    return _overlap_rows(2, 217, 1732, lens)


def _long_row():
    """40 rows over 5,000 files, one of them 4,096 codes long."""
    lens = np.random.default_rng(3).integers(1, 60, 40)
    lens[0] = 4096
    return _overlap_rows(4, 40, 5000, lens)


@pytest.mark.parametrize("shape", ["main-like 217x1200", "4096x81920",
                                   "one row of 4096", "rectangular 217x37"])
def test_overlap_kernel_is_its_twin_and_syncs_nothing(card, shape):
    """K1 within 1e-5 of the plain version with an identical w > 0
    pattern, bit-identical to fractional_overlap_matrix_ordered on the card
    and to a second call, one launch and no host synchronisation, at the
    main path's shape (a long row among short ones), the scaling shape
    (merge plan), a row of 4,096 codes, and NB = 37 (no tile's multiple)."""
    make = {"4096x81920": _scaling_rows, "one row of 4096": _long_row}
    codes, sizes, spans = make.get(shape, _main_like_rows)()
    t = [torch.as_tensor(x, device=card) for x in (codes, sizes, spans)]
    kw = {}
    if shape.startswith("rectangular"):
        kw = dict(codes_b=t[0][100:137].contiguous(),
                  spans_b=t[2][100:137].contiguous())
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w = tov.fractional_overlap_matrix_kernel(*t, **kw)
        again = tov.fractional_overlap_matrix_kernel(*t, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert ops.launch_counts["overlap"] == 2
    w_p = tov.fractional_overlap_matrix_plain(*t, **kw)
    assert (w - w_p).abs().max().item() <= 1e-5
    assert torch.equal(w > 0, w_p > 0)
    assert torch.equal(w, tov.fractional_overlap_matrix_ordered(*t, **kw))
    assert torch.equal(w, again)


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


def _placement(table, N, seed, **cfg_kw):
    """``{device: (engine, problem)}`` for one seeded synthetic problem (the
    recipe of the repository's re-optimization benchmark)."""
    rng = np.random.default_rng(seed)
    spans = rng.lognormal(0.0, 1.2, N) * 2.0
    rho = rng.gamma(0.7, 25.0, N)
    R = np.concatenate([np.ones((N, 1)), rng.uniform(1.2, 6.0, (N, 2))], 1)
    D = np.concatenate([np.zeros((N, 1)),
                        rng.uniform(0.01, 2.0, (N, 2)) * spans[:, None]], 1)
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = teng.ScopeConfig(schemes=("none", "lz4", "zstd"), device=dev,
                               **cfg_kw)
        prob = teng.PlacementProblem(
            spans_gb=spans.copy(), rho=rho.copy(), current_tier=np.full(N, -1),
            R=R.copy(), D=D.copy(), schemes=cfg.schemes, table=table,
            cfg=cfg)
        out[dev] = (teng.PlacementEngine(table, cfg), prob)
    return out


@pytest.mark.parametrize("table,cfg_kw", [
    ("azure", {}),
    ("azure", dict(capacity_gb=np.array([np.inf, np.inf, 100.0, np.inf]))),
    ("big3", dict(months=6.0)),
    ("big3_capped", dict(months=6.0)),
])
def test_reoptimize_on_card_matches_cpu(card, table, cfg_kw):
    t = {"azure": azure_table(), "big3": big3_table(),
         "big3_capped": big3_table(azure_capacity_gb=60.0)}[table]
    runs = _placement(t, 300, 0, **cfg_kw)
    plans = {d: e.solve(p) for d, (e, p) in runs.items()}
    np.testing.assert_array_equal(plans["cuda"].assignment.tier,
                                  plans["cpu"].assignment.tier)
    rng = np.random.default_rng(1)
    rho = plans["cpu"].problem.rho.copy()
    hot = rng.random(rho.size) < 0.10
    cold = ~hot & (rng.random(rho.size) < 0.10)
    rho[hot] *= rng.uniform(20.0, 100.0, int(hot.sum()))
    rho[cold] /= rng.uniform(20.0, 100.0, int(cold.sum()))
    migs = {d: runs[d][0].reoptimize(plans[d], rho.copy(), months_held=0.25)
            for d in runs}
    a, b = migs["cuda"], migs["cpu"]
    assert b.n_moved > 0
    for f in ("moved", "new_tier", "new_scheme"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for f in ("migration_cents", "penalty_cents", "egress_cents"):
        assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-6,
                                              abs=1e-12), f
    assert a.plan.report.provider_scheme == b.plan.report.provider_scheme


@pytest.mark.parametrize("table", ["azure", "big3"])
def test_plan_replicas_on_card_matches_cpu(card, table):
    t = azure_table() if table == "azure" else big3_table()
    runs = _placement(t, 200, 2, replicas=3, replica_rho_min=30.0)
    reps = {d: e.plan_replicas(e.solve(p)) for d, (e, p) in runs.items()}
    a, b = reps["cuda"], reps["cpu"]
    assert b.n_replicated > 0
    for f in ("copies", "replica_tier", "replica_scheme"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert a.replica_cents == pytest.approx(b.replica_cents, rel=1e-6)
    assert a.read_rebate_cents == pytest.approx(b.read_rebate_cents, rel=1e-6)


@pytest.mark.parametrize("n", [50, 100_000])
def test_budgeted_moves_on_card_matches_cpu(card, n):
    rng = np.random.default_rng(n)
    s = rng.gamma(1.0, 5.0, n) - 1.0
    c = rng.uniform(0.0, 3.0, n)
    c[rng.random(n) < 0.05] = 0.0
    g = rng.uniform(0.0, 2.0, n)
    cand = rng.random(n) < 0.8
    kw = dict(candidates=cand, move_gb=g, budget_gb=0.4 * g[cand].sum(),
              method="greedy")
    a = topt.budgeted_moves(s, c, 0.5 * c[cand].sum(), device=card, **kw)
    b = topt.budgeted_moves(s, c, 0.5 * c[cand].sum(), device="cpu", **kw)
    np.testing.assert_array_equal(a, b)
    assert 0 < a.sum() < cand.sum()


@pytest.mark.parametrize("task", ["reg", "clf"])
def test_mlp_on_card_matches_cpu(card, task):
    """The same initial parameters on the card and on the CPU: parameters
    within 1e-5 after 10 Adam steps; after 500, regression predictions
    within rel 1e-4 and classification logits within 1e-3 (the CPU
    tests' bars against the reference)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(80, 18)) * rng.uniform(0.5, 20.0, 18)
    y = 3.0 + X[:, 0] / 10 + np.sin(X[:, 1]) + 0.1 * rng.normal(size=80)
    if task == "clf":
        y = (X[:, 0] / 10 + X[:, 2] / 5 > 0).astype(int)
    Xq = rng.normal(size=(40, 18)) * 5.0
    init = tml._mlp_init((18, 64, 64, 1 if task == "reg" else 2), seed=3)
    for epochs in (10, 500):
        m = {d: tml.MLP(hidden=(64, 64), task=task, epochs=epochs,
                        init_params=init, device=d).fit(X, y)
             for d in ("cuda", "cpu")}
        if epochs == 10:
            for a, b in zip(m["cuda"].params, m["cpu"].params):
                np.testing.assert_allclose(a["w"], b["w"], rtol=0, atol=1e-5)
                np.testing.assert_allclose(a["b"], b["b"], rtol=0, atol=1e-5)
        elif task == "reg":
            pa, pb = m["cuda"].predict(Xq), m["cpu"].predict(Xq)
            np.testing.assert_allclose(pa, pb, rtol=1e-4,
                                       atol=1e-4 * np.abs(pb).max())
        else:
            np.testing.assert_allclose(m["cuda"]._raw(Xq), m["cpu"]._raw(Xq),
                                       rtol=0, atol=1e-3)


def _randn(seed, *shapes, dtype=torch.float32, device="cpu", scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32) * scale)
            .to(device=device, dtype=dtype) for s in shapes]


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


def _k5_route(dtype, Sq, D, Dv):
    """K5's route for contiguous operands on fresh (aligned) allocations:
    bfloat16 at one query on K6's split kernel, at more on the wgmma
    kernel where D and Dv are multiples of 8 of at least 32 columns, else
    on mma.sync; float32 on the CUDA cores."""
    if dtype != torch.bfloat16:
        return "flash_attention.f32"
    if Sq == 1:
        return "flash_attention.split"
    if D % 8 == 0 and Dv % 8 == 0 and min(D, Dv) >= 32:
        return "flash_attention.wgmma"
    return "flash_attention.bf16_tc"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,Dv,causal,window,softcap", [
    (1, 128, 128, 4, 4, 64, 64, True, None, None),     # MHA
    (2, 96, 96, 8, 2, 32, 32, True, None, None),       # GQA, ragged tile
    (1, 256, 256, 4, 1, 64, 64, True, 64, None),       # MQA + window
    (1, 128, 128, 2, 2, 64, 64, True, None, 50.0),     # softcap
    (2, 64, 64, 4, 2, 48, 32, False, None, None),      # non-causal, Dv != D
    (2, 200, 200, 8, 8, 80, 80, True, None, None),     # zamba2's 80 wide
    (1, 40, 150, 4, 2, 80, 80, True, 70, 30.0),        # queries at the end
    (1, 64, 64, 2, 1, 256, 256, True, None, None),     # widest heads
    (1, 64, 64, 4, 2, 40, 24, True, None, None),       # D, Dv % 16 != 0
    (1, 96, 96, 2, 2, 20, 20, True, None, None),       # D % 8 != 0: plain loads
    (2, 70, 70, 4, 4, 64, 64, True, None, None),       # ragged query tile
    (1, 128, 128, 8, 2, 128, 128, True, None, None),   # D 128, GQA 4:1
])
def test_flash_kernel_matches_plain(card, B, Sq, Sk, Hq, Hkv, D, Dv, causal,
                                    window, softcap, dtype):
    q, k, v = _randn(11, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv),
                     dtype=dtype, device=card)
    kw = dict(causal=causal, window=window, softcap=softcap)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts["flash_attention"] == 1
    assert dict(ops.route_counts) == {_k5_route(dtype, Sq, D, Dv): 1}
    assert out.dtype == dtype and out.shape == (B, Sq, Hq, Dv)
    _assert_close(out, tfa.flash_attention_plain(q, k, v, **kw),
                  ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,softcap", [
    (2, 256, 8, 2, 64, None, None),
    (1, 512, 4, 1, 128, None, None),     # MQA long cache
    (3, 200, 8, 8, 32, 64, None),        # MHA + window, ragged lengths
    (4, 545, 32, 32, 80, None, None),    # zamba2's cache at full width
    (2, 100, 12, 2, 80, 30, 50.0),       # 6 heads per group, softcap
])
def test_decode_kernel_matches_plain(card, B, S, Hq, Hkv, D, window, softcap,
                                     dtype):
    q, k, v = _randn(12, (B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                     dtype=dtype, device=card)
    lens = np.random.default_rng(0).integers(window or 1, S + 1, B)
    lens[0] = S
    kv_len = torch.as_tensor(lens, dtype=torch.int32, device=card)
    kw = dict(window=window, softcap=softcap)
    ops.reset_launch_counts()
    out = ops.decode_attention(q, k, v, kv_len, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts["decode_attention"] == 1
    _assert_close(out, tda.decode_attention_plain(q, k, v, kv_len, **kw),
                  ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv,window,softcap,lens", [
    (4, 546, 32, 32, 80, 80, None, None, [544, 1, 64, 272]),  # zamba2's loop
    (3, 200, 8, 8, 32, 32, None, None, [200, 37, 0]),    # empty splits, 0
    (2, 300, 4, 4, 64, 64, 50, None, [300, 100]),        # window in a split
    (2, 97, 16, 2, 32, 32, 40, 30.0, [97, 60]),          # rep 8, softcap
    (1, 4100, 8, 1, 128, 128, None, None, [4097]),       # 65 splits, MQA
    (2, 130, 4, 2, 20, 24, None, None, [130, 66]),       # D 20: plain loads
    (2, 70, 2, 1, 256, 256, None, 20.0, [70, 33]),       # widest heads
])
def test_decode_split_kernel_edges_are_exact_and_repeatable(
        card, B, S, Hq, Hkv, D, Dv, window, softcap, lens, dtype):
    """K6's split-KV kernel at shapes that exercise the split and merge:
    within the JAX suite's tolerance of the plain version on every row,
    exactly 0 where no key is visible (as the plain version is), and
    bit-identical on a second call (no float atomics)."""
    q, k, v = _randn(14, (B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, Dv),
                     dtype=dtype, device=card)
    kv_len = torch.as_tensor(lens, dtype=torch.int32, device=card)
    kw = dict(window=window, softcap=softcap)
    ops.reset_launch_counts()
    out = ops.decode_attention(q, k, v, kv_len, **kw)
    again = ops.decode_attention(q, k, v, kv_len, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts["decode_attention"] == 2
    assert torch.equal(out, again)
    _assert_close(out, tda.decode_attention_plain(q, k, v, kv_len, **kw),
                  ATTN_TOL[dtype])
    assert not out[kv_len == 0].float().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,lens", [
    (161, [0, 1, 160, 37]),          # the zoo's serve loop: kv_len 0 .. 160
    (4096, [4096, 1, 0, 2049]),      # a long latent cache: 64 splits
])
def test_decode_kernel_reads_mla_latent_v_inside_k(card, S, lens, dtype):
    """MLA's absorbed decode: 16 query heads of 576 against one latent KV
    head, v the cache's first 512 columns. The kernel reads v inside k's
    tiles (no copy: ops.decode_attention hands the view on), agrees with
    the plain version, gives 0 where kv_len is 0 and the same bits on a
    second call."""
    B, Hq, r, rope = 4, 16, 512, 64
    q, cache = _randn(15, (B, Hq, r + rope), (B, S, r + rope), dtype=dtype,
                      device=card)
    k = cache[:, :, None, :]
    v = k[..., :r]
    assert tda.v_in_k(k, v) and not v.is_contiguous()
    kv_len = torch.as_tensor(lens, dtype=torch.int32, device=card)
    seen = []
    orig = tda.decode_attention_kernel

    def spy(q_, k_, v_, *a, **kw):
        seen.append((k_.data_ptr(), v_.data_ptr(), v_.is_contiguous()))
        return orig(q_, k_, v_, *a, **kw)

    tda.decode_attention_kernel = spy
    try:
        ops.reset_launch_counts()
        out = ops.decode_attention(q, k, v, kv_len)
        again = ops.decode_attention(q, k, v, kv_len)
        torch.cuda.synchronize()
    finally:
        tda.decode_attention_kernel = orig
    assert ops.launch_counts["decode_attention"] == 2
    assert seen == [(cache.data_ptr(), cache.data_ptr(), False)] * 2
    assert out.shape == (B, Hq, r) and torch.equal(out, again)
    _assert_close(out, tda.decode_attention_plain(q, k, v, kv_len),
                  ATTN_TOL[dtype])
    assert not out[kv_len == 0].float().any()
    info = tda.decode_attention_info(S, Hq, 1, r + rope, r, dtype, B=B,
                                     aliased=True)
    assert info["group"] == tda.WIDE_GROUP and info["smem_bytes"] <= 232448


def _slice_operands(latent, dtype, device, S=544):
    """q, the global cache k/v (v inside k for MLA's latent cache) and
    global lengths: zamba2's shared attention block at full width (32
    heads of 80, B 4), or deepseek's absorbed decode (16 heads of 576 over
    one latent head, v its first 512 columns)."""
    B = 4
    if latent:
        q, cache = _randn(21, (B, 16, 576), (B, S, 576), dtype=dtype,
                          device=device)
        k = cache[:, :, None, :]
        v = k[..., :512]
    else:
        q, k, v = _randn(21, (B, 32, 80), (B, S, 32, 80), (B, S, 32, 80),
                         dtype=dtype, device=device)
    lens = torch.as_tensor([S, S // 2 + 3, 5, S - 40], dtype=torch.int32,
                           device=device)
    return q, k, v, lens


def _merge(parts):
    """The ranks' log-sum-exp merge of (acc, m, l) partials."""
    m_star = torch.stack([m for _, m, _ in parts]).amax(0)
    w = [torch.exp(m - m_star) for _, m, _ in parts]
    L = sum(l * c for (_, _, l), c in zip(parts, w))
    A = sum(a * c[..., None] for (a, _, _), c in zip(parts, w))
    return A / torch.clamp_min(L, 1e-30)[..., None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent", [False, True])
@pytest.mark.parametrize("offset,window", [(272, None), (272, 300),
                                           (0, 100), (408, 64)])
def test_decode_partials_kernel_matches_plain(card, latent, offset, window,
                                              dtype):
    """K6's partials mode over one slice of a sequence-sharded cache, key j
    at global position offset + j and the window measured from the global
    length (one that starts before the slice, one inside it): the
    kernel's (acc, m, l) against the plain version's, each row with a
    visible key within tolerance, each row without one exactly (m -1e30,
    l 0, acc 0), the same bits on a second call."""
    q, k, v, lens = _slice_operands(latent, dtype, card)
    n = 136 if offset == 408 else 272
    ks = k[:, offset:offset + n].contiguous()     # a rank's own slice
    vs = ks[..., :512] if latent else v[:, offset:offset + n].contiguous()
    local = torch.clamp(lens - offset, 0, n).to(torch.int32)
    kw = dict(offset=offset, global_len=lens, window=window)
    ops.reset_launch_counts()
    acc, m, l = ops.decode_attention_partials(q, ks, vs, local, **kw)
    again = ops.decode_attention_partials(q, ks, vs, local, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts["decode_attention"] == 2
    assert ops.route_counts["decode_attention.partials"] == 2
    assert all(torch.equal(a, b) for a, b in zip((acc, m, l), again))
    acc_p, m_p, l_p = tda.decode_attention_partials_plain(q, ks, vs, local,
                                                          **kw)
    seen = l_p > 0
    assert torch.equal(seen, l > 0)
    assert seen.any() and (~seen).any() or offset == 0
    assert torch.equal(m[~seen], m_p[~seen]) and not acc[~seen].any()
    _assert_close(m[seen], m_p[seen], 1e-5)
    _assert_close(l[seen], l_p[seen], 1e-4)
    _assert_close(acc[seen] / l[seen][:, None], acc_p[seen] /
                  l_p[seen][:, None], ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent", [False, True])
@pytest.mark.parametrize("slices", [2, 4])
def test_decode_partials_merged_equal_unsharded_kernel(card, latent, slices,
                                                       dtype):
    """The sequence-sharded decode's arithmetic on one card: the cache cut
    into 2 or 4 slices, K6's partials on each, merged by the ranks' rule,
    equal K6 on the whole cache within K6's tolerance."""
    q, k, v, lens = _slice_operands(latent, dtype, card)
    S = k.shape[1]
    n = S // slices
    parts = []
    for r in range(slices):
        ks = k[:, r * n:(r + 1) * n].contiguous()
        vs = ks[..., :512] if latent else v[:, r * n:(r + 1) * n].contiguous()
        local = torch.clamp(lens - r * n, 0, n).to(torch.int32)
        parts.append(ops.decode_attention_partials(
            q, ks, vs, local, offset=r * n, global_len=lens))
    got = _merge(parts).to(dtype)
    _assert_close(got, ops.decode_attention(q, k, v, lens), ATTN_TOL[dtype])


@pytest.mark.parametrize("T,N,L,K", [(1, 16_000, 12, 3), (64, 40, 4, 3),
                                     (300, 257, 4, 2)])
def test_usage_sum_kernel_is_the_cpus_float32_row_order_bit_for_bit(
        card, T, N, L, K):
    """The fleet scan's usage sum: the kernel's float32 sums in row order
    are the CPU's ``np.add.at`` in float32, bit for bit, and a second
    call's."""
    rng = np.random.default_rng(T)
    idx = torch.as_tensor(rng.integers(0, L * K, (T, N)), device=card)
    chosen = torch.as_tensor(np.exp(rng.uniform(-8, 8, (T, N)))
                             .astype(np.float32), device=card)
    ops.reset_launch_counts()
    got = ops.usage_sum(idx, chosen, K, L)
    again = ops.usage_sum(idx, chosen, K, L)
    torch.cuda.synchronize()
    assert ops.launch_counts["usage_sum"] == 2
    want = ops.usage_sum(idx.cpu(), chosen.cpu(), K, L)
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)
    exact = np.zeros((T, L))
    np.add.at(exact, (np.repeat(np.arange(T), N),
                      (idx.cpu().numpy() // K).ravel()),
              chosen.cpu().numpy().astype(np.float64).ravel())
    assert (want.numpy() != exact.astype(np.float32)).any() or N < 100


def _usage_case(case):
    """(idx, chosen, K, L) of a named usage-sum case, from numpy."""
    T, N, L, K, tiers = {
        "L 1": (3, 5_000, 1, 3, None),
        "L 128": (2, 3_000, 128, 2, None),
        "a tier with no rows": (5, 600, 6, 3, [0, 1, 3, 4, 5]),
        "every row in one tier": (2, 9_000, 4, 3, [3]),
        "N 1": (7, 1, 4, 3, None),
        "N 4,097": (3, 4_097, 12, 3, None),
        "T 0": (0, 50, 4, 3, None),
        "T 2,048 x N 30": (2_048, 30, 4, 3, None),
        "the warp route's widest": (9, 1_024, 32, 2, None),
        "past it: N 1,025": (4, 1_025, 32, 2, None),
        "past it: 33 tiers": (4, 300, 33, 2, None),
        "L 129": (3, 5_000, 129, 3, None),
        "L 256": (2, 4_500, 256, 2, None),
        "L 1,000": (2, 9_000, 1_000, 3, None),
        "L 200, tiers past 128 only": (3, 700, 200, 2, list(range(128, 200))),
    }[case]
    rng = np.random.default_rng(len(case))
    tier = rng.choice(np.arange(L) if tiers is None else np.array(tiers),
                      (T, N))
    idx = tier * K + rng.integers(0, K, (T, N))
    chosen = np.exp(rng.uniform(-8, 8, (T, N))).astype(np.float32)
    return idx, chosen, K, L


@pytest.mark.parametrize("case", [
    "L 1", "L 128", "a tier with no rows", "every row in one tier", "N 1",
    "N 4,097", "T 0", "T 2,048 x N 30", "the warp route's widest",
    "past it: N 1,025", "past it: 33 tiers", "L 129", "L 256", "L 1,000",
    "L 200, tiers past 128 only"])
def test_usage_sum_kernel_edges_are_np_add_at_in_float32(card, case):
    """The usage-sum kernel at the edges of its routes and tiles: the
    float32 sums of ``np.add.at`` in row order, bit for bit, the same bits
    on a second call, one launch a call (none for no tenant), exactly 0 for
    a tier without rows."""
    idx_np, chosen_np, K, L = _usage_case(case)
    T, N = idx_np.shape
    idx = torch.as_tensor(idx_np, device=card)
    chosen = torch.as_tensor(chosen_np, device=card)
    ops.reset_launch_counts()
    got = ops.usage_sum(idx, chosen, K, L)
    again = ops.usage_sum(idx, chosen, K, L)
    torch.cuda.synchronize()
    assert ops.launch_counts["usage_sum"] == (2 if T else 0)
    want = np.zeros((T, L), np.float32)
    np.add.at(want, (np.repeat(np.arange(T), N), (idx_np // K).ravel()),
              chosen_np.ravel())
    assert got.shape == (T, L) and got.dtype == torch.float32
    assert np.array_equal(got.cpu().numpy().view(np.int32),
                          want.view(np.int32))
    assert torch.equal(got, again)
    empty = np.bincount((idx_np // K).ravel(), minlength=L)[:L] == 0
    assert not got.cpu().numpy()[:, empty].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,lens", [
    (4, 161, 40, 8, 128, [160, 1, 0, 77]),     # llama4-scout: rep 5
    (4, 161, 64, 8, 128, [160, 100, 3, 0]),    # llama-3.2-vision: rep 8
    (4, 161, 12, 12, 64, [160, 160, 9, 0]),    # whisper's decoder: MHA 64
])
def test_decode_kernel_at_the_zoo_gqa_shapes(card, B, S, Hq, Hkv, D, lens,
                                             dtype):
    q, k, v = _randn(16, (B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                     dtype=dtype, device=card)
    kv_len = torch.as_tensor(lens, dtype=torch.int32, device=card)
    out = ops.decode_attention(q, k, v, kv_len)
    assert torch.equal(out, ops.decode_attention(q, k, v, kv_len))
    _assert_close(out, tda.decode_attention_plain(q, k, v, kv_len),
                  ATTN_TOL[dtype])
    assert not out[kv_len == 0].float().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,Dv,causal", [
    (2, 256, 256, 16, 16, 192, 128, True),     # MLA prefill: nope + rope
    (1, 1500, 1500, 12, 12, 64, 64, False),    # whisper's encoder
    (4, 1, 1500, 12, 12, 64, 64, False),       # cross-attention in decode
    (2, 128, 1500, 12, 12, 64, 64, False),     # whisper's cross prefill
    (1, 64, 4100, 64, 8, 128, 128, False),     # vision cross, rep 8
])
def test_flash_kernel_at_the_zoo_shapes(card, B, Sq, Sk, Hq, Hkv, D, Dv,
                                        causal, dtype):
    q, k, v = _randn(17, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv),
                     dtype=dtype, device=card)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert dict(ops.route_counts) == {_k5_route(dtype, Sq, D, Dv): 1}
    _assert_close(out, tfa.flash_attention_plain(q, k, v, causal=causal),
                  ATTN_TOL[dtype])


@pytest.mark.parametrize("B,Sk,Hq,Hkv,D,Dv,causal,window,softcap", [
    (4, 1500, 12, 12, 64, 64, False, None, None),   # whisper's cross decode
    (4, 4100, 64, 8, 128, 128, False, None, None),  # vision's: rep 8
    (2, 1500, 40, 8, 128, 128, True, 300, None),    # causal, a window, rep 5
    (1, 4100, 16, 16, 192, 128, True, None, 30.0),  # Dv != D, softcap
    (1, 777, 8, 1, 80, 80, False, 50, None),        # window ignored; B Hkv 1
    (2, 300, 4, 1, 320, 288, True, 40, None),       # above 256: split too
])
def test_flash_split_route_matches_plain(card, B, Sk, Hq, Hkv, D, Dv, causal,
                                         window, softcap):
    """K5 at one bfloat16 query runs K6's split kernel and merge with kv_len
    Sk (the window only when causal): within K5's bf16 tolerance of the
    plain version, identical bits on a second call, counted once under
    ``flash_attention.split`` and never under ``decode_attention``."""
    q, k, v = _randn(41, (B, 1, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv),
                     dtype=torch.bfloat16, device=card)
    kw = dict(causal=causal, window=window, softcap=softcap)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert dict(ops.launch_counts) == {"flash_attention": 1}
    assert dict(ops.route_counts) == {"flash_attention.split": 1}
    assert out.shape == (B, 1, Hq, Dv) and out.dtype == torch.bfloat16
    assert torch.equal(out, ops.flash_attention(q, k, v, **kw))
    _assert_close(out, tfa.flash_attention_plain(q, k, v, **kw),
                  ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,Dv,causal,window,softcap", [
    (2, 300, 1500, 4, 2, 64, 64, False, None, None),    # Sk 1,500
    (1, 200, 4100, 8, 1, 128, 128, False, None, None),  # Sk 4,100, rep 8
    (2, 256, 256, 4, 4, 80, 80, True, None, None),      # zamba2's D 80
    (1, 300, 300, 4, 2, 192, 128, True, None, None),    # D 192, Dv 128
    (1, 200, 200, 2, 2, 256, 256, True, 70, 30.0),      # D 256: tiles of 64
    (1, 130, 700, 4, 2, 128, 64, True, 100, None),      # fully masked tiles
    (1, 64, 64, 1, 1, 128, 128, True, None, None),      # B Hkv 1, one tile
    (1, 129, 129, 10, 2, 64, 96, True, None, None),     # Dv 96, rep 5
])
def test_flash_wgmma_route_matches_plain(card, B, Sq, Sk, Hq, Hkv, D, Dv,
                                         causal, window, softcap):
    """K5 with more than one bfloat16 query on TMA-addressable heads runs
    the wgmma kernel: within K5's bf16 tolerance of the plain version,
    identical bits on a second call, one launch on ``flash_attention.wgmma``
    (Dv 256 in two CUDA launches); its registers spill nothing, and its
    tile, ring, shared memory and launches are the host plan's."""
    q, k, v = _randn(42, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv),
                     dtype=torch.bfloat16, device=card)
    kw = dict(causal=causal, window=window, softcap=softcap)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert dict(ops.launch_counts) == {"flash_attention": 1}
    assert dict(ops.route_counts) == {"flash_attention.wgmma": 1}
    assert torch.equal(out, ops.flash_attention(q, k, v, **kw))
    _assert_close(out, tfa.flash_attention_plain(q, k, v, **kw),
                  ATTN_TOL[torch.bfloat16])
    info = tfa.flash_attention_wgmma_info(D, Dv)
    assert info["spill_bytes"] == 0
    assert (info["block_k"], info["stages"], info["smem_bytes"],
            info["launches"]) == tfa.wgmma_plan(D, Dv)


@pytest.mark.parametrize("case", ["q off 16 bytes", "k off 16 bytes",
                                  "v off 16 bytes", "D 20", "D 40, Dv 24"])
def test_flash_bf16_tc_takes_what_tma_cannot_address(card, case):
    """A base off the 16-byte grid (a contiguous view one element into a
    buffer) and D 20 (off the 8-column grid), which TMA cannot address,
    and D 40 with Dv 24 (narrower than wgmma's 32 columns) stay on
    mma.sync (``bf16_tc``), within K5's bf16 tolerance of the plain
    version."""
    D, Dv = {"D 20": (20, 20), "D 40, Dv 24": (40, 24)}.get(case, (64, 64))
    B, S, Hq, Hkv = 2, 150, 4, 2
    shapes = {"q": (B, S, Hq, D), "k": (B, S, Hkv, D), "v": (B, S, Hkv, Dv)}
    ts = dict(zip(shapes, _randn(43, *shapes.values(), dtype=torch.bfloat16,
                                 device=card)))
    if case.endswith("16 bytes"):
        name = case[0]
        flat = ts[name].reshape(-1)
        buf = torch.empty(flat.numel() + 1, dtype=torch.bfloat16, device=card)
        buf[1:] = flat
        ts[name] = buf[1:].view(shapes[name])
        assert ts[name].data_ptr() % 16 and ts[name].is_contiguous()
    ops.reset_launch_counts()
    out = ops.flash_attention(ts["q"], ts["k"], ts["v"], window=60)
    torch.cuda.synchronize()
    assert dict(ops.launch_counts) == {"flash_attention": 1}
    assert dict(ops.route_counts) == {"flash_attention.bf16_tc": 1}
    _assert_close(out, tfa.flash_attention_plain(ts["q"], ts["k"], ts["v"],
                                                 window=60),
                  ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 512, 2, 512, 1, 64, 256),      # chunk 256 x p 512: three p slabs
    (1, 300, 2, 1024, 1, 64, 128),     # chunk 128 x p 1,024: three slabs
])
def test_ssd_bf16_in_slabs_of_p_matches_plain(card, b, s, h, p, g, n, chunk):
    """bf16 K7 where one block of the whole p would pass 227 KB runs slabs
    of p as launches of their own (counted as one call on ``bf16_tc``):
    within K7's bf16 tolerance of the plain version, the state within
    1e-4, each slab's shared memory the host plan's."""
    rng = np.random.default_rng(44)
    x, B, C = _randn(44, (b, s, h, p), (b, s, g, n), (b, s, g, n),
                     dtype=torch.bfloat16, device=card)
    B, C = B * 0.3, C * 0.3
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    dt = f32(np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5)
    A = f32(-np.exp(rng.standard_normal(h) * 0.3))
    D = f32(np.ones(h))
    plan = tssd.ssd_scan_plan(chunk, p, n, torch.bfloat16)
    assert len(plan["p_slabs"]) > 1
    ops.reset_launch_counts()
    y, st = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    torch.cuda.synchronize()
    assert dict(ops.launch_counts) == {"ssd_scan": 1}
    assert dict(ops.route_counts) == {"ssd_scan.bf16_tc": 1}
    y_p, st_p = tssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    _assert_close(y, y_p, SSD_TOL[torch.bfloat16])
    _assert_close(st, st_p, 1e-4)
    width = plan["p_slabs"][0][1]
    assert tssd.ssd_scan_smem_bytes(chunk, width, n, torch.bfloat16) == \
        plan["smem_bytes"]


@pytest.mark.parametrize("V,n_buckets", [(400_000, 1), (400_000, 16),
                                         (30_000, 1), (30_000, 5)])
def test_entropy_cluster_kernel_large_vocab_is_repeatable(card, V, n_buckets):
    """K2's cluster kernel on a vocabulary larger than one cluster's share
    (400,000 values: two slices at one bucket, many at 16) and on one that
    fits a block (replicated at one bucket, spread at five), with hot
    values: normwise within 1e-5 of the float64 plain version and
    bit-identical on a second call."""
    rng = np.random.default_rng(V + n_buckets)
    N, M = 3, 300_000
    codes = np.full((N, M), -1, np.int32)
    n_valid = np.array([M, 120_001, 0], np.int32)
    for i in range(N):
        c = np.minimum(rng.zipf(1.3, n_valid[i]) - 1, V - 1)
        c[::7] = rng.integers(0, V, c[::7].shape)
        codes[i, :n_valid[i]] = c
    n_cols = np.array([3, 1, 2], np.int32)
    args = [torch.as_tensor(a, device=card) for a in
            (codes, n_valid, n_valid // np.maximum(n_cols, 1), n_cols,
             rng.integers(1, 12, (N, V)).astype(np.float32))]
    ops.reset_launch_counts()
    s1, b1 = ops.weighted_entropy_features(*args, n_buckets=n_buckets,
                                           device=card)
    s2, b2 = ops.weighted_entropy_features(*args, n_buckets=n_buckets,
                                           device=card)
    torch.cuda.synchronize()
    assert ops.launch_counts["entropy_features"] == 2
    assert torch.equal(s1, s2) and torch.equal(b1, b2)
    s_d, b_d = tef.weighted_entropy_features_plain(
        *args, n_buckets=n_buckets, dtype=torch.float64)
    for got, want in ((s1, s_d), (b1, b_d)):
        rel = (got.double() - want).abs().max() / want.abs().max()
        assert float(rel) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,skip", [
    (1, 64, 2, 8, 1, 16, 16, True),
    (2, 48, 4, 16, 2, 8, 16, True),      # grouped B/C, non-multiple seq
    (1, 100, 3, 8, 1, 8, 32, True),      # ragged tail chunk
    (2, 300, 4, 64, 1, 64, 128, True),   # zamba2's widths, tail chunk
    (1, 256, 2, 64, 1, 128, 128, False), # mamba2-780m's state, no skip
    (1, 64, 2, 8, 1, 8, 16, True),       # p = n = 8: tiles padded to 16
    (1, 256, 80, 64, 1, 64, 128, True),  # zamba2's 80 heads on one group
])
def test_ssd_kernel_matches_plain(card, b, s, h, p, g, n, chunk, skip, dtype):
    rng = np.random.default_rng(13)
    x, B, C = _randn(13, (b, s, h, p), (b, s, g, n), (b, s, g, n),
                     dtype=dtype, device=card)
    B, C = B * 0.5, C * 0.5
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    dt = f32(np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5)
    A = f32(-np.exp(rng.standard_normal(h) * 0.3))
    D = f32(np.ones(h)) if skip else None
    ops.reset_launch_counts()
    y, st = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts["ssd_scan"] == 1
    assert dict(ops.route_counts) == {f"ssd_scan.{_build.ROUTES[dtype]}": 1}
    y_p, st_p = tssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    _assert_close(y, y_p, SSD_TOL[dtype])
    _assert_close(st, st_p, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,Dv,causal,window,softcap", [
    (1, 40, 40, 4, 2, 320, 288, True, None, None),     # D, Dv above 256
    (2, 33, 70, 4, 4, 272, 256, True, 20, 30.0),       # window, softcap
    (1, 24, 24, 2, 1, 128, 300, False, None, None),    # only Dv wide
    (1, 100, 100, 4, 2, 320, 288, True, None, None),   # Sq not 64's multiple
    (2, 70, 200, 4, 2, 320, 288, True, None, None),    # Sq < Sk
    (1, 200, 200, 2, 2, 320, 320, True, 70, None),     # window across tiles
    (1, 130, 130, 4, 4, 288, 288, True, None, 30.0),   # softcap
    (2, 128, 128, 8, 2, 320, 320, True, None, None),   # GQA 4:1
    (1, 96, 96, 4, 1, 320, 256, True, None, None),     # MQA
    (1, 80, 80, 4, 2, 128, 300, True, None, None),     # Dv 300 with D 128
    (1, 70, 70, 2, 1, 640, 512, True, None, None),     # D 640, Dv 512
    (1, 100, 150, 4, 2, 320, 288, False, None, None),  # non-causal
    (1, 100, 612, 4, 1, 640, 300, True, 70, 30.0),     # every tile edge
    (1, 65, 90, 2, 1, 330, 290, True, 40, None),       # D, Dv not 8's
])
def test_wide_flash_route_matches_plain(card, B, Sq, Sk, Hq, Hkv, D, Dv,
                                        causal, window, softcap, dtype):
    """K5 above D or Dv 256 takes the wide route (bfloat16:
    attention_wide_tc.cu, D in chunks and Dv in slices on mma.sync;
    float32: attention_wide.cu), within K5's tolerance of the plain
    version, one launch counted on ``flash_attention.wide``, the same bits
    twice."""
    q, k, v = _randn(31, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv),
                     dtype=dtype, device=card)
    kw = dict(causal=causal, window=window, softcap=softcap)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert dict(ops.launch_counts) == {"flash_attention": 1}
    assert dict(ops.route_counts) == {"flash_attention.wide": 1}
    assert out.dtype == dtype and out.shape == (B, Sq, Hq, Dv)
    assert torch.equal(out, ops.flash_attention(q, k, v, **kw))
    _assert_close(out, tfa.flash_attention_plain(q, k, v, **kw),
                  ATTN_TOL[dtype])


@pytest.mark.parametrize("skew", ["q", "k", "v"])
def test_wide_flash_bf16_route_takes_a_misaligned_base_pointer(card, skew):
    """An operand whose base lies 2 bytes off the 16-byte grid (a
    contiguous view one element into a buffer) stages through plain loads,
    within K5's tolerance of the plain version."""
    B, S, Hq, Hkv, D, Dv = 1, 90, 4, 2, 320, 288
    shapes = {"q": (B, S, Hq, D), "k": (B, S, Hkv, D), "v": (B, S, Hkv, Dv)}
    ts = dict(zip(shapes, _randn(36, *shapes.values(), dtype=torch.bfloat16,
                                 device=card)))
    flat = ts[skew].reshape(-1)
    buf = torch.empty(flat.numel() + 1, dtype=torch.bfloat16, device=card)
    buf[1:] = flat
    ts[skew] = buf[1:].view(shapes[skew])
    assert ts[skew].data_ptr() % 16 and ts[skew].is_contiguous()
    ops.reset_launch_counts()
    out = ops.flash_attention(ts["q"], ts["k"], ts["v"], window=50)
    torch.cuda.synchronize()
    assert dict(ops.route_counts) == {"flash_attention.wide": 1}
    _assert_close(out, tfa.flash_attention_plain(ts["q"], ts["k"], ts["v"],
                                                 window=50),
                  ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv,latent,window,softcap,lens", [
    (3, 150, 8, 2, 640, 576, False, None, None, [150, 1, 0]),
    (2, 97, 16, 1, 640, 576, True, None, None, [97, 40]),   # v inside k
    (2, 120, 4, 4, 700, 320, False, 30, 20.0, [120, 77]),  # window, cap
])
def test_wide_decode_route_matches_plain(card, B, S, Hq, Hkv, D, Dv, latent,
                                         window, softcap, lens, dtype):
    """K6 above D 576 or Dv 512 takes the wide route, v read inside k for
    a latent cache: within K6's tolerance of the plain version, 0 where no
    key is visible, the same bits twice."""
    if latent:
        q, cache = _randn(32, (B, Hq, D), (B, S, D), dtype=dtype,
                          device=card)
        k = cache[:, :, None, :]
        v = k[..., :Dv]
    else:
        q, k, v = _randn(32, (B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, Dv),
                         dtype=dtype, device=card)
    kv_len = torch.as_tensor(lens, dtype=torch.int32, device=card)
    kw = dict(window=window, softcap=softcap)
    ops.reset_launch_counts()
    out = ops.decode_attention(q, k, v, kv_len, **kw)
    again = ops.decode_attention(q, k, v, kv_len, **kw)
    torch.cuda.synchronize()
    assert dict(ops.route_counts) == {"decode_attention.wide": 2}
    assert torch.equal(out, again)
    _assert_close(out, tda.decode_attention_plain(q, k, v, kv_len, **kw),
                  ATTN_TOL[dtype])
    assert not out[kv_len == 0].float().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset,window", [(100, None), (100, 150), (0, 60)])
def test_wide_decode_partials_route_matches_plain(card, offset, window,
                                                  dtype):
    """K6's partials mode on the wide route: a slice of 100 keys of a
    latent cache of 640 columns (v its first 576) at global offset, the
    window measured from the global length; (acc, m, l) against the plain
    version, rows without a visible key exact."""
    B, Hq, D, Dv, n = 4, 16, 640, 576, 100
    q, cache = _randn(33, (B, Hq, D), (B, n, D), dtype=dtype, device=card)
    ks = cache[:, :, None, :]
    vs = ks[..., :Dv]
    lens = torch.as_tensor([200, offset + 37, 5, offset + 100],
                           dtype=torch.int32, device=card)
    local = torch.clamp(lens - offset, 0, n).to(torch.int32)
    kw = dict(offset=offset, global_len=lens, window=window)
    ops.reset_launch_counts()
    acc, m, l = ops.decode_attention_partials(q, ks, vs, local, **kw)
    torch.cuda.synchronize()
    assert dict(ops.route_counts) == {"decode_attention.partials_wide": 1}
    acc_p, m_p, l_p = tda.decode_attention_partials_plain(q, ks, vs, local,
                                                          **kw)
    seen = l_p > 0
    assert torch.equal(seen, l > 0)
    assert torch.equal(m[~seen], m_p[~seen]) and not acc[~seen].any()
    _assert_close(m[seen], m_p[seen], 1e-5)
    _assert_close(l[seen], l_p[seen], 1e-4)
    _assert_close(acc[seen] / l[seen][:, None],
                  acc_p[seen] / l_p[seen][:, None], ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "bf16_tc"),
                                         (torch.float32, "f32")])
@pytest.mark.parametrize("s,chunk", [(150, 64), (70, 32)])
def test_wide_ssd_state_matches_plain(card, s, chunk, dtype, route):
    """K7 at n 320: bfloat16 takes the tensor-core route with B, C and the
    state in slabs of 128 columns, float32 the CUDA-core route; both
    within K7's tolerance."""
    b, h, p, g, n = 2, 4, 64, 1, 320
    rng = np.random.default_rng(34)
    x, B, C = _randn(34, (b, s, h, p), (b, s, g, n), (b, s, g, n),
                     dtype=dtype, device=card)
    B, C = B * 0.3, C * 0.3
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    dt = f32(np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5)
    A = f32(-np.exp(rng.standard_normal(h) * 0.3))
    D = f32(np.ones(h))
    ops.reset_launch_counts()
    y, st = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    torch.cuda.synchronize()
    assert dict(ops.route_counts) == {f"ssd_scan.{route}": 1}
    y_p, st_p = tssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    _assert_close(y, y_p, SSD_TOL[dtype])
    _assert_close(st, st_p, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 300, 4, 64, 1, 320, 128),    # n 320 at chunk 128 (f32 raised)
    (1, 256, 2, 256, 1, 64, 128),    # p 256 with n 64
    (2, 300, 2, 64, 1, 128, 256),    # chunk 256 with n 128
    (1, 200, 3, 40, 1, 600, 64),     # n 600: five slabs, p not 16's
    (1, 128, 2, 256, 1, 320, 64),    # p 256 at n 320: two p blocks a slab
    (1, 90, 2, 20, 1, 260, 112),     # a chunk longer than the sequence
])
def test_ssd_kernel_at_any_shape_matches_plain(card, b, s, h, p, g, n, chunk,
                                               dtype):
    """K7 at shapes its kernels once refused: the float32 CUDA-core route
    in 32 x 32 tiles and the bfloat16 tensor-core route (B, C and the
    state in slabs above n 256) within K7's tolerance of the plain
    version, each shape's shared memory the host plan's."""
    rng = np.random.default_rng(35)
    x, B, C = _randn(35, (b, s, h, p), (b, s, g, n), (b, s, g, n),
                     dtype=dtype, device=card)
    B, C = B * 0.3, C * 0.3
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    dt = f32(np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5)
    A = f32(-np.exp(rng.standard_normal(h) * 0.3))
    D = f32(np.ones(h))
    ops.reset_launch_counts()
    y, st = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    torch.cuda.synchronize()
    assert dict(ops.route_counts) == {f"ssd_scan.{_build.ROUTES[dtype]}": 1}
    y_p, st_p = tssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    _assert_close(y, y_p, SSD_TOL[dtype])
    _assert_close(st, st_p, 1e-4)
    assert tssd.ssd_scan_smem_bytes(chunk, p, n, dtype) == \
        tssd.ssd_scan_plan(chunk, p, n, dtype)["smem_bytes"]


def _small_partitions(N, V=23, M=8, seed=0):
    rng = np.random.default_rng(seed)
    n_cols = rng.integers(1, 3, N).astype(np.int32)
    n_rows = (M // n_cols).astype(np.int32)
    n_valid = n_rows * n_cols
    codes = rng.integers(-1, V, (N, M)).astype(np.int32)
    codes[np.arange(M)[None, :] >= n_valid[:, None]] = -1
    lengths = rng.integers(1, 12, V).astype(np.float32)
    return codes, n_valid, n_rows, n_cols, lengths


def _normwise(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def test_entropy_kernel_over_65535_partitions(card):
    """K2 on 70,000 small partitions (two cluster launches, past the 65,535
    of a grid's second dimension): within 1e-5 normwise of the float64
    plain version, and each partition's bits those of the kernel on the
    first and second 35,000 alone."""
    args = [torch.as_tensor(a, device=card) for a in _small_partitions(70_000)]
    ops.reset_launch_counts()
    s, b = tef.weighted_entropy_features_kernel(*args, n_buckets=3)
    halves = [tef.weighted_entropy_features_kernel(
        *[a[sl] for a in args[:4]], args[4], n_buckets=3)
        for sl in (slice(0, 35_000), slice(35_000, None))]
    torch.cuda.synchronize()
    assert ops.launch_counts["entropy_features"] == 3
    assert torch.equal(s, torch.cat([h[0] for h in halves]))
    assert torch.equal(b, torch.cat([h[1] for h in halves]))
    s_d, b_d = tef.weighted_entropy_features_plain(*args, n_buckets=3,
                                                   dtype=torch.float64)
    assert _normwise(s, s_d) <= 1e-5 and _normwise(b, b_d) <= 1e-5


@pytest.mark.parametrize("n_buckets,V", [(24, 23), (5_000, 23),
                                         (24, 30_000), (5_000, 5),
                                         (5_000, 12)])
def test_entropy_kernel_over_16_buckets(card, n_buckets, V):
    """K2 at 24 buckets (the bucket arrays sized in dynamic shared memory;
    a replicated plan at V 23, a distributed one at V 30,000) and at 5,000
    (two passes of at most 4,096: distributed at V 23, replicated at V 5
    and 12, where a block owns ceil(V / 8) values): within 1e-5 normwise
    of the float64 plain version, the same bits twice; where both plans
    are replicated, the summary has the bits of the one-bucket call (the
    same order, each value's count summed over the passes exactly)."""
    rng = np.random.default_rng(n_buckets + V)
    N, M = 5, 12_000
    n_cols = np.array([3, 1, 2, 4, 1], np.int32)
    n_valid = np.array([M, 7_001, 9_998, 0, 5], np.int32)
    codes = rng.integers(-1, V, (N, M)).astype(np.int32)
    codes[np.arange(M)[None, :] >= n_valid[:, None]] = -1
    args = [torch.as_tensor(a, device=card) for a in
            (codes, n_valid, n_valid // n_cols, n_cols,
             rng.integers(1, 12, (N, V)).astype(np.float32))]
    s1, b1 = tef.weighted_entropy_features_kernel(*args, n_buckets=n_buckets)
    s2, b2 = tef.weighted_entropy_features_kernel(*args, n_buckets=n_buckets)
    torch.cuda.synchronize()
    assert torch.equal(s1, s2) and torch.equal(b1, b2)
    s_d, b_d = tef.weighted_entropy_features_plain(
        *args, n_buckets=n_buckets, dtype=torch.float64)
    assert _normwise(s1, s_d) <= 1e-5 and _normwise(b1, b_d) <= 1e-5
    if tef._plan(V, n_buckets, M)[0]:
        one, _ = tef.weighted_entropy_features_kernel(*args, n_buckets=1)
        assert torch.equal(s1, one)
    info = tef.weighted_entropy_features_info(V, n_buckets, M)
    assert info["passes"] == len(tef.bucket_passes(n_buckets))
    assert info["smem_bytes"] == tef.plan_smem_bytes(V, n_buckets, M)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv,latent,window,softcap,lens", [
    (2, 130, 4, 1, 640, 520, False, None, None, [130, 0]),  # rows padded
    (2, 200, 40, 1, 600, 576, True, 50, None, [200, 77]),  # 3 head tiles
    (3, 1030, 16, 1, 640, 576, True, 300, 20.0, [1030, 700, 5]),  # splits
    (1, 300, 8, 2, 580, 516, False, None, None, [1000]),  # kv_len past S
    (2, 96, 8, 1, 644, 522, False, 40, None, [96, 3]),    # Dv not 8's
    (3, 50, 16, 1, 640, 576, True, None, None, [50, 17, 0]),  # one split
])
def test_wide_decode_bf16_tensor_cores_edges(card, B, S, Hq, Hkv, D, Dv,
                                             latent, window, softcap, lens):
    """K6's bfloat16 wide route (decode_attention_wide_tc.cu) at its
    edges: heads padded in an m16 tile or over several tiles, key splits
    with a window that leaves splits empty, kv_len past the cache, Dv and
    D off the 16-byte grid (plain loads); within K6's bf16 tolerance of
    the plain version, 0 where no key is visible, the same bits twice;
    and its partials mode on the same operands."""
    dtype = torch.bfloat16
    if latent:
        q, cache = _randn(37, (B, Hq, D), (B, S, D), dtype=dtype,
                          device=card)
        k = cache[:, :, None, :]
        v = k[..., :Dv]
    else:
        q, k, v = _randn(37, (B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, Dv),
                         dtype=dtype, device=card)
    kv_len = torch.as_tensor(lens, dtype=torch.int32, device=card)
    kw = dict(window=window, softcap=softcap)
    ops.reset_launch_counts()
    out = ops.decode_attention(q, k, v, kv_len, **kw)
    again = ops.decode_attention(q, k, v, kv_len, **kw)
    local = torch.clamp(kv_len, 0, S).to(torch.int32)
    acc, m, l = ops.decode_attention_partials(q, k, v, local, offset=0,
                                              global_len=kv_len, **kw)
    torch.cuda.synchronize()
    assert dict(ops.route_counts) == {"decode_attention.wide": 2,
                                      "decode_attention.partials_wide": 1}
    assert torch.equal(out, again)
    _assert_close(out, tda.decode_attention_plain(q, k, v, kv_len, **kw),
                  ATTN_TOL[dtype])
    assert not out[kv_len == 0].float().any()
    acc_p, m_p, l_p = tda.decode_attention_partials_plain(
        q, k, v, local, offset=0, global_len=kv_len, **kw)
    seen = l_p > 0
    assert torch.equal(seen, l > 0)
    assert torch.equal(m[~seen], m_p[~seen]) and not acc[~seen].any()
    _assert_close(m[seen], m_p[seen], 1e-5)
    _assert_close(l[seen], l_p[seen], 1e-4)
    _assert_close(acc[seen] / l[seen][:, None],
                  acc_p[seen] / l_p[seen][:, None], ATTN_TOL[dtype])


def test_zamba2_serving_on_card_matches_cpu(card):
    """The smoke-size zamba2 in float32: the card's prefill logits and
    greedy tokens equal the CPU's (plain versions), and each kernel ran."""
    cfg = get_config("zamba2-2.7b", smoke=True)
    params = ttr.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    on_card = ttr.tree_map(lambda t: t.to(card), params)
    prompts = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 140)))
    ops.reset_launch_counts()
    logits = make_prefill_step(cfg)(on_card, prompts.to(card))
    assert dict(ops.launch_counts) == {"flash_attention": 2, "ssd_scan": 12}
    assert dict(ops.route_counts) == {"flash_attention.f32": 2,
                                      "ssd_scan.f32": 12}
    _assert_close(logits, make_prefill_step(cfg)(params, prompts), 1e-4)
    runs = {}
    for dev, p in (("cpu", params), (card, on_card)):
        cache = ttr.init_cache(cfg, 2, 150, device=dev)
        runs[str(dev)] = serve(make_decode_step(cfg), p, cache,
                               prompts[:, :20].to(dev), 5)
    assert torch.equal(runs["cuda"].tokens.cpu(), runs["cpu"].tokens)
    assert ops.launch_counts["decode_attention"] == 2 * 24


def test_zamba2_bf16_prefill_takes_the_tensor_core_route(card):
    """The smoke-size zamba2 in bfloat16 on the card: K5 runs its wgmma
    route and K7 its tensor-core route, and the logits agree with the same prefill through
    the plain versions within chip_smoke.py's bfloat16 bar (0.15
    normwise)."""
    cfg = get_config("zamba2-2.7b", smoke=True).scaled(dtype="bfloat16")
    params = ttr.init_params(torch.Generator(device=card).manual_seed(0),
                             cfg, device=card)
    prompts = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 140)), device=card)
    ops.reset_launch_counts()
    logits = make_prefill_step(cfg)(params, prompts)
    torch.cuda.synchronize()
    assert dict(ops.launch_counts) == {"flash_attention": 2, "ssd_scan": 12}
    assert dict(ops.route_counts) == {"flash_attention.wgmma": 2,
                                      "ssd_scan.bf16_tc": 12}
    swapped = {"flash_attention": tfa.flash_attention_plain,
               "ssd_scan": lambda *a, **k: tssd.ssd_scan_plain(*a, **k)}
    orig = {n: getattr(ops, n) for n in swapped}
    try:
        for n, fn in swapped.items():
            setattr(ops, n, fn)
        plain = make_prefill_step(cfg)(params, prompts)
    finally:
        for n, fn in orig.items():
            setattr(ops, n, fn)
    assert bool(logits.isfinite().all())
    err = (logits.float() - plain.float()).abs().max() \
        / plain.float().abs().max()
    assert float(err) <= 0.15


def test_zamba2_train_step_on_card_matches_cpu(card):
    """Two smoke-size zamba2 train steps (float32, remat, int8 error
    feedback) on the card and on the CPU: losses within rel 1e-4 and the
    moments within 5e-3 normwise (a last-bit difference can move a value
    across an int8 rounding boundary); the card runs K5 and K7 twice per
    forward (remat) and K3 once per leaf."""
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.training import train_step as tts
    from repro_torch.training.optimizer import AdamWState
    cfg = get_config("zamba2-2.7b", smoke=True)
    tcfg = tts.TrainConfig(remat=True, compressed_grads=True)
    cpu = tts.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                               device="cpu")
    to_card = lambda tree: tree_map(lambda t: t.to(card), tree)
    dev = {"params": to_card(cpu["params"]),
           "opt": AdamWState(*(None if x is None else to_card(x)
                               for x in cpu["opt"]))}
    n_leaves = len(tree_leaves(cpu["params"]))
    step = tts.make_train_step(cfg, tcfg)
    rng = np.random.default_rng(4)
    for i in range(2):
        tok = rng.integers(0, cfg.vocab_size, (4, 33))
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        cpu, m_c = step(cpu, batch)
        ops.reset_launch_counts()
        dev, m_d = step(dev, batch)
        torch.cuda.synchronize()
        assert dict(ops.launch_counts) == {"flash_attention": 4,
                                           "ssd_scan": 24,
                                           "quant_pack": n_leaves}
        assert dict(ops.route_counts) == {"flash_attention.f32": 4,
                                          "ssd_scan.f32": 24}
        assert float(m_d["loss"]) == pytest.approx(float(m_c["loss"]),
                                                   rel=1e-4)
    for a, b in zip(tree_leaves(dev["opt"].m), tree_leaves(cpu["opt"].m)):
        assert float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30)) <= 5e-3


@pytest.mark.parametrize("shape,scale", [((4, 256), 5.0), ((1024,), 1.0),
                                         ((3, 2, 512), 30.0),
                                         ((2051, 256), 1e-3)])
def test_quant_pack_kernel_matches_plain(card, shape, scale):
    """Identical int8 values and scales (the kernel divides and rounds half
    to even as the plain version does)."""
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(shape)
                        .astype(np.float32) * scale, device=card)
    x.view(-1)[:256] = 0.0                       # an all-zero block
    x.view(-1)[256:261] = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5])
    ops.reset_launch_counts()
    q, s = ops.quant_pack(x)
    torch.cuda.synchronize()
    assert ops.launch_counts["quant_pack"] == 1
    q_p, s_p = tqp.quant_pack_plain(x)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    assert q.view(-1)[256:261].tolist() == [127, 0, 2, 2, -2]
    assert not q.view(-1)[:256].any()


@pytest.mark.parametrize("n,offset", [(0, 0), (1, 0), (37, 3), (4097, 1),
                                      (1 << 20, 0), ((1 << 22) + 5, 7)])
def test_byte_entropy_kernel_matches_plain(card, n, offset):
    """Identical histograms and the entropy within rel 1e-5, for payloads
    that start off the 16-byte grid and end off it."""
    buf = torch.as_tensor(np.random.default_rng(n).integers(
        0, 256, n + offset).astype(np.uint8), device=card)
    data = buf[offset:]
    ops.reset_launch_counts()
    h, e = tef.byte_entropy_kernel(data)
    torch.cuda.synchronize()
    assert ops.launch_counts["byte_entropy"] == 1
    h_p, e_p = tef.byte_entropy_plain(data)
    assert torch.equal(h, h_p)
    assert float(e) == pytest.approx(float(e_p), rel=1e-5, abs=1e-7)
    for k, bits in ((1, 0.0), (2, 1.0), (4, 2.0), (256, 8.0)):
        d = torch.arange(k, dtype=torch.uint8, device=card).repeat(300)
        assert float(ops.byte_entropy(d, device=card)[1]) == \
            pytest.approx(bits, abs=1e-5)


def _bf16_weights(n_bytes):
    g = torch.Generator().manual_seed(5)
    w = (torch.randn(n_bytes // 2, generator=g) * 0.02).bfloat16()
    return w.view(torch.uint8)


@pytest.mark.parametrize("payload", ["bf16 weights", "constant", "2 symbols",
                                     "unaligned start", "n=1"])
def test_byte_entropy_kernel_is_one_launch_and_repeatable(card, payload):
    """K4's histogram identical to the plain version's and the entropy
    within rel 1e-5; the same bits on a second call; one CUDA launch (no
    memset) per call and no host synchronisation."""
    from torch.profiler import ProfilerActivity, profile
    data = {"bf16 weights": lambda: _bf16_weights(4 << 20),
            "constant": lambda: torch.full((3000,), 7, dtype=torch.uint8),
            "2 symbols": lambda: torch.arange(2, dtype=torch.uint8).repeat(
                5000),
            "unaligned start": lambda: _bf16_weights(1 << 20)[5:],
            "n=1": lambda: torch.tensor([200], dtype=torch.uint8),
            }[payload]().to(card)
    h, e = tef.byte_entropy_kernel(data)        # makes the stream's counter
    torch.cuda.set_sync_debug_mode("error")
    try:
        h2, e2 = tef.byte_entropy_kernel(data)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    h_p, e_p = tef.byte_entropy_plain(data)
    assert torch.equal(h, h_p)
    assert float(e) == pytest.approx(float(e_p), rel=1e-5, abs=1e-7)
    assert torch.equal(h, h2) and torch.equal(e, e2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tef.byte_entropy_kernel(data)
        torch.cuda.synchronize()
    on_card = [ev.name for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    calls = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CPU
             and ev.name.startswith(("cudaLaunch", "cudaMemset",
                                     "cudaMemcpy"))]
    assert len(calls) == 1 and len(on_card) <= 1, (calls, on_card)
    assert all("byte_entropy" in name for name in on_card), on_card


@pytest.mark.parametrize("seed", [0, 1])
def test_byte_entropy_kernel_leaves_its_totals_at_zero(card, seed):
    """The bin totals and completion counter the blocks meet in are left at
    0 by every launch: payloads on one block, on 9 and on one per SM, in
    turn, each give the plain version's counts."""
    rng = np.random.default_rng(seed)
    for n in (3, 70_001, 5 << 20, 3):
        data = torch.as_tensor(rng.integers(0, 256, n).astype(np.uint8),
                               device=card)
        h, e = tef.byte_entropy_kernel(data)
        h_p, e_p = tef.byte_entropy_plain(data)
        assert torch.equal(h, h_p)
        assert float(e) == pytest.approx(float(e_p), rel=1e-5, abs=1e-7)


def test_attention_and_ssd_gradients_on_card(card):
    """The autograd Functions on the card: gradients through the kernels'
    forwards equal autograd through the plain versions, float32, 1e-4."""
    q, k, v = _randn(21, (2, 96, 8, 32), (2, 96, 2, 32), (2, 96, 2, 32),
                     device=card)
    go = _randn(22, (2, 96, 8, 32), device=card)[0]
    kw = dict(causal=True, window=40, softcap=30.0)
    ins = [t.requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    g_k = torch.autograd.grad(ops.flash_attention(*ins, **kw), ins, go)
    assert dict(ops.launch_counts) == {"flash_attention": 1}
    assert dict(ops.route_counts) == {"flash_attention.f32": 1}
    g_p = torch.autograd.grad(tfa.flash_attention_plain(*ins, **kw), ins, go)
    for a, b in zip(g_k, g_p):
        _assert_close(a, b, 1e-4)
    rng = np.random.default_rng(23)
    x, B, C = _randn(23, (2, 200, 4, 16), (2, 200, 1, 16), (2, 200, 1, 16),
                     device=card)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    dt = f32(np.log1p(np.exp(rng.standard_normal((2, 200, 4)))) * 0.5)
    A, D = f32(-np.exp(rng.standard_normal(4) * 0.3)), f32(np.ones(4))
    ins = [t.requires_grad_() for t in (x, dt, A, B * 0.5, C * 0.5, D)]
    ops.reset_launch_counts()
    y, st = ops.ssd_scan(*ins, chunk=64)
    g_k = torch.autograd.grad(y.sum() + st.sum(), ins)
    assert dict(ops.launch_counts) == {"ssd_scan": 1}
    assert dict(ops.route_counts) == {"ssd_scan.f32": 1}
    y, st = tssd.ssd_scan_plain(*ins, chunk=64)
    g_p = torch.autograd.grad(y.sum() + st.sum(), ins)
    for a, b in zip(g_k, g_p):
        _assert_close(a, b, 1e-4)


# ------------------------------------------------------------------ fleet
def _bench_fleet(T, mean_n, seed):
    """The fleet benchmark's recipe: T ragged Azure tenants, K 3, the
    greedy-hottest tier capped at 90% of its greedy use."""
    rng = np.random.default_rng(seed)
    table = azure_table()
    out = []
    for _ in range(T):
        N = int(rng.integers(max(1, mean_n // 2), 2 * mean_n))
        spans = rng.uniform(0.5, 50.0, N)
        rho = rng.gamma(1.0, 20.0, N)
        cur = rng.integers(-1, table.num_tiers, N)
        R = np.concatenate([np.ones((N, 1)), rng.uniform(1.2, 6.0, (N, 2))],
                           1)
        D = np.concatenate([np.zeros((N, 1)),
                            rng.uniform(0.01, 3.0, (N, 2))], 1)
        lat = rng.choice([0.1, 1.0, 5.0, np.inf], N)
        cost = cost_tensor(spans, rho, cur, R, D, table, Weights(), months=6)
        feas = latency_feasible(D, lat, table)
        stored = np.repeat((spans[:, None] / R)[:, None, :], 4, 1)
        cell = np.where(feas, cost, np.inf).reshape(N, -1).argmin(1)
        use = topt._chosen_usage(stored, cell // 3, cell % 3)
        cap = np.full(4, np.inf)
        cap[use.argmax()] = 0.9 * use.max()
        out.append((cost, feas, stored, cap))
    return out


def _scan_args(fleet, shared_frac=None):
    """``_fleet_scan``'s arguments for ``fleet``; with ``shared_frac`` the
    per-tenant caps are lifted and the fleet's most used tier is capped
    fleet-wide at that fraction of its greedy use."""
    T, L, K = len(fleet), 4, 3
    n_max = max(c.shape[0] for c, _, _, _ in fleet)
    m = np.full((T, n_max, L, K), topt.BIG)
    s = np.zeros((T, n_max, L, K))
    cap = np.full((T, L), np.inf)
    use = np.zeros(L)
    for t, (c, f, st, cp) in enumerate(fleet):
        n = c.shape[0]
        m[t, :n], s[t, :n] = topt._masked(c, f), st
        cell = m[t, :n].reshape(n, -1).argmin(1)
        use += topt._chosen_usage(st, cell // K, cell % K)
        if shared_frac is None:
            cap[t] = cp
    scap = np.array([np.inf])
    sg = np.zeros(L, np.int64)
    if shared_frac is not None:
        sg, scap = np.arange(L), np.full(L, np.inf)
        scap[use.argmax()] = shared_frac * use.max()
    step = np.zeros(T)
    for t in range(T):
        A, ca = topt._constraint_rows(cap[t], None, None)
        step[t] = topt._step0(m[t], ca, np.isfinite(ca))
    sstep = float(m[m < topt.BIG].mean() / scap[np.isfinite(scap)].mean()) \
        if shared_frac is not None else 0.0
    return (m, s, cap, np.zeros(L, np.int64), np.full((T, 1), np.inf), sg,
            scap, step, sstep, 200)


@pytest.mark.parametrize("shared_frac", [None, 0.6])
def test_fleet_scan_cells_on_card_match_cpu(card, shared_frac):
    """The batched dual ascent's cells, uncoupled and coupled by a shared
    cap, are the same on the card and on the CPU (the fleet-wide sum has
    one pinned order on both), and the same on a second card run."""
    args = _scan_args(_bench_fleet(48, 24, 5), shared_frac)
    got = topt._fleet_scan(*args, card)
    np.testing.assert_array_equal(got, topt._fleet_scan(*args, "cpu"))
    np.testing.assert_array_equal(got, topt._fleet_scan(*args, card))
    assert len(np.unique(got[:, 0], axis=0)) > 1    # the duals moved


@pytest.mark.parametrize("shared", [False, True])
def test_fleet_batch_on_card_matches_cpu(card, shared):
    fleet = _bench_fleet(64, 24, 64)
    cols = [[x[i] for x in fleet] for i in range(4)]
    kw = {}
    if shared:
        # lift the tenants' caps; cap the fleet's most used tier at 70%
        scap = _scan_args(fleet, 0.7)[6]
        cols[3] = [np.full(4, np.inf)] * len(fleet)
        kw = dict(shared_tier_groups=np.arange(4), shared_capacity_gb=scap)
    a = topt.capacitated_assign_batch(*cols, device=card, **kw)
    b = topt.capacitated_assign_batch(*cols, device="cpu", **kw)
    assert a.feasible and b.feasible
    for x, y in zip(a.assignments, b.assignments):
        np.testing.assert_array_equal(x.tier, y.tier)
        np.testing.assert_array_equal(x.scheme, y.scheme)
        assert x.cost == pytest.approx(y.cost, rel=1e-6)
    g_k = topt.greedy_assign_batch(cols[0], cols[1], device=card)
    g_c = topt.greedy_assign_batch(cols[0], cols[1], device="cpu")
    for x, y in zip(g_k, g_c):
        np.testing.assert_array_equal(x.tier, y.tier)
        np.testing.assert_array_equal(x.scheme, y.scheme)


def test_streaming_engine_on_card_matches_cpu(card):
    w = twl.generate_workload(n_datasets=80, n_months=8, seed=7)
    reports = {}
    for dev in ("cuda", "cpu"):
        eng = teng.StreamingEngine(
            azure_table(), teng.ScopeConfig(use_compression=False, months=1.0,
                                            device=dev),
            twl.dataset_file_sizes(w), drift_threshold=0.5)
        for batch in twl.stream_query_log(w, np.random.default_rng(7)):
            eng.ingest_and_reoptimize(batch, months=1.0)
        reports[dev] = (eng.history, eng.plan)
    (ha, pa), (hb, pb) = reports["cuda"], reports["cpu"]
    for a, b in zip(ha, hb):
        assert (a.n_partitions, a.n_new, a.n_moved, a.compacted,
                a.n_deferred) == (b.n_partitions, b.n_new, b.n_moved,
                                  b.compacted, b.n_deferred)
        assert a.steady_cents == pytest.approx(b.steady_cents, rel=1e-6)
    np.testing.assert_array_equal(pa.assignment.tier, pb.assignment.tier)


def test_placement_entry_points_raise_without_a_card():
    """Asking for the card where there is none raises, before any work;
    runs only where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    cfg = teng.ScopeConfig(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        teng.StreamingEngine(azure_table(), cfg, {"a": 1.0})
    with pytest.raises(RuntimeError, match="cuda"):
        tfleet.FleetEngine(azure_table(), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tfc.AccessForecaster(azure_table())
    fleet = _bench_fleet(2, 4, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        topt.capacitated_assign_batch(*[[x[i] for x in fleet]
                                        for i in range(4)])
    with pytest.raises(RuntimeError, match="cuda"):
        topt.greedy_assign_batch([fleet[0][0]], [fleet[0][1]])
