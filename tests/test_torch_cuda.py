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
from repro_torch.core import ml as tml
from repro_torch.core import optassign as topt
from repro_torch.core import scope as tscope
from repro_torch.core.costs import azure_table, big3_table
from repro_torch.data import tpch
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
    assert dict(ops.route_counts) == {
        f"flash_attention.{_build.ROUTES[dtype]}": 1}
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
    """The smoke-size zamba2 in bfloat16 on the card: K5 and K7 run their
    tensor-core route, and the logits agree with the same prefill through
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
    assert dict(ops.route_counts) == {"flash_attention.bf16_tc": 2,
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
