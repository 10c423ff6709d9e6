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
    within the JAX suite's tolerance of the plain version where a key is
    visible, exactly 0 where none is, and bit-identical on a second call
    (no float atomics)."""
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
    seen = kv_len > 0
    _assert_close(out[seen], tda.decode_attention_plain(q, k, v, kv_len,
                                                        **kw)[seen],
                  ATTN_TOL[dtype])
    assert not out[~seen].float().any()


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
