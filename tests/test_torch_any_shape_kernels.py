"""K7, K2 and the fleet's usage sum at shapes past their CUDA kernels'
former limits, held against ``repro`` on the CPU, and the host-side tile
plans those kernels follow.

* K7 at chunk 128 with n 320, at p 256 with n 64 and at chunk 256 with n
  128 (shapes where the float32 CUDA-core kernel ran out of shared memory,
  and where the bfloat16 route now stages n in slabs): the plain version
  (which the card's float32 route is held to) and the tensor-core route's
  three passes in their slabs of n (``ssd_scan_chunked``) against the
  Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it:
  float32 within 1e-4 (the JAX suite's SSD tolerance: sums of 128 x 320
  float32 products in two orders); the bfloat16 hi/lo emulation, on inputs
  rounded to bfloat16, with the state within 1e-4 and y within 2e-2 (the
  card's bf16 bars).
* K2 at 17 and 32 buckets (above the 16 the kernel once took): the plain
  version and the kernel's sliced reduction at its plan against the
  Pallas kernel within 1e-5.
* The capacitated fleet solve on a cost table of 150 and 300 tiers (the
  usage-sum kernel took 128): the same tiers, schemes and feasibility as
  the reference, cents within rel 1e-6.
* The plans: each shape's shared memory within a block's 227 KB, and the
  pieces (K7's columns of p and slabs of n, K2's slices, bucket passes and
  launches of partitions, the usage sum's tier windows, the K6 wide
  route's key splits) covering their range exactly once; bf16 K7's slabs
  of p where a block of the whole p would not fit (chunk 256 x p 512,
  chunk 128 x p 1,024), and its slab loop around the plain version
  against the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optassign as jopt
from repro.kernels.entropy_features import weighted_entropy_features as j_wef
from repro.kernels.ssd_scan import ssd_scan as j_ssd
from repro_torch.core import optassign as topt
from repro_torch.kernels import attention_wide as taw
from repro_torch.kernels import entropy_features as tef
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels import usage_sum as tus

F32_TOL = dict(rtol=1e-5, atol=1e-5)
SSD_F32_TOL = dict(rtol=1e-4, atol=1e-4)
SPLIT_TOL = {"y": dict(rtol=2e-2, atol=2e-2),
             "state": dict(rtol=1e-4, atol=1e-4)}
MAX_SMEM = 227 * 1024

SSD_SHAPES = [
    # b, s, h, p, g, n, chunk
    (1, 256, 2, 16, 1, 320, 128),    # n 320 at chunk 128: three slabs
    (1, 256, 1, 256, 1, 64, 128),    # p 256, n 64
    (1, 256, 2, 16, 1, 128, 256),    # chunk 256, n 128
]


def _ssd_inputs(seed, b, s, h, p, g, n, bf16_operands):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    D = np.ones(h, np.float32)
    if bf16_operands:
        x, B, C = (torch.as_tensor(v).bfloat16().float().numpy()
                   for v in (x, B, C))
    return x, dt, A, B, C, D


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_ssd_plain_and_chunked_match_pallas_in_float32(b, s, h, p, g, n,
                                                       chunk):
    a = _ssd_inputs(26, b, s, h, p, g, n, bf16_operands=False)
    y_j, st_j = j_ssd(*(jnp.asarray(v) for v in a), chunk=chunk,
                      interpret=True)
    tens = [torch.as_tensor(v) for v in a]
    for fn in (tssd.ssd_scan_plain, tssd.ssd_scan_chunked):
        y, st = fn(*tens, chunk=chunk)
        assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **SSD_F32_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_j),
                                   **SSD_F32_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_ssd_bf16_route_in_slabs_matches_pallas(b, s, h, p, g, n, chunk):
    """The tensor-core route's passes with its hi/lo splits emulated, in
    its slabs of n above 256, on bfloat16-valued inputs."""
    a = _ssd_inputs(27, b, s, h, p, g, n, bf16_operands=True)
    y, st = tssd.ssd_scan_chunked(*(torch.as_tensor(v) for v in a),
                                  chunk=chunk, split_bf16=True)
    y_j, st_j = j_ssd(*(jnp.asarray(v) for v in a), chunk=chunk,
                      interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **SPLIT_TOL["y"])
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j),
                               **SPLIT_TOL["state"])


def _entropy_inputs(seed=5, N=4, V=23):
    rng = np.random.default_rng(seed)
    n_cols = np.array([2, 1, 3, 2], np.int32)[:N]
    n_rows = rng.integers(20, 90, N).astype(np.int32)
    n_valid = n_rows * n_cols
    codes = np.full((N, int(n_valid.max()) + 3), -1, np.int32)
    for i in range(N):
        codes[i, :n_valid[i]] = rng.integers(-1, V, n_valid[i])
    lengths = rng.integers(1, 9, (N, V)).astype(np.float32)
    return codes, n_valid, n_rows, n_cols, lengths


@pytest.mark.parametrize("n_buckets", [17, 32])
def test_entropy_over_16_buckets_matches_pallas(n_buckets):
    args = _entropy_inputs()
    want_s, want_b = j_wef(*args, n_buckets=n_buckets, block=64,
                           interpret=True)
    tens = [torch.as_tensor(v) for v in args]
    V = args[4].shape[1]
    _, slices, span, per_pass = tef._plan(V, n_buckets, args[0].shape[1])
    assert per_pass == n_buckets
    got = [tef.weighted_entropy_features_plain(*tens, n_buckets=n_buckets),
           tef.weighted_entropy_features_sliced(*tens, n_buckets=n_buckets,
                                                width=span)]
    for s, b in got:
        assert b.shape == (4, n_buckets)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **F32_TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(want_b), **F32_TOL)


def _wide_tenant(rng, N, L, K=3):
    """One tenant over L tiers: random cents, feasibility and stored GB,
    the greedy-hottest tier capped at 90% of its greedy use (so the dual
    ascent and its usage sum run), every other tier uncapped."""
    cost = rng.uniform(1.0, 100.0, (N, L, K))
    feas = rng.random((N, L, K)) > 0.2
    feas[:, 0, 0] = True
    spans = rng.uniform(0.5, 50.0, N)
    R = np.concatenate([np.ones((N, 1)), rng.uniform(1.2, 6.0, (N, K - 1))],
                       1)
    stored = np.repeat((spans[:, None] / R)[:, None, :], L, 1)
    cell = np.where(feas, cost, np.inf).reshape(N, -1).argmin(1)
    use = topt._chosen_usage(stored, cell // K, cell % K)
    cap = np.full(L, np.inf)
    cap[use.argmax()] = 0.9 * use.max()
    return cost, feas, stored, cap


@pytest.mark.parametrize("L", [150, 300])
def test_fleet_over_128_tiers_matches_repro(L):
    rng = np.random.default_rng(L)
    fleet = [_wide_tenant(rng, n, L) for n in (40, 25, 33)]
    cols = [[t[i] for t in fleet] for i in range(4)]
    got = topt.capacitated_assign_batch(*cols, device="cpu")
    ref = jopt.capacitated_assign_batch(*cols)
    assert got.feasible == ref.feasible
    for a, b in zip(got.assignments, ref.assignments):
        np.testing.assert_array_equal(a.tier, b.tier)
        np.testing.assert_array_equal(a.scheme, b.scheme)
        assert a.feasible == b.feasible
        assert a.cost == pytest.approx(b.cost, rel=1e-6)
    assert got.cost == pytest.approx(ref.cost, rel=1e-6)
    assert max(int(a.tier.max()) for a in got.assignments) >= 128


def _covers(pieces, total):
    """The pieces (start, length) lie end to end from 0 to ``total``."""
    at = 0
    for start, length in pieces:
        assert start == at and length > 0
        at += length
    assert at == total


@pytest.mark.parametrize("chunk,p,n", [
    (128, 64, 320), (64, 64, 320), (128, 256, 64), (256, 64, 128),
    (128, 64, 64), (16, 8, 8), (128, 64, 1024), (512, 512, 2048),
    (1000, 100, 700)])
def test_ssd_plans_fit_and_cover(chunk, p, n):
    """float32: 21,120 bytes at every shape, its 32-column slices covering
    p and n once; bfloat16 at the shapes its blocks fit: n whole up to 256,
    else 128-column slabs covering n once."""
    f32 = tssd.ssd_scan_plan(chunk, p, n, torch.float32)
    assert f32["smem_bytes"] == 21_120
    _covers(f32["p_slices"], p)
    _covers(f32["n_slabs"], n)
    assert all(w <= tssd.F32_TILE for _, w in f32["p_slices"] + f32["n_slabs"])
    bf = tssd.ssd_scan_plan(chunk, p, n, torch.bfloat16)
    _covers(bf["n_slabs"], n)
    if n > tssd.WHOLE_STATE:
        assert all(w <= tssd.SLAB for _, w in bf["n_slabs"])
    if chunk <= 256 and p <= 256:
        assert bf["smem_bytes"] <= MAX_SMEM


@pytest.mark.parametrize("chunk,p,n,widths", [
    (256, 512, 64, [176, 176, 160]),          # chunk 256 x p 512
    (128, 1024, 64, [352, 352, 320]),         # chunk 128 x p 1,024
    (256, 1024, 320, [256, 256, 256, 256]),   # with n in slabs too
    (128, 80, 64, [80]),                      # zamba2's: p whole
    (128, 256, 64, [256]),                    # fits whole: one slab
])
def test_ssd_p_slabs_fit_and_cover(chunk, p, n, widths):
    """bf16 K7 where a block of the whole p would pass 227 KB: the fewest
    equal slabs of p (multiples of 16 but the last) whose block fits,
    covering p once; a shape that fits keeps p whole. float32 never
    slabs p."""
    plan = tssd.ssd_scan_plan(chunk, p, n, torch.bfloat16)
    _covers(plan["p_slabs"], p)
    assert [w for _, w in plan["p_slabs"]] == widths
    assert all(w % 16 == 0 for _, w in plan["p_slabs"][:-1])
    assert plan["smem_bytes"] <= MAX_SMEM
    assert plan["smem_bytes"] == tssd.ssd_scan_plan(
        chunk, widths[0], n, torch.bfloat16)["smem_bytes"]
    if len(widths) > 1:       # one slab fewer would not fit whole
        wider = -(-p // (len(widths) - 1) // 16) * 16
        assert len(tssd.ssd_scan_plan(chunk, wider, n, torch.bfloat16)[
            "p_slabs"]) > 1
    assert tssd.ssd_scan_plan(chunk, p, n, torch.float32)["p_slabs"] == \
        [(0, p)]


@pytest.mark.parametrize("slabs", [[(0, 16), (16, 16), (32, 8)],
                                   [(0, 32), (32, 8)]])
def test_ssd_scan_over_p_slabs_matches_pallas(slabs):
    """The wrapper's slab loop (``over_p_slabs``) around the plain version
    gives the Pallas kernel's y and state within K7's float32 tolerance:
    a column of y and of the state depends on its own column of x."""
    b, s, h, p, g, n, chunk = 1, 160, 2, 40, 1, 16, 64
    a = _ssd_inputs(28, b, s, h, p, g, n, bf16_operands=False)
    x, dt, A, B, C, D = (torch.as_tensor(v) for v in a)
    y, st = tssd.over_p_slabs(
        lambda xs: tssd.ssd_scan_plain(xs, dt, A, B, C, D, chunk=chunk), x,
        slabs)
    y_j, st_j = j_ssd(*(jnp.asarray(v) for v in a), chunk=chunk,
                      interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **SSD_F32_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), **SSD_F32_TOL)


@pytest.mark.parametrize("V,n_buckets,M", [
    (23, 17, 0), (23, 32, 0), (400_000, 24, 0), (150_000, 17, 3_000_000),
    (78_643, 5, 0), (5_000, 4_096, 0), (23, 4_097, 0), (3_000, 10_000, 0),
    (583_182, 16, 1_800_000), (5, 5_000, 0), (12, 5_000, 0),
    (9, 4_097, 0)])
def test_entropy_plans_fit_and_cover(V, n_buckets, M):
    """K2's plan at any bucket count: a block's bins, totals and edges
    within 227 KB, the slices covering V, the passes covering the buckets
    once, no pass above 4,096 buckets; with more than one pass, a count
    for every value each block of the cluster owns (replicated plans with
    V not a multiple of 8 included)."""
    repl, slices, span, per_pass = tef._plan(V, n_buckets, M)
    smem = tef.plan_smem_bytes(V, n_buckets, M)
    assert smem <= MAX_SMEM
    held = span if repl else span // tef.CLUSTER
    assert per_pass * held <= tef.MAX_BINS
    if per_pass < n_buckets:
        owned = max(len(range(r, span, tef.CLUSTER))
                    for r in range(tef.CLUSTER))
        assert tef.owned_values(span) == owned
        assert smem == (4 * (per_pass * held + 2 * per_pass + owned)
                        + tef.STATIC_SMEM)
    assert slices * span >= V and (repl or span % tef.CLUSTER == 0)
    passes = tef.bucket_passes(n_buckets)
    _covers(passes, n_buckets)
    assert all(w <= tef.PASS_BUCKETS for _, w in passes)


@pytest.mark.parametrize("N", [1, 65_535, 65_536, 70_000, 200_000])
def test_entropy_launch_pieces_cover_the_partitions(N):
    pieces = tef.partition_pieces(N)
    _covers(pieces, N)
    assert all(w <= 65_535 for _, w in pieces)


@pytest.mark.parametrize("L", [1, 12, 128, 129, 256, 1_000])
def test_usage_windows_cover_the_tiers(L):
    windows = tus.tier_windows(L)
    _covers(windows, L)
    assert all(w <= tus.WINDOW for _, w in windows)
    assert len(windows) == -(-L // 128)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("B,S,Hq,Hkv,Dv", [
    (4, 1024, 16, 1, 576), (3, 150, 8, 2, 576), (2, 120, 4, 4, 320),
    (1, 1, 16, 1, 576), (2, 100_000, 40, 8, 600)])
def test_wide_decode_splits_cover_the_cache(B, S, Hq, Hkv, Dv, sms):
    split = taw.decode_wide_split(B, S, Hq, Hkv, Dv, sms)
    assert split % taw.DECODE_TILE == 0 and split >= taw.DECODE_TILE
    nsplit = -(-S // split)
    _covers([(s * split, min(split, S - s * split)) for s in range(nsplit)],
            S)
    assert nsplit <= 4096                    # the merge's kMaxSplits
