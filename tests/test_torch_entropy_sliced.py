"""The sliced reduction of K2's CUDA kernel, on the CPU.

``repro_torch.kernels.entropy_features.weighted_entropy_features_sliced``
computes the weighted-entropy features as ``csrc/entropy_features.cu``
reduces them: the exact integer histogram, each term in float32, and for
each slice of ``width`` consecutive values and each of the cluster's 8
blocks (the values of the slice at its rank modulo 8) the terms' sums in
float64, added in (slice, block) order. It is held against
``repro.kernels.entropy_features`` (the Pallas kernel in interpret mode)
and against ``weighted_entropy_features_plain`` within 1e-5, at slice
widths 1, 7, V - 1 and V with 1, 5 and 16 buckets, on ragged partitions
whose codes include -1 inside ``n_valid``, and on the edge cases:
``n_valid = 0``, ``n_cols = 0`` and a constant payload. Codes at or past V
are skipped by the kernel and the plain version; the Pallas kernel counts
those below its 128-padded vocabulary, so that case is held against the
plain version alone.
"""

import functools

import numpy as np
import pytest
import torch

from repro.kernels.entropy_features import weighted_entropy_features as j_wef
from repro_torch.kernels import entropy_features as tef

TOL = dict(rtol=1e-5, atol=1e-5)
V = 23


@functools.lru_cache(maxsize=None)
def _ragged(high=V, seed=3, N=4):
    """Ragged partitions whose codes inside n_valid lie in [-1, high)."""
    rng = np.random.default_rng(seed)
    n_cols = np.array([2, 1, 3, 2], np.int32)[:N]
    n_rows = rng.integers(1, 60, N).astype(np.int32)
    n_valid = n_rows * n_cols
    codes = np.full((N, int(n_valid.max()) + 5), -1, np.int32)
    for i in range(N):
        codes[i, :n_valid[i]] = rng.integers(-1, high, n_valid[i])
    lengths = rng.integers(1, 9, (N, V)).astype(np.float32)
    return codes, n_valid, n_rows, n_cols, lengths


@functools.lru_cache(maxsize=None)
def _pallas(n_buckets):
    s, b = j_wef(*_ragged(), n_buckets=n_buckets, block=64, interpret=True)
    return np.asarray(s), np.asarray(b)


def _sliced(args, n_buckets, width):
    s, b = tef.weighted_entropy_features_sliced(
        *(torch.as_tensor(a) for a in args), n_buckets=n_buckets, width=width)
    assert s.dtype == torch.float32 and b.dtype == torch.float32
    return s.numpy(), b.numpy()


@pytest.mark.parametrize("width", [1, 7, V - 1, V])
@pytest.mark.parametrize("n_buckets", [1, 5, 16])
def test_sliced_matches_pallas_and_plain(n_buckets, width):
    args = _ragged()
    s, b = _sliced(args, n_buckets, width)
    assert s.shape == (4, 4) and b.shape == (4, n_buckets)
    s_p, b_p = tef.weighted_entropy_features_plain(
        *(torch.as_tensor(a) for a in args), n_buckets=n_buckets)
    for want_s, want_b in (_pallas(n_buckets), (s_p.numpy(), b_p.numpy())):
        np.testing.assert_allclose(s, want_s, **TOL)
        np.testing.assert_allclose(b, want_b, **TOL)


@pytest.mark.parametrize("width", [1, 7, V - 1, V])
def test_sliced_skips_codes_past_v(width):
    args = _ragged(high=V + 3)
    for nb in (1, 16):
        s, b = _sliced(args, nb, width)
        s_p, b_p = tef.weighted_entropy_features_plain(
            *(torch.as_tensor(a) for a in args), n_buckets=nb)
        np.testing.assert_allclose(s, s_p.numpy(), **TOL)
        np.testing.assert_allclose(b, b_p.numpy(), **TOL)


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("case", ["n_valid=0", "n_cols=0", "constant"])
def test_sliced_edge_cases_match_pallas(case, width):
    if case == "n_valid=0":
        args = (np.full((2, 8), -1, np.int32), np.zeros(2, np.int32),
                np.array([3, 0], np.int32), np.array([2, 1], np.int32),
                np.ones((2, 4), np.float32))
    elif case == "n_cols=0":
        args = (np.full((2, 1), -1, np.int32), np.zeros(2, np.int32),
                np.array([9, 4], np.int32), np.zeros(2, np.int32),
                np.zeros((2, 1), np.float32))
    else:
        args = (np.zeros((2, 40), np.int32), np.array([40, 12], np.int32),
                np.array([20, 6], np.int32), np.array([2, 2], np.int32),
                np.full((2, 4), 3.0, np.float32))
    for nb in (1, 5):
        s, b = _sliced(args, nb, width)
        want_s, want_b = j_wef(*args, n_buckets=nb, interpret=True)
        np.testing.assert_allclose(s, np.asarray(want_s), **TOL)
        np.testing.assert_allclose(b, np.asarray(want_b), **TOL)
        if case == "constant":
            np.testing.assert_allclose(s[:, :2], 0.0, atol=1e-6)


@pytest.mark.parametrize("V_,n_buckets,M,want", [
    (15_005, 1, 1_200_000, (True, 1, 15_005)),      # main path class 2
    (150_000, 1, 0, (False, 1, 150_000)),           # fits 8 blocks
    (150_000, 1, 3_000_000, (False, 6, 25_000)),    # class 0: spread codes
    (583_182, 1, 0, (False, 2, 291_592)),           # two slices to hold V
    (583_182, 1, 1_800_000, (False, 4, 145_800)),   # class 1
    (15_005, 5, 1_200_000, (False, 3, 5_008)),
    (583_182, 16, 0, (False, 24, 24_304)),
    (4_000, 16, 10 ** 9, (False, 500, 8)),  # no more slices than values
])
def test_plan_holds_every_value_on_chip(V_, n_buckets, M, want):
    repl, slices, span, per_pass = tef._plan(V_, n_buckets, M)
    assert (repl, slices, span) == want and per_pass == n_buckets
    assert slices * span >= V_
    per_block = span if repl else span // tef.CLUSTER
    assert n_buckets * per_block <= tef.MAX_BINS
    if not repl:
        assert span % tef.CLUSTER == 0
        codes_per_block = -(-M // (tef.CLUSTER * slices))
        assert (codes_per_block <= tef.CODES_PER_BLOCK
                or slices >= -(-V_ // tef.CLUSTER))
