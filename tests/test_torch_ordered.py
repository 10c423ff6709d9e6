"""The paper's ordered (time-series) partitioning in the port against
``repro``'s: ``ordered_dp`` (Thm 5) and ``ordered_approx`` (Thm 6) give the
reference's groups, space and cost, agree with ``ordered_brute_force``, and
meet the bicriteria bound, as ``tests/test_datapart.py`` checks them; the
objective helpers ``overlap``, ``read_cost`` and ``duplication`` agree."""

import numpy as np
import pytest

from repro.core import datapart as jdp
from repro_torch.core import datapart as tdp


def _ordered_parts(dp, seed, n):
    """Sliding windows over time-ordered files (the reference tests'
    generator), built in module ``dp``."""
    rng = np.random.default_rng(seed)
    sizes = dp.FileSizes({f"t{i}": float(rng.uniform(0.5, 3.0))
                          for i in range(n + 6)})
    parts = []
    for i in range(n):
        w = int(rng.integers(2, 5))
        parts.append(dp.Partition(frozenset(f"t{j}" for j in range(i, i + w)),
                                  float(rng.uniform(0.5, 4.0)), sizes))
    return parts


def _same(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert a.groups == b.groups
        assert a.space == b.space and a.cost == b.cost


@pytest.mark.parametrize("seed", range(4))
def test_ordered_dp_matches_repro_and_brute_force(seed):
    jp, tp = _ordered_parts(jdp, seed, 6), _ordered_parts(tdp, seed, 6)
    np.testing.assert_array_equal(tdp._run_spans(tp), jdp._run_spans(jp))
    c = tdp.read_cost(tp) * 1.5
    assert c == jdp.read_cost(jp) * 1.5
    exact = tdp.ordered_brute_force(tp, c)
    _same(exact, jdp.ordered_brute_force(jp, c))
    for buckets in (200, 4000):
        sol = tdp.ordered_dp(tp, c, n_buckets=buckets)
        _same(sol, jdp.ordered_dp(jp, c, n_buckets=buckets))
    assert sol.cost <= c * 1.01
    assert sol.space == pytest.approx(exact.space, rel=2e-2)


@pytest.mark.parametrize("seed,n", [(3, 7), (5, 8)])
def test_ordered_approx_matches_repro_and_bicriteria(seed, n):
    jp, tp = _ordered_parts(jdp, seed, n), _ordered_parts(tdp, seed, n)
    c = tdp.read_cost(tp) * 1.2
    exact = tdp.ordered_brute_force(tp, c)
    approx = tdp.ordered_approx(tp, c, eps=1.0 / n)
    _same(approx, jdp.ordered_approx(jp, c, eps=1.0 / n))
    assert exact is not None and approx is not None
    assert approx.space <= exact.space + 1e-9
    assert approx.cost <= 2.0 * c * 1.01     # (1, 2) bicriteria, eps = 1/N


def test_ordered_infeasible_and_empty_match_repro():
    jp, tp = _ordered_parts(jdp, 9, 5), _ordered_parts(tdp, 9, 5)
    c = tdp.read_cost(tp) * 0.5                 # below any grouping's cost
    _same(tdp.ordered_dp(tp, c), jdp.ordered_dp(jp, c))
    _same(tdp.ordered_brute_force(tp, c), jdp.ordered_brute_force(jp, c))
    _same(tdp.ordered_dp([], 1.0), jdp.ordered_dp([], 1.0))


def test_objective_helpers_match_repro():
    jp, tp = _ordered_parts(jdp, 11, 9), _ordered_parts(tdp, 11, 9)
    assert tdp.read_cost(tp) == jdp.read_cost(jp)
    assert tdp.duplication(tp) == jdp.duplication(jp)
    assert tdp.duplication([]) == jdp.duplication([]) == 0.0
    for i in range(len(tp) - 1):
        assert tdp.overlap(tp[i], tp[i + 1]) == jdp.overlap(jp[i], jp[i + 1])
