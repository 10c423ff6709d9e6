"""The port's migration-budget knapsack and Thm 2 matching against
``repro``'s:

* ``budgeted_moves`` on the greedy, exact and auto paths, with a cents cap,
  a GB cap and both, zero-cost moves, non-positive savings, priorities,
  ``paid_cents``, and ties that exist only in float32 (the reference ranks
  float32 ratios with a stable sort): identical masks;
* ``matching_assign`` against the reference and against ``brute_force``,
  as ``tests/test_optassign.py`` checks it.
"""

import numpy as np
import pytest

from repro.core import optassign as jo
from repro_torch.core import optassign as to


def _both(*a, **k):
    j = jo.budgeted_moves(*a, **k)
    t = to.budgeted_moves(*a, **k, device="cpu")
    np.testing.assert_array_equal(t, j)
    assert t.dtype == bool
    return t


def _instance(seed, n):
    rng = np.random.default_rng(seed)
    s = rng.gamma(1.0, 5.0, n) - 1.0             # some non-positive savings
    c = rng.uniform(0.0, 3.0, n)
    c[rng.random(n) < 0.1] = 0.0                 # zero-cost moves
    g = rng.uniform(0.0, 2.0, n)
    cand = rng.random(n) < 0.85
    pr = 1.0 + rng.integers(0, 3, n) * 0.5
    paid = np.where(rng.random(n) < 0.2, rng.uniform(0, 2, n), 0.0)
    return s, c, g, cand, pr, paid


@pytest.mark.parametrize("method", ["greedy", "exact", "auto"])
@pytest.mark.parametrize("caps", ["cents", "gb", "both"])
def test_budgeted_moves_matches_repro(method, caps):
    for seed in range(6):
        n = 10 if method != "greedy" else 300
        s, c, g, cand, pr, paid = _instance(seed, n)
        bc = 0.4 * c[cand].sum() if caps != "gb" else np.inf
        bg = 0.3 * g[cand].sum() if caps != "cents" else np.inf
        keep = _both(s, c, bc, candidates=cand, move_gb=g, budget_gb=bg,
                     method=method)
        assert not (keep & ~cand).any()
        assert c[keep].sum() <= bc + 1e-9 and g[keep].sum() <= bg + 1e-9
        _both(s, c, bc, candidates=cand, move_gb=g, budget_gb=bg,
              priority=pr, paid_cents=paid, method=method)


def test_budgeted_moves_edge_cases_match_repro():
    s = np.array([10.0, 8.0, 6.0, 1.0])
    c = np.array([3.0, 3.0, 4.0, 0.0])
    for method in ("greedy", "exact"):
        assert _both(s, c, 6.0, method=method).tolist() == \
            [True, True, False, True]
    _both(np.array([1.0, 5.0, -2.0]), np.full(3, 9.0), np.inf,
          candidates=np.array([True, False, True]))
    _both(np.zeros(0), np.zeros(0), 1.0)
    _both(s, c, 1.0, candidates=np.zeros(4, bool))
    _both(s, c, 0.0, method="greedy")                  # only free moves
    assert _both(np.array([10.0, 8.0]), np.array([7.0, 7.0]), 4.0,
                 paid_cents=np.array([5.0, 5.0])).all()
    with pytest.raises(ValueError):
        to.budgeted_moves(s, c, 1.0, method="nope", device="cpu")


def test_ties_that_exist_only_in_float32_break_like_repro():
    """Ratios 1.0 and 1.0 + 1e-9 differ in float64 and are equal in
    float32; the cap fits one move. The float32 stable ranking takes the
    first, where a float64 ranking would take the second."""
    s = np.array([1.0, 1.0 + 1e-9, 0.5])
    c = np.array([1.0, 1.0, 1.0])
    keep = _both(s, c, 1.0, method="greedy")
    assert keep.tolist() == [True, False, False]
    # many such ties at scale, with both caps binding
    rng = np.random.default_rng(3)
    n = 2000
    base = rng.integers(1, 6, n).astype(float)
    s = base * (1.0 + rng.integers(0, 4, n) * 1e-10)
    c = np.ones(n)
    g = rng.uniform(0.5, 1.5, n)
    keep = _both(s, c, 700.0, move_gb=g, budget_gb=600.0, method="greedy")
    assert 0 < keep.sum() < n


def test_budgeted_moves_at_scale_matches_repro():
    s, c, g, cand, pr, paid = _instance(7, 20_000)
    keep = _both(s, c, 0.5 * c[cand].sum(), candidates=cand, move_gb=g,
                 budget_gb=0.45 * g[cand].sum(), method="greedy")
    assert keep.sum() > 1000


def test_knapsack_scan_walks_in_float32():
    """The host walk subtracts in float32: a budget that float64 would
    exhaust exactly still admits the next item after float32 rounding,
    the way the reference's jitted scan does."""
    c = np.array([0.1] * 10 + [1e-8])
    order = np.arange(11)
    takes = to._knapsack_scan(order, c, np.zeros(11), np.ones(11, bool),
                              1.0, np.inf)
    f = np.float32
    rem = f(1.0)
    want = []
    for x in c.astype(f):
        ok = x <= rem + f(1e-9)
        want.append(bool(ok))
        rem = rem - x if ok else rem
    assert takes.tolist() == want


# ------------------------------------------------------------------ matching
def test_matching_matches_repro_and_brute_force():
    rng = np.random.default_rng(3)
    checked = 0
    for _ in range(8):
        N, L = 6, 3
        cost_nl = rng.uniform(1.0, 100.0, (N, L))
        feas_nl = rng.random((N, L)) > 0.15
        cap = np.array([2, 2, 6])
        t = to.matching_assign(cost_nl, feas_nl, cap)
        j = jo.matching_assign(cost_nl, feas_nl, cap)
        np.testing.assert_array_equal(t.tier, j.tier)
        np.testing.assert_array_equal(t.scheme, j.scheme)
        assert (t.cost, t.feasible) == (j.cost, j.feasible)
        b = to.brute_force(cost_nl[:, :, None], feas_nl[:, :, None],
                           np.ones((N, L, 1)), cap.astype(float))
        assert t.feasible == b.feasible
        if t.feasible:
            assert t.cost == pytest.approx(b.cost, rel=1e-9)
            assert (np.bincount(t.tier, minlength=L) <= cap).all()
            checked += 1
    assert checked >= 4


def test_matching_with_ties_and_infeasible_matches_repro():
    # equal costs everywhere: the order of edge insertion decides
    cost = np.ones((5, 3))
    feas = np.ones((5, 3), bool)
    for cap in (np.array([2, 2, 2]), np.array([1, 1, 1]), np.array([5, 0, 0])):
        t = to.matching_assign(cost, feas, cap)
        j = jo.matching_assign(cost, feas, cap)
        np.testing.assert_array_equal(t.tier, j.tier)
        assert (t.cost, t.feasible) == (j.cost, j.feasible)
    assert not to.matching_assign(cost, feas, np.array([1, 1, 1])).feasible
