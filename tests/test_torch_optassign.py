"""PyTorch port of the OPTASSIGN solvers, held against ``repro``: identical
``Assignment``s from ``greedy_assign`` and ``capacitated_assign`` (with and
without group capacity rows), and ``brute_force`` optima on tiny
instances."""

import numpy as np
import pytest

from repro.core import optassign as jopt
from repro_torch.core import optassign as topt


def _instance(seed, N=40, L=4, K=3, tight=0.45, infeasible=0.1):
    rng = np.random.default_rng(seed)
    cost = rng.gamma(2.0, 1.0, (N, L, K))
    feas = rng.random((N, L, K)) > infeasible
    feas[:, :, 0] = True                        # every row keeps a cell
    spans = rng.uniform(0.5, 3.0, N)
    ratio = np.concatenate([np.ones((N, 1)), rng.uniform(1.2, 4.0, (N, K - 1))],
                           axis=1)
    stored = np.repeat((spans[:, None] / ratio)[:, None, :], L, axis=1)
    # capacities bound the unconstrained optimum, so the dual ascent runs
    g = jopt.greedy_assign(cost, feas)
    use = jopt._chosen_usage(stored, g.tier, g.scheme)
    cap = np.maximum(use * tight, 0.2 * stored.sum() / N)
    cap[-1] = np.inf
    return cost, feas, stored, cap


def _same(a, b):
    np.testing.assert_array_equal(a.tier, b.tier)
    np.testing.assert_array_equal(a.scheme, b.scheme)
    assert a.feasible == b.feasible
    assert a.cost == pytest.approx(b.cost, rel=1e-12)


@pytest.mark.parametrize("seed", range(4))
def test_greedy_matches_repro(seed):
    cost, feas, _, _ = _instance(seed, N=200)
    _same(topt.greedy_assign(cost, feas, device="cpu"),
          jopt.greedy_assign(cost, feas))


def test_greedy_empty_and_infeasible_rows():
    z = np.zeros((0, 3, 2))
    a = topt.greedy_assign(z, z > 0, device="cpu")
    assert a.feasible and a.tier.shape == (0,)
    cost, feas, _, _ = _instance(1, N=6)
    feas[2] = False
    _same(topt.greedy_assign(cost, feas, device="cpu"),
          jopt.greedy_assign(cost, feas))


@pytest.mark.parametrize("seed", range(6))
def test_capacitated_matches_repro(seed):
    cost, feas, stored, cap = _instance(seed)
    _same(topt.capacitated_assign(cost, feas, stored, cap, device="cpu"),
          jopt.capacitated_assign(cost, feas, stored, cap))


@pytest.mark.parametrize("seed", range(3))
def test_capacitated_with_tier_groups_matches_repro(seed):
    cost, feas, stored, cap = _instance(seed, L=6)
    groups = np.array([0, 0, 0, 1, 1, 1])
    gcap = np.array([0.5 * stored[:, :3].max(2).sum(), np.inf])
    _same(topt.capacitated_assign(cost, feas, stored, cap, tier_groups=groups,
                                  group_capacity_gb=gcap, device="cpu"),
          jopt.capacitated_assign(cost, feas, stored, cap, tier_groups=groups,
                                  group_capacity_gb=gcap))


def test_capacitated_runs_the_dual_ascent(monkeypatch):
    """The instances above bind the capacities, so the scan really runs."""
    cost, feas, stored, cap = _instance(0)
    calls = []
    scan = topt._lagrangian_scan
    monkeypatch.setattr(topt, "_lagrangian_scan",
                        lambda *a: calls.append(1) or scan(*a))
    topt.capacitated_assign(cost, feas, stored, cap, device="cpu")
    assert calls


@pytest.mark.parametrize("seed", range(6))
def test_dual_ascent_emits_the_jax_scans_candidates(seed):
    """The float32 torch scan follows the jitted JAX scan step for step:
    the same (iters, N) candidate cells, bit for bit, on the CPU."""
    import jax.numpy as jnp
    import torch
    cost, feas, stored, cap = _instance(seed)
    masked = jopt._masked(cost, feas)
    A, cap_all = jopt._constraint_rows(cap, None, None)
    step0 = jopt._step0(masked, cap_all, np.isfinite(cap_all))
    L = cap.shape[0]
    g_of_t, gcap = np.zeros(L, np.int32), np.array([np.inf])
    want = np.asarray(jopt._lagrangian_scan(
        jnp.asarray(masked), jnp.asarray(stored), jnp.asarray(cap),
        jnp.asarray(np.isfinite(cap)), jnp.asarray(g_of_t),
        jnp.asarray(gcap), jnp.asarray(np.isfinite(gcap)),
        jnp.float32(step0), 200))
    got = topt._lagrangian_scan(masked, stored, cap, g_of_t, gcap, step0,
                                200, torch.device("cpu"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_capacitated_matches_brute_force_on_tiny(seed):
    cost, feas, stored, cap = _instance(seed, N=5, L=3, K=2, tight=0.6)
    got = topt.capacitated_assign(cost, feas, stored, cap, device="cpu")
    want = topt.brute_force(cost, feas, stored, cap)
    assert got.feasible and want.feasible
    assert got.cost == pytest.approx(want.cost, rel=1e-9)
    _same(want, jopt.brute_force(cost, feas, stored, cap))


def test_capacitated_ref_is_a_faithful_copy():
    cost, feas, stored, cap = _instance(2, N=8, L=3, K=2)
    _same(topt.capacitated_assign_ref(cost, feas, stored, cap, iters=30),
          jopt.capacitated_assign_ref(cost, feas, stored, cap, iters=30))


def test_lock_schemes_matches_repro():
    _, feas, _, _ = _instance(3, N=10)
    locked = np.array([-1, 0, 1, 2, -1, 0, 1, 2, -1, 0])
    np.testing.assert_array_equal(topt.lock_schemes(feas, locked),
                                  jopt.lock_schemes(feas, locked))
