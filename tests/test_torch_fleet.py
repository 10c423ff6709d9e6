"""The port's fleet solver and ``FleetEngine`` against ``repro``'s.

Each case feeds the same seeded tenant problems to both packages (the
port on ``device="cpu"``) and checks identical tiers and schemes for each
tenant, identical feasibility and cents within rel 1e-6:

* ``capacitated_assign_batch`` against the reference's batch and against
  the port's own per-tenant ``capacitated_assign`` (bit-identical when no
  shared row couples the tenants), on fleets where the caps bind;
* ``greedy_assign_batch``; ragged padding and an empty tenant; infinite
  shared caps; binding shared caps; N=0 tenants and an empty fleet; an
  all-infeasible tenant;
* ``FleetEngine.solve`` and ``reoptimize`` against the reference's
  ``FleetEngine``, uncoupled and with provider caps shared across the
  fleet; provider-name validation (the fleet over a mesh is
  ``tests/test_torch_placement_mesh.py``'s).

The batched dual ascent's cells are held against the reference's scan
(its lean kernel, its chunks, shared caps, group rows). The port sums
usage exactly (float32 terms accumulated in float64, rounded once), so no
reduction order reaches its cells; the reference sums in float32. Where
that parts the two, an emulation of each package reproduces its cells bit
for bit, and the packages agree until the emulations part: on an
uncoupled fleet where a tenant's row-order sum decides a near-tie, and on
a coupled fleet built so that the order of the fleet-wide sum decides a
cell.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import costs as jcosts
from repro.core import engine as jeng
from repro.core import fleet as jfleet
from repro.core import optassign as jopt
from repro_torch.core import costs as tcosts
from repro_torch.core import engine as teng
from repro_torch.core import fleet as tfleet
from repro_torch.core import optassign as topt

CPU = torch.device("cpu")
BIG = topt.BIG


# ----------------------------------------------------------------- fixtures
def _tenant(rng, N, K=3, binding=False):
    """One tenant's (cost, feas, stored, cap): the reference suite's
    ``_tenant_instance`` caps, or (``binding``) the fleet benchmark's: the
    greedy-hottest tier capped at 90% of its greedy use."""
    table = tcosts.azure_table()
    n = max(N, 1)
    spans = rng.uniform(0.5, 50.0, n)[:N]
    rho = rng.gamma(1.0, 20.0, n)[:N]
    cur = rng.integers(-1, table.num_tiers, n)[:N]
    R = np.concatenate([np.ones((n, 1)), rng.uniform(1.2, 6.0, (n, K - 1))],
                       1)[:N]
    D = np.concatenate([np.zeros((n, 1)), rng.uniform(0.01, 3.0, (n, K - 1))],
                       1)[:N]
    lat = rng.choice([0.1, 1.0, 5.0, np.inf], n)[:N]
    cost = tcosts.cost_tensor(spans, rho, cur, R, D, table, tcosts.Weights(),
                              months=6)
    feas = tcosts.latency_feasible(D, lat, table)
    stored = np.repeat((spans[:, None] / R)[:, None, :], table.num_tiers, 1)
    if binding and N:
        cell = np.where(feas, cost, np.inf).reshape(N, -1).argmin(1)
        use = topt._chosen_usage(stored, cell // K, cell % K)
        cap = np.full(table.num_tiers, np.inf)
        cap[use.argmax()] = 0.9 * use.max()
    else:
        tot = spans.sum() if N else 1.0
        cap = np.array([tot / 3, tot / 2, tot, np.inf])
    return cost, feas, stored, cap


def _fleet(seed=0, Ns=(5, 9, 3, 9, 1, 8, 6), binding=False):
    rng = np.random.default_rng(seed)
    return [_tenant(rng, n, binding=binding) for n in Ns]


def _cols(fleet):
    return [[x[i] for x in fleet] for i in range(4)]


def _identical(a, b):
    return (np.array_equal(a.tier, b.tier)
            and np.array_equal(a.scheme, b.scheme)
            and a.cost == b.cost and a.feasible == b.feasible)


def _same_fleet(got, ref):
    """Port against reference: identical tiers, schemes and feasibility
    per tenant, cents within rel 1e-6."""
    assert got.feasible == ref.feasible
    assert len(got.assignments) == len(ref.assignments)
    for a, b in zip(got.assignments, ref.assignments):
        np.testing.assert_array_equal(a.tier, b.tier)
        np.testing.assert_array_equal(a.scheme, b.scheme)
        assert a.feasible == b.feasible
        assert a.cost == pytest.approx(b.cost, rel=1e-6)
    assert got.cost == pytest.approx(ref.cost, rel=1e-6)
    if ref.shared_use_gb is None:
        assert got.shared_use_gb is None
    else:
        np.testing.assert_allclose(got.shared_use_gb, ref.shared_use_gb,
                                   rtol=1e-9)


# -------------------------------------------------------------- core parity
@pytest.mark.parametrize("seed,Ns,binding", [
    (0, (5, 9, 3, 9, 1, 8, 6), False), (3, (5, 9, 3, 9, 1, 8, 6), False),
    (8, (12, 30, 17, 24, 6, 40, 22, 9), True),
    (64, tuple(range(8, 40, 2)), True)])
def test_batch_matches_repro_and_per_tenant_solves(seed, Ns, binding):
    fleet = _fleet(seed, Ns, binding)
    got = topt.capacitated_assign_batch(*_cols(fleet), device="cpu")
    _same_fleet(got, jopt.capacitated_assign_batch(*_cols(fleet)))
    singles = [topt.capacitated_assign(c, f, s, cap, device="cpu")
               for c, f, s, cap in fleet]
    for single, a in zip(singles, got.assignments):
        assert _identical(single, a)
    assert got.cost == float(sum(s.cost for s in singles))


def test_binding_fleet_reaches_the_scan_and_its_finish(monkeypatch):
    """The binding fleet runs the batched scan once and the lockstep
    finish with its sequential tail."""
    calls = {"scan": 0, "tail": 0}
    scan, tail = topt._fleet_scan, topt._local_search_vec

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(topt, "_fleet_scan", count("scan", scan))
    monkeypatch.setattr(topt, "_local_search_vec", count("tail", tail))
    fleet = _fleet(8, (12, 30, 17, 24, 6, 40, 22, 9), binding=True)
    topt.capacitated_assign_batch(*_cols(fleet), device="cpu")
    assert calls["scan"] == 1 and calls["tail"] > 0


@pytest.mark.parametrize("seed", [7, 11])
def test_greedy_batch_matches_repro_and_singles(seed):
    fleet = _fleet(seed)
    got = topt.greedy_assign_batch([x[0] for x in fleet],
                                   [x[1] for x in fleet], device="cpu")
    ref = jopt.greedy_assign_batch([x[0] for x in fleet],
                                   [x[1] for x in fleet])
    for a, b, (c, f, _, _) in zip(got, ref, fleet):
        assert _identical(a, b)
        assert _identical(a, topt.greedy_assign(c, f, device="cpu"))
    assert topt.greedy_assign_batch([], [], device="cpu") == []


@pytest.mark.parametrize("pos", [0, 4, 8])
def test_ragged_padding_invariance_empty_tenant_changes_nothing(pos):
    fleet = _fleet(8, (12, 30, 17, 24, 6, 40, 22, 9), binding=True)
    base = topt.capacitated_assign_batch(*_cols(fleet), device="cpu")
    empty = _tenant(np.random.default_rng(9), 0)
    fleet2 = fleet[:pos] + [empty] + fleet[pos:]
    got = topt.capacitated_assign_batch(*_cols(fleet2), device="cpu")
    _same_fleet(got, jopt.capacitated_assign_batch(*_cols(fleet2)))
    others = got.assignments[:pos] + got.assignments[pos + 1:]
    for a, b in zip(base.assignments, others):
        assert _identical(a, b)
    ins = got.assignments[pos]
    assert ins.feasible and ins.cost == 0.0 and ins.tier.shape == (0,)


def test_tenant_cells_do_not_depend_on_the_fleet():
    """An uncoupled tenant's scan cells are the same alone, in a fleet,
    and in a fleet of a different size (the port runs every fleet in one
    batch; rows and tenants pad with exact zeros)."""
    fleet = _fleet(8, (12, 30, 17, 24, 6, 40, 22, 9), binding=True)

    def cells(tenants):
        n_max = max(fleet[t][0].shape[0] for t in tenants)
        T, L, K = len(tenants), 4, 3
        m = np.full((T, n_max, L, K), BIG)
        s = np.zeros((T, n_max, L, K))
        cap = np.zeros((T, L))
        step = np.zeros(T)
        for j, t in enumerate(tenants):
            c, f, st, cp = fleet[t]
            m[j, :c.shape[0]] = topt._masked(c, f)
            s[j, :c.shape[0]] = st
            cap[j] = cp
            A, ca = topt._constraint_rows(cp, None, None)
            step[j] = topt._step0(m[j, :c.shape[0]], ca, np.isfinite(ca))
        return topt._fleet_scan(m, s, cap, np.zeros(L, np.int64),
                                np.full((T, 1), np.inf),
                                np.zeros(L, np.int64), np.array([np.inf]),
                                step, 0.0, 60, CPU)

    whole = cells(list(range(8)))
    for sub in ([5], [2, 5], [5, 0, 7]):
        part = cells(sub)
        for j, t in enumerate(sub):
            n = fleet[t][0].shape[0]
            np.testing.assert_array_equal(part[:, j, :n], whole[:, t, :n])


def _scan_args(fleet, **kw):
    """The batched scan's arguments as ``capacitated_assign_batch`` builds
    them for ``fleet`` (caught from the port's solver)."""
    box = []
    scan = topt._fleet_scan

    def keep(*a):
        box.append(a)
        return scan(*a)
    topt._fleet_scan = keep
    try:
        topt.capacitated_assign_batch(*_cols(fleet), device="cpu", **kw)
    finally:
        topt._fleet_scan = scan
    assert len(box) == 1, "the fleet never reached the scan"
    return box[0]


def _ref_cells(m, s, cap, g_of_t, gcap, sg, scap, step, sstep, iters):
    """The reference's dispatch of the same scan: ``_fleet_scan_plain``
    (in chunks of ``_FLEET_CHUNK`` tenants past 64) with no finite group
    or shared cap, ``_fleet_scan_single`` otherwise."""
    return jopt._run_fleet_scan(None, m, s, cap, gcap, g_of_t, sg, scap,
                                sstep, step, iters)


@pytest.mark.parametrize("case", ["chunked", "shared", "groups"])
def test_fleet_scan_emits_the_jax_scans_candidates(case):
    """The batched float32 scan follows the reference's jitted scan step
    for step: the same (iters, T, N) candidate cells, bit for bit, on the
    CPU: past ``_FLEET_CHUNK`` tenants (the reference's chunks of its lean
    kernel), with a binding shared cap and with group rows."""
    kw = {}
    if case == "chunked":
        fleet = _fleet(5, tuple(3 + i % 7 for i in range(70)), binding=True)
    else:
        fleet = _fleet(8, (12, 30, 17, 24, 6, 40, 22, 9), binding=True)
    if case == "shared":
        unc = topt.capacitated_assign_batch(*_cols(fleet), device="cpu")
        use = _fleet_use(fleet, unc.assignments)
        scap = np.full(4, np.inf)
        scap[use.argmax()] = 0.7 * use.max()
        kw = dict(shared_tier_groups=np.arange(4), shared_capacity_gb=scap)
    if case == "groups":
        tot = [0.4 * s[:, :2].max(2).sum() for _, _, s, _ in fleet]
        kw = dict(tier_groups=np.array([0, 0, 1, 1]),
                  group_capacity_gb=[np.array([g, np.inf]) for g in tot])
    args = _scan_args(fleet, **kw)
    got = topt._fleet_scan(*args)
    want = _ref_cells(*args[:-1])
    assert got.shape == want.shape == (args[-2], len(fleet),
                                       args[0].shape[1])
    np.testing.assert_array_equal(got, want)


def _emulate_plain(m, s, cap, step, iters, order):
    """numpy emulation of the uncoupled scan's lean body, in float32. Each
    tenant's usage is summed ``order="exact"`` (the port's: float64,
    rounded once) or ``"rows"`` (float32, row after row: ``np.add.at``
    adds in index order, as the reference's scatter-add does on the
    CPU)."""
    f32 = np.float32
    T, N, L, K = m.shape
    mm = m.reshape(T, N, L * K).astype(f32)
    ss = s.astype(f32)
    flat = ss.reshape(T, N, L * K)
    capf = cap.astype(f32)
    st = step.astype(f32)[:, None]
    rows = np.repeat(np.arange(T), N)
    lam = np.zeros((T, L), f32)
    cells = []
    for it in range(iters):
        adj = mm + (lam[:, None, :, None] * ss).reshape(T, N, L * K)
        idx = adj.argmin(2)
        chosen = np.take_along_axis(flat, idx[:, :, None], 2)[:, :, 0]
        if order == "exact":
            use = np.zeros((T, L))
            np.add.at(use, (rows, (idx // K).ravel()),
                      chosen.ravel().astype(np.float64))
            use = use.astype(f32)
        else:
            use = np.zeros((T, L), f32)
            np.add.at(use, (rows, (idx // K).ravel()), chosen.ravel())
        g = np.where(np.isfinite(capf), use - capf, f32(0)).astype(f32)
        lam = np.maximum(f32(0), lam + (st / (f32(1) + f32(it))) * g)
        cells.append(idx.astype(np.int32))
    return np.stack(cells)


def test_fleet_scan_parts_from_the_reference_only_by_its_sum_order():
    """The binding fleet above, uncoupled: the port sums each tenant's
    usage in the reference's order (float32, row after row), so its cells
    equal the reference's at every one of the 200 steps, all 64,000 of
    them. Both are the float32 row-order emulation bit for bit; the exact
    sum (float64, rounded once), which the port took before, parts from
    them at a near-tie, so the order is what decides the cells here."""
    fleet = _fleet(8, (12, 30, 17, 24, 6, 40, 22, 9), binding=True)
    args = _scan_args(fleet)
    m, s, cap, _, _, _, _, step, _, iters, _ = args
    got = topt._fleet_scan(*args)
    want = _ref_cells(*args[:-1])
    assert got.shape == want.shape == (iters, 8, 40)
    np.testing.assert_array_equal(got, want)
    rows = _emulate_plain(m, s, cap, step, iters, "rows")
    np.testing.assert_array_equal(got, rows)
    exact = _emulate_plain(m, s, cap, step, iters, "exact")
    assert (exact != rows).any()


@pytest.mark.parametrize("n", [2, 240, 16_000])
def test_usage_sums_are_exact_within_their_magnitude_condition(n):
    """The scan's condition for exact usage sums: n float32 terms whose
    largest over smallest nonzero magnitude times n is at most 2**28 sum
    exactly in float64 (every partial sum is a multiple of the smallest
    term's ulp below 2**53 of them), so every order gives the same bits.
    Here the terms sit at that bound."""
    import math
    rng = np.random.default_rng(n)
    lo, hi = np.float32(1.0), np.float32(2.0 ** 28 / n)
    if n * float(hi) > 2.0 ** 28:
        hi = np.nextafter(hi, np.float32(0.0))
    x = np.exp(rng.uniform(0.0, np.log(float(hi)), n)).astype(np.float32)
    x = np.clip(x, lo, hi)
    x[:2] = [lo, hi]
    assert n * float(x.max()) / float(x.min()) <= 2.0 ** 28
    exact = math.fsum(x.astype(np.float64))
    for k in range(4):
        y = rng.permutation(x).astype(np.float64)
        assert float(np.cumsum(y)[-1]) == exact            # one by one
        assert float(y.sum()) == exact                     # pairwise
        assert float(torch.as_tensor(y).sum()) == exact


def test_tenant_cells_do_not_depend_on_its_row_order():
    """A tenant's row order reaches its cells only through its float32
    usage sums, as it reaches the reference's: with every tenant's rows
    permuted, the port's cells are the reference's on the permuted rows
    at every step, and they are the unpermuted cells permuted until the
    step where the float32 row-order emulations of the two row orders
    part (the binding fleet: n * max / min of its stored GB is far below
    2**28, so the shared sum stays exact in any order)."""
    fleet = _fleet(8, (12, 30, 17, 24, 6, 40, 22, 9), binding=True)
    args = list(_scan_args(fleet))
    m, s, cap, _, _, _, _, step, _, iters, _ = args
    for t, (c, _, _, _) in enumerate(fleet):
        n = c.shape[0]
        st = s[t, :n][s[t, :n] > 0].astype(np.float32)
        assert n * float(st.max()) / float(st.min()) <= 2.0 ** 28
    base = topt._fleet_scan(*args)
    rng = np.random.default_rng(0)
    perms = [rng.permutation(c.shape[0]) for c, _, _, _ in fleet]
    m2, s2 = m.copy(), s.copy()
    for t, p in enumerate(perms):
        m2[t, :p.size] = m[t, p]
        s2[t, :p.size] = s[t, p]
    got = topt._fleet_scan(m2, s2, *args[2:])
    np.testing.assert_array_equal(got, _ref_cells(m2, s2, *args[2:-1]))
    rows = _emulate_plain(m, s, cap, step, iters, "rows")
    rows2 = _emulate_plain(m2, s2, cap, step, iters, "rows")
    same = np.ones(iters, bool)
    for t, p in enumerate(perms):
        same &= (rows2[:, t, :p.size] == rows[:, t, p]).all(1)
    k = int(np.argmin(same)) if not same.all() else iters
    assert k > 0
    for t, p in enumerate(perms):
        np.testing.assert_array_equal(got[:k, t, :p.size], base[:k, t, p])


def test_shared_inf_caps_preserve_bit_parity():
    fleet = _fleet(2, (12, 30, 17, 24, 6, 40, 22, 9), binding=True)
    kw = dict(shared_tier_groups=np.zeros(4, int),
              shared_capacity_gb=np.array([np.inf]))
    got = topt.capacitated_assign_batch(*_cols(fleet), device="cpu", **kw)
    _same_fleet(got, jopt.capacitated_assign_batch(*_cols(fleet), **kw))
    for (c, f, s, cap), a in zip(fleet, got.assignments):
        assert _identical(topt.capacitated_assign(c, f, s, cap,
                                                  device="cpu"), a)


def _fleet_use(fleet, assignments, L=4):
    use = np.zeros(L)
    for (c, f, s, cap), a in zip(fleet, assignments):
        t = a.tier.astype(int)
        np.add.at(use, t, s[np.arange(len(t)), t, a.scheme.astype(int)])
    return use


@pytest.mark.parametrize("seed,frac", [(3, 0.5), (5, 0.7), (13, 0.4)])
def test_shared_cap_binds_fleet_wide_and_matches_repro(seed, frac):
    fleet = _fleet(seed)
    unc = topt.capacitated_assign_batch(*_cols(fleet), device="cpu")
    use = _fleet_use(fleet, unc.assignments)
    tgt = int(use.argmax())
    scap = np.full(4, np.inf)
    scap[tgt] = frac * use[tgt]
    kw = dict(shared_tier_groups=np.arange(4), shared_capacity_gb=scap)
    got = topt.capacitated_assign_batch(*_cols(fleet), device="cpu", **kw)
    _same_fleet(got, jopt.capacitated_assign_batch(*_cols(fleet), **kw))
    assert got.feasible and got.shared_use_gb[tgt] <= scap[tgt] + 1e-9
    assert got.cost >= unc.cost - 1e-9 and use[tgt] > scap[tgt]


def test_shared_cap_infeasible_when_below_minimum_footprint():
    fleet = _fleet(4, (4, 6))
    kw = dict(shared_tier_groups=np.zeros(4, int),
              shared_capacity_gb=np.array([1e-6]))
    got = topt.capacitated_assign_batch(*_cols(fleet), device="cpu", **kw)
    _same_fleet(got, jopt.capacitated_assign_batch(*_cols(fleet), **kw))
    assert not got.feasible and got.cost == float("inf")


@pytest.mark.parametrize("kw", [
    dict(shared_tier_groups=np.zeros(4, int)),
    dict(shared_tier_groups=np.array([0, 1, 2, 5]),
         shared_capacity_gb=np.ones(2)),
    dict(shared_tier_groups=np.zeros(3, int), shared_capacity_gb=np.ones(1))])
def test_shared_rows_are_validated(kw):
    fleet = _fleet(1, (3, 4))
    with pytest.raises(ValueError):
        topt.capacitated_assign_batch(*_cols(fleet), device="cpu", **kw)


# -------------------------------------------- the order of the fleet-wide sum
def _emulate(m, s, cap, scap, step, sstep, iters, order):
    """numpy emulation of ``_fleet_scan`` with shared rows
    (``shared_tier_groups = arange(L)``, no group rows, every per-tenant
    cap infinite). Each tenant's usage is the exact sum, rounded to
    float32; the fleet-wide usage is summed ``order="exact"`` (the port's:
    float64, rounded once) or ``"rows"`` (float32, tenant after tenant).
    Returns the cells and the shared multipliers after each step."""
    f32 = np.float32
    T, N, L, K = m.shape

    def fleet_sum(use):
        if order == "exact":
            return use.astype(np.float64).sum(0).astype(f32)
        out = np.zeros(L, f32)
        for row in use:
            out = (out + row).astype(f32)
        return out

    mm = m.reshape(T, N, L * K).astype(f32)
    ss = s.reshape(T, N, L * K).astype(f32)
    st = step.astype(f32)[:, None]
    capf = cap.astype(f32)
    scf = scap.astype(f32)
    lam = np.zeros((T, L), f32)
    lam_s = np.zeros(L, f32)
    cells, lams = [], []
    for it in range(iters):
        r = f32(1.0) + f32(it)
        eff = (lam + lam_s[None, :]).astype(f32)
        adj = mm + (eff[:, None, :, None]
                    * ss.reshape(T, N, L, K)).reshape(T, N, L * K)
        idx = adj.argmin(2)
        chosen = np.take_along_axis(ss, idx[:, :, None], 2)[:, :, 0]
        onehot = np.where((idx // K)[:, :, None] == np.arange(L),
                          chosen[..., None].astype(np.float64), 0.0)
        use = onehot.sum(1).astype(f32)
        g = np.where(np.isfinite(capf), use - capf, f32(0)).astype(f32)
        lam = np.maximum(lam + (st / r).astype(f32) * g, f32(0)).astype(f32)
        gs = np.where(np.isfinite(scf), fleet_sum(use) - scf,
                      f32(0)).astype(f32)
        lam_s = np.maximum(lam_s + (f32(sstep) / r) * gs,
                           f32(0)).astype(f32)
        cells.append(idx.copy())
        lams.append(lam_s.copy())
    return np.stack(cells), np.stack(lams)


def _order_deciding_fleet(seed, iters=60):
    """A coupled fleet whose cells depend on how the fleet-wide sum is
    taken: exactly, or in float32 tenant after tenant. The fleet's most
    used tier is capped at 60% of its greedy use.
    One extra row in tenant 0 may take that tier (cost 0) or a neighbour
    (cost ``c``, uncapped), with 2**-30 GB in either: its adjusted cost on
    the capped tier is the shared multiplier times 2**-30, and its bytes
    vanish in every sum they join, so its choice moves no multiplier. At
    the first step where the two sums' multipliers part, ``c`` is set to
    the one that the lower index wins a tie for: that sum keeps one tier,
    the other takes the other at the next step. Returns the scan's
    arguments and that step, or None when the sums never part."""
    rng = np.random.default_rng(seed)
    T, L, K = 6, 4, 3
    Ns = rng.integers(3, 9, T)
    n_max = int(Ns.max()) + 1
    m = np.full((T, n_max, L, K), BIG)
    s = np.zeros((T, n_max, L, K))
    use0 = np.zeros(L)
    for t, n in enumerate(Ns):
        c, f, st, _ = _tenant(rng, int(n))
        m[t, :n], s[t, :n] = topt._masked(c, f), st
        cell = m[t, :n].reshape(n, -1).argmin(1)
        use0 += topt._chosen_usage(s[t, :n], cell // K, cell % K)
    tgt = int(use0.argmax())
    other = tgt + 1 if tgt + 1 < L else tgt - 1
    n0, tiny = int(Ns[0]), 2.0 ** -30
    m[0, n0, tgt, 0], s[0, n0, :, 0] = 0.0, tiny
    scap = np.full(L, np.inf)
    scap[tgt] = 0.6 * use0[tgt]
    cap = np.full((T, L), np.inf)
    # a step well under the solver's heuristic: the multiplier climbs
    # over many steps, so many different sets of rows get summed
    sstep = 0.02 * float(m[m < BIG].mean() / scap[tgt])
    args = (m, s, cap, scap, np.zeros(T), sstep, iters)
    a = _emulate(*args, "exact")[1][:, tgt]
    b = _emulate(*args, "rows")[1][:, tgt]
    parted = np.flatnonzero(a[:-1] != b[:-1])
    if not parted.size:
        return None
    k = int(parted[0])
    lam = min(a[k], b[k]) if other > tgt else max(a[k], b[k])
    m[0, n0, other, 0] = float(lam) * tiny
    return args, k + 1


def test_exact_fleet_sum_pins_a_cell_the_order_would_decide():
    """The port's cells are the exact sum's; a float32 sum tenant after
    tenant takes another cell at step ``k``. The reference, run on the same
    arguments, sums in float32 and agrees with the port on every step
    before ``k`` (ROADMAP queue 3: the fleet scan's usage sum)."""
    found = None
    for seed in range(40):
        found = _order_deciding_fleet(seed)
        if found is not None:
            break
    assert found is not None, "no seed gives an order-deciding fleet"
    (m, s, cap, scap, step, sstep, iters), k = found
    T, N, L = m.shape[0], m.shape[1], m.shape[2]
    got = topt._fleet_scan(m, s, cap, np.zeros(L, np.int64),
                           np.full((T, 1), np.inf), np.arange(L), scap,
                           step, sstep, iters, CPU)
    exact, _ = _emulate(m, s, cap, scap, step, sstep, iters, "exact")
    rows, _ = _emulate(m, s, cap, scap, step, sstep, iters, "rows")
    np.testing.assert_array_equal(got, exact)
    assert (exact[k] != rows[k]).any()
    want = _ref_cells(m, s, cap, np.zeros(L, np.int64),
                      np.full((T, 1), np.inf), np.arange(L), scap, step,
                      sstep, iters)
    np.testing.assert_array_equal(got[:k], want[:k])


# ----------------------------------------------------------- corner cases
def test_zero_partition_tenant_and_empty_fleet():
    empty = _tenant(np.random.default_rng(5), 0)
    single = topt.capacitated_assign(*empty, device="cpu")
    assert single.feasible and single.cost == 0.0
    assert topt.greedy_assign(empty[0], empty[1], device="cpu").feasible
    got = topt.capacitated_assign_batch([empty[0]], [empty[1]], [empty[2]],
                                        [empty[3]], device="cpu")
    assert got.feasible and got.cost == 0.0
    out = topt.capacitated_assign_batch([], [], [], np.ones(4), device="cpu")
    assert out.feasible and out.cost == 0.0 and out.assignments == []
    out = topt.capacitated_assign_batch(
        [], [], [], np.ones(4), shared_tier_groups=np.zeros(4, int),
        shared_capacity_gb=np.ones(1), device="cpu")
    np.testing.assert_array_equal(out.shared_use_gb, [0.0])


def test_all_infeasible_tenant_reported_not_crashed():
    L, K = 4, 2
    cost, stored = np.ones((3, L, K)), np.ones((3, L, K))
    feas = np.zeros((3, L, K), bool)
    cap = np.full(L, np.inf)
    got = topt.capacitated_assign_batch([cost], [feas], [stored], [cap],
                                        device="cpu")
    _same_fleet(got, jopt.capacitated_assign_batch([cost], [feas], [stored],
                                                   [cap]))
    assert not got.feasible and got.cost == float("inf")
    assert not topt.capacitated_assign(cost, feas, stored, cap,
                                       device="cpu").feasible


# ------------------------------------------------------------ FleetEngine
def _problems(eng, table, cfg, Ns, seed, K=3):
    rng = np.random.default_rng(seed)
    out = []
    for N in Ns:
        out.append(eng.PlacementProblem(
            spans_gb=rng.uniform(0.5, 50.0, N), rho=rng.gamma(1.0, 20.0, N),
            current_tier=np.full(N, -1),
            R=np.concatenate([np.ones((N, 1)),
                              rng.uniform(1.2, 6.0, (N, K - 1))], 1),
            D=np.concatenate([np.zeros((N, 1)),
                              rng.uniform(0.01, 3.0, (N, K - 1))], 1),
            schemes=list(cfg.schemes)[:K], table=table, cfg=cfg))
    return out


def _two_providers(costs, alpha_gb=np.inf):
    az = costs.azure_table()
    return costs.multi_cloud_table(
        [costs.ProviderCostTable("alpha", az, capacity_gb=alpha_gb),
         costs.ProviderCostTable("beta", az)])


def _fleets(table_fn, cfg_kw, Ns, seed, K=3, **fleet_kw):
    """``{pkg: (FleetEngine, PlacementEngine, problems)}`` on the same
    arrays."""
    out = {}
    for k, (eng, costs, fl) in {"j": (jeng, jcosts, jfleet),
                                "t": (teng, tcosts, tfleet)}.items():
        kw = dict(cfg_kw)
        if k == "t":
            kw["device"] = "cpu"
        table = table_fn(costs)
        cfg = eng.ScopeConfig(**kw)
        fk = dict(fleet_kw)
        if callable(fk.get("fleet_provider_capacity_gb")):
            fk["fleet_provider_capacity_gb"] = \
                fk["fleet_provider_capacity_gb"](table)
        out[k] = (fl.FleetEngine(table, cfg, **fk),
                  eng.PlacementEngine(table, cfg),
                  _problems(eng, table, cfg, Ns, seed, K))
    return out


ENGINE_CASES = {
    "greedy": (lambda c: c.azure_table(),
               dict(schemes=("none", "lz4", "zstd3")), (6, 9, 4, 7), 6, 3),
    "capacitated": (lambda c: c.azure_table(),
                    dict(schemes=("none", "lz4", "zstd3"),
                         capacity_gb=np.array([25.0, 50.0, 300.0, np.inf])),
                    (6, 9, 4), 7, 3),
    "provider_caps": (lambda c: _two_providers(c, alpha_gb=60.0),
                      dict(schemes=("none", "lz4")), (5, 8, 6), 8, 2),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_fleet_engine_solve_and_reoptimize_match_repro(case):
    table_fn, cfg_kw, Ns, seed, K = ENGINE_CASES[case]
    runs = _fleets(table_fn, cfg_kw, Ns, seed, K)
    plans = {k: fe.solve(probs) for k, (fe, _, probs) in runs.items()}
    _same_fleet(plans["t"].fleet, plans["j"].fleet)
    assert plans["t"].total_cents == pytest.approx(plans["j"].total_cents,
                                                   rel=1e-6)
    fe, pe, probs = runs["t"]
    for p, plan in zip(probs, plans["t"].plans):
        single = pe.solve(p)
        assert _identical(single.assignment, plan.assignment)
        assert single.report.total_cents == plan.report.total_cents
    rng = np.random.default_rng(seed + 1)
    new_rhos = [p.rho * rng.choice([0.01, 1.0, 50.0], p.n) for p in probs]
    migs = {k: runs[k][0].reoptimize(plans[k].plans, new_rhos,
                                     months_held=2.0)[0] for k in runs}
    for a, b, single, rho in zip(migs["t"], migs["j"], plans["t"].plans,
                                 new_rhos):
        for f in ("moved", "new_tier", "new_scheme"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for f in ("migration_cents", "penalty_cents", "egress_cents"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-6,
                                                  abs=1e-12)
        ref = pe.reoptimize(single, rho, months_held=2.0)
        np.testing.assert_array_equal(ref.moved, a.moved)
        assert ref.plan.report.total_cents == a.plan.report.total_cents
    assert any(m.n_moved for m in migs["t"])


@pytest.mark.parametrize("frac", [0.6, 0.8])
def test_fleet_provider_capacity_couples_tenants(frac):
    base = _fleets(_two_providers, dict(schemes=("none", "lz4")),
                   (5, 8, 6), 8, K=2)
    fe, _, probs = base["t"]
    plan0 = fe.solve(probs)
    prov = np.asarray(fe.table.provider_of_tier, int)
    use_p = np.zeros(2)
    for plan in plan0.plans:
        np.add.at(use_p, prov[plan.assignment.tier.astype(int)],
                  plan.stored_gb)
    big = int(use_p.argmax())
    caps = lambda t: {t.provider_names[big]: frac * use_p[big]}
    runs = _fleets(_two_providers, dict(schemes=("none", "lz4")),
                   (5, 8, 6), 8, K=2, fleet_provider_capacity_gb=caps)
    assert runs["t"][0].coupled
    plans = {k: fe_.solve(p) for k, (fe_, _, p) in runs.items()}
    _same_fleet(plans["t"].fleet, plans["j"].fleet)
    got = np.zeros(2)
    for plan in plans["t"].plans:
        np.add.at(got, prov[plan.assignment.tier.astype(int)],
                  plan.stored_gb)
    assert plans["t"].fleet.feasible
    assert got[big] <= frac * use_p[big] + 1e-9
    assert plans["t"].total_cents >= plan0.total_cents - 1e-9


@pytest.mark.parametrize("kw,match", [
    (dict(fleet_provider_capacity_gb={"x": 1.0}), "MultiCloudCostTable"),
    (dict(fleet_provider_capacity_gb={"alpha": 1.0},
          shared_capacity_gb=np.ones(1)), "not both")])
def test_fleet_engine_validates_provider_arguments(kw, match):
    table = tcosts.azure_table() if "x" in kw.get(
        "fleet_provider_capacity_gb", {}) else _two_providers(tcosts)
    with pytest.raises(ValueError, match=match):
        tfleet.FleetEngine(table, teng.ScopeConfig(device="cpu"), **kw)


def test_fleet_engine_rejects_unknown_providers():
    with pytest.raises(ValueError, match="unknown providers"):
        tfleet.FleetEngine(_two_providers(tcosts),
                           teng.ScopeConfig(device="cpu"),
                           fleet_provider_capacity_gb={"gamma": 1.0})
