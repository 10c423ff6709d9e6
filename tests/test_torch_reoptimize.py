"""The port's re-optimization under drift against ``repro``'s, on shared
problems (never two truth-mode runs, whose decompression times are
wall-clock):

* ``drift_gate``;
* ``reoptimize`` on the greedy and the capacitated path: identical moves,
  tiers and schemes, cents within rel 1e-6, per-move arrays within 1e-9;
* ``MigrationPlan.select``, ``land`` and ``steady_savings_cents``, with a
  serving SLA and with a cache tier, and no array shared with the plan a
  selection came from;
* ``plan_replicas``, single-cloud (with and without capacities) and
  multi-cloud;
* the port's ``TieredStore`` meter after ``apply_plan`` and ``migrate``,
  against ``repro``'s store driven by ``repro``'s plan;
* the 11 rows of ``paper_scope.variant_grid`` on one small TPC-H instance
  with a fitted predictor carried across.
"""

import dataclasses

import numpy as np
import pytest
from _torch_parity import predictor_arrays

from repro.configs import paper_scope as jps
from repro.core import cache as jcache
from repro.core import compredict as jcp
from repro.core import costs as jcosts
from repro.core import engine as jeng
from repro.data import tpch as jtpch
from repro.storage.store import TieredStore as JStore
from repro_torch import convert
from repro_torch.configs import paper_scope as tps
from repro_torch.core import cache as tcache
from repro_torch.core import costs as tcosts
from repro_torch.core import engine as teng
from repro_torch.core import optassign as topt
from repro_torch.data import tpch as ttpch
from repro_torch.storage.store import TieredStore as TStore

PKGS = {"j": (jeng, jcosts, jcache), "t": (teng, tcosts, tcache)}
MOVE_ARRAYS = ("move_transfer_cents", "move_egress_cents",
               "move_penalty_cents", "old_stored_gb")


def _arrays(N, K, seed):
    """``bench_reoptimize._problem``'s recipe as numpy arrays."""
    rng = np.random.default_rng(seed)
    spans = rng.lognormal(0.0, 1.2, N) * 2.0
    rho = rng.gamma(0.7, 25.0, N)
    R = np.concatenate([np.ones((N, 1)), rng.uniform(1.2, 6.0, (N, K - 1))], 1)
    D = np.concatenate([np.zeros((N, 1)),
                        rng.uniform(0.01, 2.0, (N, K - 1)) * spans[:, None]],
                       1)
    return spans, rho, R, D


def _drift(rho, seed):
    """10% of partitions hot x20-100, 10% cold /20-100 (the benchmark's)."""
    rng = np.random.default_rng(seed)
    new = rho.copy()
    hot = rng.random(rho.shape[0]) < 0.10
    cold = ~hot & (rng.random(rho.shape[0]) < 0.10)
    new[hot] *= rng.uniform(20.0, 100.0, int(hot.sum()))
    new[cold] /= rng.uniform(20.0, 100.0, int(cold.sum()))
    return new


def _engines(table_fn, cfg_kw, N=160, K=3, seed=0):
    """``{pkg: (engine, problem)}`` built from the same numpy arrays."""
    arrs = _arrays(N, K, seed)
    out = {}
    for k, (eng, costs, _) in PKGS.items():
        kw = dict(cfg_kw, schemes=("none", "lz4", "zstd")[:K])
        if k == "t":
            kw["device"] = "cpu"
        cfg = eng.ScopeConfig(**kw)
        table = table_fn(costs)
        spans, rho, R, D = (a.copy() for a in arrs)
        prob = eng.PlacementProblem(
            spans_gb=spans, rho=rho, current_tier=np.full(N, -1), R=R, D=D,
            schemes=cfg.schemes, table=table, cfg=cfg)
        out[k] = (eng.PlacementEngine(table, cfg), prob)
    return out


def _same_plan(a, b):
    np.testing.assert_array_equal(b.assignment.tier, a.assignment.tier)
    np.testing.assert_array_equal(b.assignment.scheme, a.assignment.scheme)
    assert b.report.total_cents == pytest.approx(a.report.total_cents,
                                                 rel=1e-6)
    assert b.report.tiering_scheme == a.report.tiering_scheme
    assert b.report.provider_scheme == a.report.provider_scheme


def _same_migration(a, b):
    for f in ("moved", "candidate", "old_tier", "new_tier", "old_scheme",
              "new_scheme"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    for f in ("migration_cents", "penalty_cents", "egress_cents"):
        assert getattr(b, f) == pytest.approx(getattr(a, f), rel=1e-6,
                                              abs=1e-12), f
    for f in MOVE_ARRAYS:
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=1e-9,
                                   atol=1e-9, err_msg=f)
    _same_plan(a.plan, b.plan)


def test_drift_gate_matches_repro():
    rng = np.random.default_rng(0)
    rho = rng.gamma(0.7, 25.0, 500)
    ref = rho * rng.uniform(0.5, 1.5, 500)
    ref[::7] = 0.0
    for rel, ab in ((0.25, 0.0), (0.1, 2.0), (0.0, 0.0)):
        np.testing.assert_array_equal(teng.drift_gate(rho, ref, rel, ab),
                                      jeng.drift_gate(rho, ref, rel, ab))


@pytest.mark.parametrize("path", ["greedy", "capacitated"])
@pytest.mark.parametrize("held", ["scalar", "per_partition"])
def test_reoptimize_matches_repro(path, held, monkeypatch):
    scans = []
    scan = topt._lagrangian_scan
    monkeypatch.setattr(topt, "_lagrangian_scan",
                        lambda *a: scans.append(1) or scan(*a))
    cfg_kw = dict(tier_whitelist=(0, 1, 2, 3))
    if path == "capacitated":
        # binding: greedy puts 142 GB on cool, and 122 after the drift
        cfg_kw["capacity_gb"] = np.array([np.inf, np.inf, 100.0, np.inf])
    runs = _engines(lambda c: c.azure_table(), cfg_kw)
    plans = {k: eng.solve(p) for k, (eng, p) in runs.items()}
    _same_plan(plans["j"], plans["t"])
    assert plans["t"].assignment.feasible
    new_rho = _drift(plans["j"].problem.rho, 1)
    months = (0.25 if held == "scalar"
              else np.random.default_rng(2).uniform(0.0, 8.0, 160))
    migs = {k: runs[k][0].reoptimize(plans[k], new_rho.copy(),
                                     months_held=months)
            for k in runs}
    _same_migration(migs["j"], migs["t"])
    assert migs["t"].n_moved > 0
    # the capacities bind: the port's dual ascent ran for the plan and
    # for the re-optimization
    assert len(scans) == (2 if path == "capacitated" else 0)
    if path == "capacitated":
        assert migs["t"].plan.assignment.feasible


def test_reoptimize_with_rho_ref_and_abs_floor_matches_repro():
    runs = _engines(lambda c: c.azure_table(), {})
    plans = {k: eng.solve(p) for k, (eng, p) in runs.items()}
    new_rho = _drift(plans["j"].problem.rho, 3)
    base = plans["j"].problem.rho * 1.3
    migs = {k: runs[k][0].reoptimize(plans[k], new_rho.copy(),
                                     months_held=1.0, rho_ref=base,
                                     rho_abs_tol=5.0, rho_rel_tol=0.1)
            for k in runs}
    _same_migration(migs["j"], migs["t"])
    with pytest.raises(ValueError):
        runs["t"][0].reoptimize(plans["t"], new_rho, months_held=np.ones(3))


SERVING = {
    "sla": dict(sla_ms=80.0, sla_lambda=0.02),
    "cache": dict(cache="cfg"),
    "sla+cache": dict(sla_ms=80.0, sla_lambda=0.02, cache="cfg"),
}


def _serving_runs(kind):
    runs = {}
    for k, (eng, costs, cache) in PKGS.items():
        kw = dict(SERVING[kind], tier_whitelist=(0, 1, 2, 3))
        if "cache" in kw:
            kw["cache"] = cache.CacheConfig(capacity_gb=40.0, miss_rate=0.2,
                                            hit_latency_ms=1.0)
        one = _engines(lambda c: c.azure_table(), kw, seed=5)
        runs[k] = one[k]
    return runs


@pytest.mark.parametrize("kind", sorted(SERVING))
def test_select_land_and_savings_match_repro(kind):
    runs = _serving_runs(kind)
    plans = {k: eng.solve(p) for k, (eng, p) in runs.items()}
    _same_plan(plans["j"], plans["t"])
    new_rho = _drift(plans["j"].problem.rho, 6)
    migs = {k: runs[k][0].reoptimize(plans[k], new_rho.copy(),
                                     months_held=0.5) for k in runs}
    _same_migration(migs["j"], migs["t"])
    for months in (None, 2.0):
        np.testing.assert_allclose(migs["t"].steady_savings_cents(months),
                                   migs["j"].steady_savings_cents(months),
                                   rtol=1e-9, atol=1e-9)
    cand = np.flatnonzero(migs["j"].candidate)
    assert cand.size >= 4
    keep = np.zeros(160, bool)
    keep[cand[::2]] = True
    sel = {k: m.select(keep) for k, m in migs.items()}
    _same_migration(sel["j"], sel["t"])
    np.testing.assert_array_equal(sel["t"].deferred, sel["j"].deferred)
    assert sel["t"].n_moved == cand[::2].size
    # everything kept: the plan itself, as in the reference
    assert migs["t"].select(np.ones(160, bool)) is migs["t"]
    unapplied = np.zeros(160, bool)
    unapplied[cand[::4]] = True
    landed = {k: s.land(unapplied) for k, s in sel.items()}
    _same_migration(landed["j"], landed["t"])
    assert sel["t"].land(np.zeros(160, bool)) is sel["t"]


def test_select_shares_no_array_with_its_plan():
    runs = _engines(lambda c: c.azure_table(), {})
    eng, prob = runs["t"]
    plan = eng.solve(prob)
    mig = eng.reoptimize(plan, _drift(prob.rho, 7), months_held=0.5)
    before = {f: getattr(mig, f).copy() for f in
              ("moved", "candidate", "old_tier", "new_tier", "old_scheme",
               "new_scheme") + MOVE_ARRAYS}
    tier0 = mig.plan.assignment.tier.copy()
    keep = mig.candidate.copy()
    keep[np.flatnonzero(keep)[0]] = False
    sel = mig.select(keep)
    for f in before:
        arr = getattr(sel, f)
        assert not np.shares_memory(arr, getattr(mig, f)), f
        arr[...] = 0
    sel.plan.assignment.tier[...] = -7
    for f, v in before.items():
        np.testing.assert_array_equal(getattr(mig, f), v, f)
    np.testing.assert_array_equal(mig.plan.assignment.tier, tier0)


@pytest.mark.parametrize("table,cfg_kw", [
    ("azure", dict(replicas=2, replica_rho_min=30.0)),
    ("azure", dict(replicas=3, replica_rho_min=20.0,
                   capacity_gb=np.array([80.0, 150.0, np.inf, np.inf]))),
    ("big3", dict(replicas=3, replica_rho_min=40.0, months=2.0)),
    ("big3", dict(replicas=2, replica_rho_min=10.0, sla_ms=100.0,
                  sla_lambda=0.01)),
])
def test_plan_replicas_matches_repro(table, cfg_kw):
    fn = ((lambda c: c.azure_table()) if table == "azure"
          else (lambda c: c.big3_table()))
    runs = _engines(fn, cfg_kw, N=60, seed=4)
    plans = {k: eng.solve(p) for k, (eng, p) in runs.items()}
    _same_plan(plans["j"], plans["t"])
    reps = {k: runs[k][0].plan_replicas(plans[k]) for k in runs}
    a, b = reps["j"], reps["t"]
    assert b.n_replicated > 0 and b.n_replicated == a.n_replicated
    for f in ("copies", "replica_tier", "replica_scheme"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    assert b.replica_cents == pytest.approx(a.replica_cents, rel=1e-6)
    assert b.read_rebate_cents == pytest.approx(a.read_rebate_cents, rel=1e-6)
    np.testing.assert_allclose(b.best_latency_ms, a.best_latency_ms,
                               rtol=1e-12)
    pa = a.latency_points(plans["j"].problem, plans["j"].assignment)
    pb = b.latency_points(plans["t"].problem, plans["t"].assignment)
    for x, y in zip(pb, pa):
        np.testing.assert_allclose(x, y, rtol=1e-12)
    if table == "big3":
        prov = plans["t"].problem.table.provider_of_tier
        for i in np.flatnonzero(b.copies > 1):
            ps = [prov[plans["t"].assignment.tier[i]]] + [
                prov[l] for l in b.replica_tier[i] if l >= 0]
            assert len(ps) == len(set(ps)) == b.copies[i]


def _store_problem(eng_mod, table, cfg):
    """Six uncompressed partitions of real payloads (tens of KB)."""
    spans = np.array([1.0, 2.0, 3.0, 4.0, 2.5, 1.5]) * 1e-5
    raws = [bytes([0xab + i]) * int(s * 1e9) for i, s in enumerate(spans)]
    return eng_mod.PlacementProblem(
        spans_gb=spans, rho=np.array([100.0, 90.0, 80.0, 60.0, 0.5, 0.01]),
        current_tier=np.full(6, -1), R=np.ones((6, 1)), D=np.zeros((6, 1)),
        schemes=["none"], table=table, cfg=cfg, raw_bytes=raws)


@pytest.mark.parametrize("table", ["azure", "big3"])
def test_store_meter_after_migrate_matches_repro(table):
    meters, migs = {}, {}
    for k, (eng_mod, costs, _) in PKGS.items():
        t = costs.azure_table() if table == "azure" else costs.big3_table()
        kw = dict(schemes=("none",), months=6.0)
        if k == "t":
            kw["device"] = "cpu"
        cfg = eng_mod.ScopeConfig(**kw)
        eng = eng_mod.PlacementEngine(t, cfg)
        plan = eng.solve(_store_problem(eng_mod, t, cfg))
        store = (JStore if k == "j" else TStore)(t)    # one store each
        keys = store.apply_plan(plan)
        store.advance_months(0.5)
        rho = plan.problem.rho * np.array([1e-4, 1e-4, 1.0, 1.0, 500, 1e5])
        mig = eng.reoptimize(plan, rho, months_held=0.5)
        before = dataclasses.asdict(store.meter)
        store.migrate(mig, keys)
        after = dataclasses.asdict(store.meter)
        meters[k] = (before, after)
        migs[k] = mig
        assert mig.n_moved > 0
        for n in np.flatnonzero(mig.moved):
            assert store.tier_of(keys[n]) == mig.new_tier[n]
        transfer = sum(after[f] - before[f] for f in
                       ("read_cents", "write_cents", "egress_cents"))
        assert transfer == pytest.approx(mig.migration_cents, rel=1e-9)
        assert after["penalty_cents"] - before["penalty_cents"] == \
            pytest.approx(mig.penalty_cents, rel=1e-9, abs=1e-15)
        assert after["egress_cents"] - before["egress_cents"] == \
            pytest.approx(mig.egress_cents, rel=1e-9, abs=1e-15)
    _same_migration(migs["j"], migs["t"])
    for (jb, ja), (tb, ta) in [(meters["j"], meters["t"])]:
        for f in ja:
            assert tb[f] == pytest.approx(jb[f], rel=1e-12, abs=1e-15), f
            assert ta[f] == pytest.approx(ja[f], rel=1e-12, abs=1e-15), f


# ------------------------------------------------------ Tables IX-XI grid
@pytest.fixture(scope="module")
def grid_inputs():
    jdb = jtpch.generate(scale_rows=900, seed=0)
    jqs = jtpch.generate_queries(jdb, n_per_template=3, seed=1)
    jparts, jrows = jtpch.partitions_from_queries(jdb, jqs)
    tdb = ttpch.generate(scale_rows=900, seed=0)
    tqs = ttpch.generate_queries(tdb, n_per_template=3, seed=1)
    tparts, trows = ttpch.partitions_from_queries(tdb, tqs)
    jpred = jcp.CompressionPredictor(model_name="SVR").fit(
        jcp.query_samples(jqs, jdb.tables, max_rows=6000)[:40],
        layouts=("col",))
    tpred = convert.predictor_from_arrays(predictor_arrays(jpred))
    total = sum(p.span for p in jparts) / 1e9
    return jparts, jrows, tparts, trows, jpred, tpred, total


def test_paper_scope_defaults_match_repro():
    j, t = jps.default_config(), tps.default_config(device="cpu")
    assert (t.tier_whitelist, t.months) == (j.tier_whitelist, j.months)
    assert tps.EVAL_MONTHS == jps.EVAL_MONTHS
    assert tps.TIERS_NO_ARCHIVE == jps.TIERS_NO_ARCHIVE
    for f in ("storage_cents_gb_month", "read_cents_gb", "write_cents_gb",
              "ttfb_seconds", "early_delete_months"):
        np.testing.assert_array_equal(getattr(tps.COST_TABLE, f),
                                      getattr(jps.COST_TABLE, f))
    assert tps.default_config().device == "cuda"
    assert list(tps.variant_grid(1.0)) == list(jps.variant_grid(1.0))


def test_variant_grid_matches_repro(grid_inputs):
    jparts, jrows, tparts, trows, jpred, tpred, total = grid_inputs
    jgrid, tgrid = jps.variant_grid(total), tps.variant_grid(total, "cpu")
    assert len(tgrid) == 11 and list(tgrid) == list(jgrid)
    table_j, table_t = jps.COST_TABLE, tps.COST_TABLE
    # one partition pass per package serves every row that partitions
    cache = {}
    for name in jgrid:
        jcfg = dataclasses.replace(jgrid[name], predictor=jpred)
        tcfg = dataclasses.replace(tgrid[name], predictor=tpred)
        assert tcfg.device == "cpu"
        key = (jcfg.use_partitioning, jcfg.use_compression)
        if key not in cache:
            jeng_ = jeng.PlacementEngine(table_j, jcfg)
            teng_ = teng.PlacementEngine(table_t, tcfg)
            cache[key] = (jeng_.build_problem(jparts, jrows),
                          teng_.build_problem(tparts, trows))
        jprob, tprob = cache[key]
        np.testing.assert_array_equal(tprob.spans_gb, jprob.spans_gb)
        np.testing.assert_allclose(tprob.R, jprob.R, rtol=1e-9)
        np.testing.assert_allclose(tprob.D, jprob.D, rtol=1e-9)
        # solve both on one shared problem: the reference's arrays
        shared_t = dataclasses.replace(
            tprob, R=jprob.R.copy(), D=jprob.D.copy(), cfg=tcfg)
        jplan = jeng.PlacementEngine(table_j, jcfg).solve(
            dataclasses.replace(jprob, cfg=jcfg))
        tplan = teng.PlacementEngine(table_t, tcfg).solve(shared_t)
        if jcfg.capacity_gb is None:
            np.testing.assert_array_equal(tplan.assignment.tier,
                                          jplan.assignment.tier, name)
            np.testing.assert_array_equal(tplan.assignment.scheme,
                                          jplan.assignment.scheme, name)
        assert tplan.report.total_cents == pytest.approx(
            jplan.report.total_cents, rel=1e-6), name
