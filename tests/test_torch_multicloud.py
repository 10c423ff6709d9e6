"""Multi-cloud placement in the port against ``repro``: the flattened
``(provider, tier)`` tables (``big3_table``, ``multi_cloud_table`` with and
without regions), provider whitelists, per-provider capacities as group
rows of the capacitated solver, egress billed once on moves (engine and
store), and ``early_delete_penalty_gb``. These are the cases of
``tests/test_multicloud.py`` that need no fleet or streaming engine, each
run through both packages on the same numpy inputs."""

import dataclasses

import numpy as np
import pytest

from repro.core import costs as jc
from repro.core import engine as je
from repro.core import optassign as jo
from repro.storage.store import TieredStore as JStore
from repro_torch.core import costs as tc
from repro_torch.core import engine as te
from repro_torch.core import optassign as to
from repro_torch.storage.store import TieredStore as TStore

SCHEMES = ("none", "a", "b")
TABLE_FIELDS = ("storage_cents_gb_month", "read_cents_gb", "write_cents_gb",
                "ttfb_seconds", "capacity_gb", "early_delete_months",
                "provider_of_tier", "egress_cents_gb", "provider_capacity_gb")


def _alpha_beta(c, egress_alpha=5.0, egress_beta=7.0, alpha_cap=np.inf,
                beta_cap=np.inf):
    """``tests/test_multicloud.py``'s two hand-built providers, from costs
    module ``c``: hot data prefers alpha, cold data beta."""
    alpha = c.CostTable(
        storage_cents_gb_month=np.array([10.0, 8.0]),
        read_cents_gb=np.array([0.1, 0.5]),
        write_cents_gb=np.array([0.05, 0.05]),
        ttfb_seconds=np.array([0.01, 0.05]),
        capacity_gb=np.array([np.inf, np.inf]),
        early_delete_months=np.array([0.0, 0.0]), names=("hot", "warm"))
    beta = c.CostTable(
        storage_cents_gb_month=np.array([2.0, 0.2]),
        read_cents_gb=np.array([1.0, 4.0]),
        write_cents_gb=np.array([0.05, 0.05]),
        ttfb_seconds=np.array([0.05, 0.2]),
        capacity_gb=np.array([np.inf, np.inf]),
        early_delete_months=np.array([0.0, 1.0]), names=("std", "cold"))
    return c.multi_cloud_table([
        c.ProviderCostTable("alpha", alpha, egress_alpha, alpha_cap),
        c.ProviderCostTable("beta", beta, egress_beta, beta_cap)])


def _regions(c):
    az = c.azure_table()
    return c.multi_cloud_table([
        c.ProviderCostTable("azure", az, 8.7, region="east",
                            region_egress_out_cents_gb=2.0),
        c.ProviderCostTable("azure", az, 8.7, region="west",
                            region_egress_out_cents_gb=2.0),
        c.ProviderCostTable("aws", c.aws_s3_provider().table, 9.0)])


TABLES = {
    "big3": lambda c: c.big3_table(),
    "big3_capped": lambda c: c.big3_table(aws_capacity_gb=50.0,
                                          azure_capacity_gb=20.0),
    "alpha_beta": _alpha_beta,
    "regions": _regions,
    "explicit": lambda c: c.multi_cloud_table(
        [c.ProviderCostTable("a", c.azure_table()),
         c.ProviderCostTable("b", c.azure_table())],
        egress_cents_gb=np.array([[99.0, 3.0], [4.0, 99.0]])),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_tables_match_repro(name):
    j, t = TABLES[name](jc), TABLES[name](tc)
    assert isinstance(t, tc.MultiCloudCostTable)
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    assert t.names == j.names and t.provider_names == j.provider_names
    assert t.provider_regions == j.provider_regions
    assert t.compute_cents_sec == j.compute_cents_sec
    assert t.num_providers == j.num_providers
    np.testing.assert_array_equal(t.tier_change_cents_gb(),
                                  j.tier_change_cents_gb())
    for p in range(t.num_providers):
        np.testing.assert_array_equal(t.provider_tiers(p),
                                      j.provider_tiers(p))
    L = t.num_tiers
    f = np.repeat(np.arange(-1, L), L + 1)
    to_ = np.tile(np.arange(-1, L), L + 1)
    np.testing.assert_array_equal(tc.move_egress_cents_gb(t, f, to_),
                                  jc.move_egress_cents_gb(j, f, to_))


def test_presets_and_capacity_table_match_repro():
    for fn in ("aws_s3_provider", "gcp_gcs_provider", "azure_blob_provider"):
        j, t = getattr(jc, fn)(12.5), getattr(tc, fn)(12.5)
        assert (t.provider, t.egress_out_cents_gb, t.capacity_gb) == \
            (j.provider, j.egress_out_cents_gb, j.capacity_gb)
        assert t.table.names == j.table.names
        for f in TABLE_FIELDS[:6]:
            np.testing.assert_array_equal(getattr(t.table, f),
                                          getattr(j.table, f))
    for total in (10.0, np.inf):
        np.testing.assert_array_equal(
            tc.tpch_capacity_table(total).capacity_gb,
            jc.tpch_capacity_table(total).capacity_gb)
    np.testing.assert_array_equal(tc.azure_table().retrieval_latency_ms,
                                  jc.azure_table().retrieval_latency_ms)
    with pytest.raises(ValueError):
        tc.multi_cloud_table([])
    with pytest.raises(ValueError):
        tc.multi_cloud_table([tc.ProviderCostTable("a", tc.azure_table())],
                             egress_cents_gb=np.zeros((2, 2)))
    # single-cloud tables never pay egress
    assert float(tc.move_egress_cents_gb(tc.azure_table(), 0, 3)) == 0.0


@pytest.mark.parametrize("name", ["big3", "alpha_beta", "single"])
def test_early_delete_penalty_matches_repro(name):
    mk = {"big3": lambda c: c.big3_table(),
          "alpha_beta": _alpha_beta,
          "single": lambda c: c.azure_table()}[name]
    j, t = mk(jc), mk(tc)
    rng = np.random.default_rng(1)
    cur = rng.integers(-1, t.num_tiers, 300)
    for held in (0.0, 0.5, rng.uniform(0.0, 14.0, 300)):
        np.testing.assert_array_equal(tc.early_delete_penalty_gb(t, cur, held),
                                      jc.early_delete_penalty_gb(j, cur, held))


def _problem(eng, table, cfg, N=80, seed=3, K=3):
    rng = np.random.default_rng(seed)
    spans = rng.lognormal(0.0, 1.2, N) * 2.0
    rho = rng.gamma(0.7, 25.0, N)
    R = np.concatenate([np.ones((N, 1)), rng.uniform(1.2, 6.0, (N, K - 1))],
                       1)
    D = np.concatenate([np.zeros((N, 1)),
                        rng.uniform(0.01, 2.0, (N, K - 1)) * spans[:, None]],
                       1)
    return eng.PlacementProblem(spans_gb=spans, rho=rho,
                                current_tier=np.full(N, -1), R=R, D=D,
                                schemes=list(cfg.schemes), table=table,
                                cfg=cfg)


def _solve_both(table_fn, N=80, **cfg_kw):
    out = {}
    for k, eng, c in (("j", je, jc), ("t", te, tc)):
        kw = dict(cfg_kw, schemes=SCHEMES)
        if k == "t":
            kw["device"] = "cpu"
        cfg = eng.ScopeConfig(**kw)
        table = table_fn(c)
        e = eng.PlacementEngine(table, cfg)
        out[k] = (e, e.solve(_problem(eng, table, cfg, N=N)))
    a, b = out["j"][1], out["t"][1]
    np.testing.assert_array_equal(b.assignment.tier, a.assignment.tier)
    np.testing.assert_array_equal(b.assignment.scheme, a.assignment.scheme)
    assert b.assignment.feasible == a.assignment.feasible
    assert b.report.total_cents == pytest.approx(a.report.total_cents,
                                                 rel=1e-6)
    assert b.report.provider_scheme == a.report.provider_scheme
    return out


@pytest.mark.parametrize("whitelist", [None, ("aws",), ("gcp",), ("azure",),
                                       ("aws", "azure")])
def test_provider_whitelist_matches_repro(whitelist):
    out = _solve_both(lambda c: c.big3_table(), provider_whitelist=whitelist)
    plan = out["t"][1]
    t = plan.problem.table
    allowed = {t.provider_names.index(p)
               for p in (whitelist or t.provider_names)}
    assert set(np.unique(t.provider_of_tier[plan.assignment.tier])) <= allowed


def test_cross_provider_never_costlier_than_best_single():
    cross = _solve_both(lambda c: c.big3_table())["t"][1].report.total_cents
    singles = [_solve_both(lambda c: c.big3_table(),
                           provider_whitelist=(p,))["t"][1].report.total_cents
               for p in ("aws", "gcp", "azure")]
    assert cross <= min(singles) + 1e-9


def test_provider_whitelist_errors_like_repro():
    for bad, table in ((("nope",), tc.big3_table()),
                       (("gcp",), tc.azure_table())):
        cfg = te.ScopeConfig(schemes=SCHEMES, provider_whitelist=bad,
                             device="cpu")
        with pytest.raises(ValueError):
            te.PlacementEngine(table, cfg).solve(_problem(te, table, cfg))


@pytest.mark.parametrize("alpha_cap", [5.0, 12.0])
def test_provider_caps_as_group_rows_match_repro(alpha_cap, monkeypatch):
    scans = []
    scan = to._lagrangian_scan
    monkeypatch.setattr(to, "_lagrangian_scan",
                        lambda *a: scans.append(1) or scan(*a))
    out = _solve_both(lambda c: _alpha_beta(c, alpha_cap=alpha_cap), N=200)
    plan = out["t"][1]
    assert plan.assignment.feasible and scans   # the group row binds
    t = plan.problem.table
    alpha = t.provider_of_tier[plan.assignment.tier] == 0
    assert plan.stored_gb[alpha].sum() <= alpha_cap + 1e-6
    # the group rows reach the solver through solver_inputs
    eng, prob = out["t"][0], plan.problem
    *_, tg, gcap = eng.assign.solver_inputs(prob)
    np.testing.assert_array_equal(tg, t.provider_of_tier)
    np.testing.assert_array_equal(gcap, [alpha_cap, np.inf])


def test_capped_big3_matches_repro():
    _solve_both(lambda c: c.big3_table(azure_capacity_gb=40.0), N=200)


def _tiny(table, seed, N=5, K=2):
    rng = np.random.default_rng(seed)
    spans = rng.uniform(0.5, 50.0, N)
    rho = rng.gamma(1.0, 20.0, N)
    cur = rng.integers(-1, table.num_tiers, N)
    R = np.concatenate([np.ones((N, 1)), rng.uniform(1.2, 6.0, (N, K - 1))],
                       1)
    D = np.concatenate([np.zeros((N, 1)), rng.uniform(0.01, 3.0, (N, K - 1))],
                       1)
    cost = tc.cost_tensor(spans, rho, cur, R, D, table, tc.Weights(),
                          months=6)
    feas = tc.latency_feasible(D, np.full(N, np.inf), table)
    stored = np.repeat((spans[:, None] / R)[:, None, :], table.num_tiers, 1)
    return cost, feas, stored, spans


def test_group_rows_match_repro_and_brute_force_tiny():
    table = _alpha_beta(tc)
    groups = table.provider_of_tier
    checked = 0
    for seed in range(10):
        cost, feas, stored, spans = _tiny(table, seed)
        cap = np.array([spans.sum() * 0.4, np.inf, spans.sum() * 0.4, np.inf])
        gcap = np.array([spans.sum() * 0.6, spans.sum() * 0.9])
        bf = to.brute_force(cost, feas, stored, cap, tier_groups=groups,
                            group_capacity_gb=gcap)
        j = jo.capacitated_assign(cost, feas, stored, cap, tier_groups=groups,
                                  group_capacity_gb=gcap)
        t = to.capacitated_assign(cost, feas, stored, cap, tier_groups=groups,
                                  group_capacity_gb=gcap, device="cpu")
        np.testing.assert_array_equal(t.tier, j.tier)
        np.testing.assert_array_equal(t.scheme, j.scheme)
        assert t.feasible == j.feasible
        if bf.feasible:
            assert t.cost == pytest.approx(bf.cost, rel=1e-9)
            checked += 1
    assert checked >= 5


@pytest.mark.parametrize("months_held", [0.0, 0.25])
def test_reoptimize_across_providers_matches_repro(months_held):
    out = _solve_both(lambda c: c.big3_table(), N=120, months=6.0)
    rng = np.random.default_rng(4)
    rho = out["j"][1].problem.rho.copy()
    hot = rng.random(rho.size) < 0.2
    rho[hot] *= 80.0
    rho[~hot & (rng.random(rho.size) < 0.2)] /= 80.0
    migs = {k: e.reoptimize(p, rho.copy(), months_held=months_held)
            for k, (e, p) in out.items()}
    a, b = migs["j"], migs["t"]
    for f in ("moved", "new_tier", "new_scheme"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    for f in ("migration_cents", "egress_cents", "penalty_cents"):
        assert getattr(b, f) == pytest.approx(getattr(a, f), rel=1e-6,
                                              abs=1e-12)
    np.testing.assert_allclose(b.move_egress_cents, a.move_egress_cents,
                               rtol=1e-9, atol=1e-9)
    assert b.plan.report.provider_scheme == a.plan.report.provider_scheme


def _hot_plan(eng_mod, costs, months=6.0, egress_alpha=5.0):
    table = _alpha_beta(costs, egress_alpha=egress_alpha)
    kw = dict(schemes=("none",), months=months)
    if eng_mod is te:
        kw["device"] = "cpu"
    cfg = eng_mod.ScopeConfig(**kw)
    spans = np.array([1.0, 2.0, 3.0, 4.0]) * 1e-5
    prob = eng_mod.PlacementProblem(
        spans_gb=spans, rho=np.array([100.0, 90.0, 80.0, 60.0]),
        current_tier=np.full(4, -1), R=np.ones((4, 1)), D=np.zeros((4, 1)),
        schemes=["none"], table=table, cfg=cfg,
        raw_bytes=[b"\xab" * int(s * 1e9) for s in spans])
    eng = eng_mod.PlacementEngine(table, cfg)
    return eng, eng.solve(prob)


@pytest.mark.parametrize("egress_alpha", [0.0, 5.0, 500.0])
def test_egress_billed_once_and_hysteresis_match_repro(egress_alpha):
    res = {}
    for k, eng_mod, costs in (("j", je, jc), ("t", te, tc)):
        eng, plan = _hot_plan(eng_mod, costs, months=1.0,
                              egress_alpha=egress_alpha)
        mig = eng.reoptimize(plan, plan.problem.rho * 0.05)
        again = eng.reoptimize(mig.plan, plan.problem.rho * 0.05)
        res[k] = (mig, again)
    for i in range(2):
        a, b = res["j"][i], res["t"][i]
        np.testing.assert_array_equal(b.new_tier, a.new_tier)
        assert b.egress_cents == pytest.approx(a.egress_cents, rel=1e-12,
                                               abs=1e-15)
        assert b.migration_cents == pytest.approx(a.migration_cents,
                                                  rel=1e-12, abs=1e-15)
    assert res["t"][1].n_moved == 0 and res["t"][1].egress_cents == 0.0


def test_store_meters_egress_like_repro():
    meters = {}
    for k, eng_mod, costs, store_cls in (("j", je, jc, JStore),
                                         ("t", te, tc, TStore)):
        eng, plan = _hot_plan(eng_mod, costs)
        store = store_cls(plan.problem.table)
        keys = store.apply_plan(plan)
        store.advance_months(0.5)
        mig = eng.reoptimize(plan, plan.problem.rho * 1e-4, months_held=0.5)
        assert mig.n_moved > 0 and mig.egress_cents > 0.0
        e0 = store.meter.egress_cents
        store.migrate(mig, keys)
        assert store.meter.egress_cents - e0 == pytest.approx(
            mig.egress_cents, rel=1e-9)
        # a re-encode across providers pays egress once, on the old bytes
        raw = bytes(bytearray(range(256))) * 64
        store.put("k", raw, tier=0, codec="none")
        old = store.stored_gb("k")
        e1 = store.meter.egress_cents
        store.replace("k", store.get("k"), 2, "zlib-6")
        assert store.meter.egress_cents - e1 == pytest.approx(old * 5.0)
        meters[k] = dataclasses.asdict(store.meter)
    # a get meters its decompression's wall-clock time: those two fields
    # differ from run to run in either package
    for f, v in meters["j"].items():
        if f not in ("compute_cents", "decomp_seconds"):
            assert meters["t"][f] == pytest.approx(v, rel=1e-12,
                                                   abs=1e-15), f


def test_sync_plan_meters_egress_like_repro():
    """``sync_plan`` keys objects by file set: the initial puts pay no
    egress, and re-syncing a plan that moved every partition to the other
    provider meters the same egress in both packages."""
    class _P:
        def __init__(self, i):
            self.files = frozenset({f"f{i}"})

    meters = {}
    for k, eng_mod, costs, store_cls in (("j", je, jc, JStore),
                                         ("t", te, tc, TStore)):
        eng, plan = _hot_plan(eng_mod, costs)
        parts = [_P(i) for i in range(4)]
        plan = dataclasses.replace(plan, problem=dataclasses.replace(
            plan.problem, partitions=parts))
        store = store_cls(plan.problem.table)
        payloads = [b"y" * 5000 for _ in range(4)]
        store.sync_plan(plan, payloads=payloads)
        assert store.meter.egress_cents == 0.0
        mig = eng.reoptimize(plan, plan.problem.rho * 1e-4)
        plan2 = dataclasses.replace(mig.plan, problem=dataclasses.replace(
            mig.plan.problem, partitions=parts))
        stats = store.sync_plan(plan2, payloads=payloads)
        assert stats["moved"] == 4
        assert store.meter.egress_cents == pytest.approx(
            sum(store.stored_gb(key) * 5.0 for key in store.keys()))
        meters[k] = dataclasses.asdict(store.meter)
    for f, v in meters["j"].items():
        assert meters["t"][f] == pytest.approx(v, rel=1e-12, abs=1e-15), f
