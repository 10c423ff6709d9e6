"""The port's ``ReoptimizationDaemon`` against ``repro``'s, cycle by cycle.

Each case gives each package its own engine, plans and stores (the port
on ``device="cpu"``) on shared problems and feeds both the same cycles:

* batch mode: ``benchmarks/bench_daemon.py``'s batch recipe at N 60 (6
  drift cycles, 4 quiet ones), unbudgeted, capped by the bench's rule,
  at a tight cap (a third of the dearest move), with a GB cap, with
  ``amortize_oversized``, with ``min_stay_defer`` off and with
  ``linear_trend_forecast`` as ``forecast_fn``; and a real-payload plan
  landed through an ``AsyncMigrator`` over a ``ChaosStore``;
* streaming mode: the bench's small trace (40 datasets, 8 months, seed 7)
  unbudgeted, at its ``tight`` and ``below_max_move`` caps and with a
  forecast; and a payload stream through a migrator over a chaos store;
* fleet mode: 8 tenants, unbudgeted, with a shared cap that binds and with
  a forecast per tenant; and two payload tenants with a migrator each.

Every cycle's report must match: ``n_candidates``, ``n_selected``,
``n_deferred``, ``max_deferral_age`` and ``n_failed`` identical, cents
within rel 1e-6; so must the state carried to the next cycle (tiers,
schemes, residency clocks, deferral ages). An unbudgeted daemon is
bit-identical to chained ``reoptimize`` / ``ingest_and_reoptimize`` /
``FleetEngine.reoptimize`` calls of the port, and every ``ValueError`` of
``__init__`` is raised with the reference's message.
"""

import dataclasses

import numpy as np
import pytest
from _torch_parity import (PAYLOAD_RHO, PAYLOADS, SMALL_CYCLES,  # noqa: F401
                           meter_sig, one_torch_thread, payload_drift,
                           payload_plans, state_sig, stream_engines,
                           stream_payload)

from repro.core import costs as jcosts
from repro.core import daemon as jdaemon
from repro.core import engine as jeng
from repro.core import fleet as jfleet
from repro.core import migrator as jmig
from repro.storage import chaos as jchaos
from repro.storage import store as jstore
from repro_torch.core import costs as tcosts
from repro_torch.core import daemon as tdaemon
from repro_torch.core import engine as teng
from repro_torch.core import fleet as tfleet
from repro_torch.core import migrator as tmig
from repro_torch.data import workloads as twl
from repro_torch.storage import chaos as tchaos
from repro_torch.storage import store as tstore

PKGS = {"j": (jeng, jcosts, jdaemon, jfleet, jstore, jchaos, jmig),
        "t": (teng, tcosts, tdaemon, tfleet, tstore, tchaos, tmig)}
SAME = ("cycle", "n_partitions", "n_candidates", "n_selected", "n_deferred",
        "max_deferral_age", "n_tenants", "n_failed")
CENTS = ("migration_cents", "egress_cents", "penalty_cents", "spent_cents",
         "moved_gb", "steady_cents", "installment_cents",
         "prepaid_used_cents", "sla_penalty", "retry_cents", "failed_cents",
         "attempted_cents")
BATCH_N = 60


def _cfg(k, **kw):
    eng = PKGS[k][0]
    return eng.ScopeConfig(**kw, **({"device": "cpu"} if k == "t" else {}))


def _same_report(a, b):
    for f in SAME:
        assert getattr(a, f) == getattr(b, f), (f, a, b)
    for f in CENTS:
        assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-6,
                                              abs=1e-12), f


def _same_plan(a, b):
    np.testing.assert_array_equal(a.assignment.tier, b.assignment.tier)
    np.testing.assert_array_equal(a.assignment.scheme, b.assignment.scheme)


# -------------------------------------------------------------- batch mode
def _batch_setup(N=BATCH_N):
    """``bench_daemon.py``'s ``_batch_problem`` and drift cycles, solved in
    both packages: ``{pkg: (engine, plan0)}``, cycles."""
    rng = np.random.default_rng(N)
    spans = rng.lognormal(0.0, 1.2, N) * 2.0
    rho = rng.gamma(0.7, 25.0, N)
    R = np.concatenate([np.ones((N, 1)), rng.uniform(1.2, 6.0, (N, 1))], 1)
    D = np.concatenate([np.zeros((N, 1)),
                        rng.uniform(0.01, 2.0, (N, 1)) * spans[:, None]], 1)
    out = {}
    for k in PKGS:
        eng, costs = PKGS[k][:2]
        cfg = _cfg(k, tier_whitelist=(0, 1, 2, 3), schemes=("none", "lz4"))
        table = costs.azure_table()
        e = eng.PlacementEngine(table, cfg)
        out[k] = (e, e.solve(eng.PlacementProblem(
            spans_gb=spans.copy(), rho=rho.copy(),
            current_tier=np.full(N, -1), R=R.copy(), D=D.copy(),
            schemes=cfg.schemes, table=table, cfg=cfg)))
    _same_plan(out["t"][1], out["j"][1])
    rng = np.random.default_rng(N + 1)
    cycles, r = [], rho.copy()
    for _ in range(6):
        r = r.copy()
        hot = rng.random(N) < 0.05
        cold = ~hot & (rng.random(N) < 0.05)
        r[hot] *= rng.uniform(20.0, 100.0, int(hot.sum()))
        r[cold] /= rng.uniform(20.0, 100.0, int(cold.sum()))
        cycles.append(r.copy())
    return out, cycles + [cycles[-1]] * 4


def _charges(mig):
    return mig.move_transfer_cents + mig.move_egress_cents \
        + mig.move_penalty_cents


def _caps(eng, plan0, cycles):
    """The bench's cap (admits the single most expensive move, sits at 35%
    of the busiest cycle) and a tight one (a third of that move: the
    dearest moves wait for ever, the rest queue and age)."""
    cur, held = plan0, np.zeros(plan0.problem.n)
    per_move, per_cycle = [0.0], [0.0]
    for rho in cycles:
        mig = eng.reoptimize(cur, rho, months_held=held + 1.0)
        held = np.where(mig.moved, 0.0, held + 1.0)
        cur = mig.plan
        per_move.append(float(_charges(mig).max()))
        per_cycle.append(mig.total_move_cents)
    return {"capped": max(1.05 * max(per_move), 0.35 * max(per_cycle)),
            "tight": max(per_move) / 3}


def _run_batch(setup, cycles, budget_kw=None, **kw):
    """Both packages' batch daemons over ``cycles``, checked cycle by
    cycle; returns the port's daemon."""
    ds = {k: PKGS[k][2].ReoptimizationDaemon(
        e, plan=p, budget=PKGS[k][2].MigrationBudget(**(budget_kw or {})),
        **{a: (v[k] if isinstance(v, dict) else v) for a, v in kw.items()})
        for k, (e, p) in setup.items()}
    for rho in cycles:
        a, b = ds["t"].step(rho, months=1.0), ds["j"].step(rho, months=1.0)
        _same_report(a, b)
        _same_plan(ds["t"].plan, ds["j"].plan)
        for f in ("_months_held", "_age_arr", "_rho_ref"):
            np.testing.assert_array_equal(getattr(ds["t"], f),
                                          getattr(ds["j"], f), f)
        np.testing.assert_allclose(ds["t"]._paid, ds["j"]._paid, rtol=1e-6,
                                   atol=1e-12)
    return ds["t"]


@pytest.fixture(scope="module")
def batch():
    setup, cycles = _batch_setup()
    caps = _caps(*setup["j"], cycles)
    for k, v in _caps(*setup["t"], cycles).items():
        assert v == pytest.approx(caps[k], rel=1e-12)
    return setup, cycles, caps


def test_batch_unbudgeted_matches_repro_and_the_plain_chain(batch):
    setup, cycles, _ = batch
    d = _run_batch(setup, cycles)
    eng, cur = setup["t"]
    held = np.zeros(cur.problem.n)
    for rho, rep in zip(cycles, d.history):
        mig = eng.reoptimize(cur, rho, months_held=held + 1.0)
        held = np.where(mig.moved, 0.0, held + 1.0)
        cur = mig.plan
        assert rep.n_selected == mig.n_moved and rep.n_deferred == 0
        assert rep.spent_cents == mig.total_move_cents
        assert rep.steady_cents == mig.plan.report.total_cents
    _same_plan(d.plan, cur)
    assert sum(r.n_selected for r in d.history) > 0


@pytest.mark.parametrize("case", ["capped", "tight", "gb_capped",
                                  "min_stay_off", "forecast"])
def test_batch_budgeted_matches_repro(batch, case):
    setup, cycles, caps = batch
    cap = caps["capped" if case == "capped" else "tight"]
    budget = {"cents_per_cycle": cap}
    kw = {}
    if case == "gb_capped":
        budget = {"gb_per_cycle": 8.0}
    elif case == "min_stay_off":
        kw["min_stay_defer"] = False
    elif case == "forecast":
        kw["forecast_fn"] = {"j": jdaemon.linear_trend_forecast,
                             "t": tdaemon.linear_trend_forecast}
    d = _run_batch(setup, cycles, budget, **kw)
    if case != "capped":
        assert any(r.n_deferred for r in d.history)
    if "cents_per_cycle" in budget:
        assert all(r.spent_cents <= cap + 1e-9 for r in d.history)


def test_batch_amortize_oversized_matches_repro(batch):
    setup, cycles, _ = batch
    eng, plan0 = setup["t"]
    mig0 = eng.reoptimize(plan0, cycles[0], months_held=1.0)
    cap = float(_charges(mig0)[mig0.moved].max()) / 3.5
    d = _run_batch(setup, [cycles[0]] * 8 + cycles[1:],
                   {"cents_per_cycle": cap}, amortize_oversized=True)
    assert any(r.installment_cents > 0 for r in d.history)
    assert any(r.prepaid_used_cents > 0 for r in d.history)
    for r in d.history:
        assert r.spent_cents - r.prepaid_used_cents + r.installment_cents \
            <= cap + 1e-9


def _payload_plans(rho=PAYLOAD_RHO):
    return payload_plans(PAYLOADS, rho, tier_whitelist=(0, 1, 2),
                         months=2.0)


@pytest.mark.parametrize("chaos", [
    dict(seed=5, p_permanent=1.0, max_faults_per_op=1),
    dict(seed=1, p_transient=0.4, p_corrupt=0.2, max_faults_per_op=2)])
def test_batch_migrator_over_chaos_matches_repro(chaos):
    """Failed moves revert (``MigrationPlan.land``) and land on a later
    cycle, as in ``repro``; the stores end identical."""
    plans = _payload_plans()
    stores, ds = {}, {}
    for k, (e, p) in plans.items():
        _, _, dm, _, st, ch, mg = PKGS[k]
        stores[k] = st.TieredStore(e.table)
        keys = stores[k].apply_plan(p)
        ds[k] = dm.ReoptimizationDaemon(
            e, plan=p, store_keys=keys, migrator=mg.AsyncMigrator(
                ch.ChaosStore(stores[k], **chaos), sleep_fn=None,
                max_attempts=6))
    drift = payload_drift(PAYLOAD_RHO)
    for _ in range(5):
        _same_report(ds["t"].step(drift, months=1.0),
                     ds["j"].step(drift, months=1.0))
        _same_plan(ds["t"].plan, ds["j"].plan)
    assert meter_sig(stores["t"]) == meter_sig(stores["j"])
    assert state_sig(stores["t"]) == state_sig(stores["j"])
    assert any(r.n_failed or r.retry_cents for r in ds["t"].history)


def test_batch_zero_fault_migrator_equals_store_mirroring():
    plans = _payload_plans()
    e, p = plans["t"]
    s1, s2 = tstore.TieredStore(e.table), tstore.TieredStore(e.table)
    d1 = tdaemon.ReoptimizationDaemon(e, plan=p, store=s1,
                                      store_keys=s1.apply_plan(p))
    d2 = tdaemon.ReoptimizationDaemon(
        e, plan=p, store_keys=s2.apply_plan(p),
        migrator=tmig.AsyncMigrator(s2, sleep_fn=None))
    for _ in range(3):
        drift = payload_drift(PAYLOAD_RHO)
        r1, r2 = d1.step(drift), d2.step(drift)
        assert r1.spent_cents == r2.spent_cents
        assert r2.n_failed == 0 and r2.retry_cents == 0.0
        assert r2.attempted_cents == pytest.approx(r2.spent_cents,
                                                   abs=1e-15)
    assert meter_sig(s1) == meter_sig(s2)
    assert state_sig(s1) == state_sig(s2)


# ---------------------------------------------------------- streaming mode
@pytest.fixture(scope="module")
def trace():
    """The bench's small trace (40 datasets, 8 months, seed 7)."""
    w = twl.generate_workload(n_datasets=40, n_months=8, seed=7)
    batches = [b for b in twl.stream_query_log(w, np.random.default_rng(7))
               if b]
    return twl.dataset_file_sizes(w), batches


def _held(e):
    return {tuple(sorted(f)): [dataclasses.astuple(s) for s in sts]
            for f, sts in e._held.items()}


def _run_stream(engs, batches, budget_kw=None, **kw):
    ds = {k: PKGS[k][2].ReoptimizationDaemon(
        e, budget=PKGS[k][2].MigrationBudget(**(budget_kw or {})),
        **{a: (v[k] if isinstance(v, dict) else v) for a, v in kw.items()})
        for k, e in engs.items()}
    for b in batches:
        _same_report(ds["t"].step(b, months=1.0), ds["j"].step(b, months=1.0))
        _same_plan(engs["t"].plan, engs["j"].plan)
        assert ds["t"]._ages == ds["j"]._ages
        ha, hb = _held(engs["t"]), _held(engs["j"])
        assert ha.keys() == hb.keys()
        for key in ha:
            np.testing.assert_allclose(ha[key], hb[key], rtol=1e-12)
    return ds["t"]


@pytest.fixture(scope="module")
def stream_caps(trace):
    """The bench's unbudgeted run (through the engine, as the bench peeks
    at the charges) and its ``tight`` and ``below_max_move`` caps."""
    sizes, batches = trace
    e = stream_engines(sizes, drift_threshold=0.5, rho_abs_tol=1.0)["t"]
    per_move, spent = 0.0, []
    for b in batches:
        mig = e.ingest_and_reoptimize(b, months=1.0)
        spent.append(mig.total_move_cents)
        if mig.n_candidates:
            per_move = max(per_move, float(_charges(mig).max()))
    return {"tight": min(1.05 * per_move, 0.999 * max(spent)),
            "below_max_move": 0.5 * per_move}


def test_stream_unbudgeted_matches_repro_and_the_plain_chain(trace):
    sizes, batches = trace
    kw = dict(drift_threshold=0.5, rho_abs_tol=1.0)
    d = _run_stream(stream_engines(sizes, **kw), batches)
    e = stream_engines(sizes, **kw)["t"]
    for b, rep in zip(batches, d.history):
        mig = e.ingest_and_reoptimize(b, months=1.0)
        assert rep.n_selected == mig.n_moved and rep.n_deferred == 0
        assert rep.spent_cents == mig.total_move_cents
        assert rep.steady_cents == mig.plan.report.total_cents
    assert e.history == d.engine.history
    _same_plan(e.plan, d.engine.plan)
    assert sum(r.n_selected for r in d.history) > 0


@pytest.mark.parametrize("case", ["tight", "below_max_move", "forecast"])
def test_stream_budgeted_matches_repro(trace, stream_caps, case):
    sizes, batches = trace
    kw = {}
    cap = stream_caps["tight" if case == "forecast" else case]
    if case == "forecast":
        kw["forecast_fn"] = {"j": jdaemon.linear_trend_forecast,
                             "t": tdaemon.linear_trend_forecast}
    d = _run_stream(stream_engines(sizes, drift_threshold=0.5,
                                    rho_abs_tol=1.0), batches,
                    {"cents_per_cycle": cap}, **kw)
    assert all(r.spent_cents <= cap + 1e-9 for r in d.history)
    if case == "below_max_move":
        assert any(r.n_deferred for r in d.history)


def test_stream_migrator_over_chaos_matches_repro():
    engs = stream_engines()
    stores = {k: PKGS[k][4].TieredStore(e.table) for k, e in engs.items()}
    chaos = {k: PKGS[k][5].ChaosStore(stores[k], seed=1, p_transient=0.35,
                                      p_corrupt=0.1, max_faults_per_op=2)
             for k in PKGS}
    migs = {k: PKGS[k][6].AsyncMigrator(chaos[k], sleep_fn=None,
                                        max_attempts=6) for k in PKGS}
    d = _run_stream(engs, SMALL_CYCLES, payload_fn=stream_payload,
                    migrator=migs)
    assert meter_sig(stores["t"]) == meter_sig(stores["j"])
    assert state_sig(stores["t"]) == state_sig(stores["j"])
    assert chaos["t"].stats.n_faults == chaos["j"].stats.n_faults > 0
    assert sum(r.n_selected for r in d.history) > 0


# --------------------------------------------------------------- fleet mode
def _fleet_setup(Ns=(5, 9, 3, 8, 6, 7, 4, 9), seed=3, K=3):
    rng = np.random.default_rng(seed)
    arrays = []
    for N in Ns:
        arrays.append(dict(
            spans_gb=rng.uniform(0.5, 50.0, N), rho=rng.gamma(1.0, 20.0, N),
            current_tier=np.full(N, -1),
            R=np.concatenate([np.ones((N, 1)),
                              rng.uniform(1.2, 6.0, (N, K - 1))], 1),
            D=np.concatenate([np.zeros((N, 1)),
                              rng.uniform(0.01, 3.0, (N, K - 1))], 1)))
    cycles = []
    rhos = [a["rho"] for a in arrays]
    for _ in range(5):
        rhos = [r * rng.choice([0.02, 1.0, 1.0, 40.0], r.shape[0])
                for r in rhos]
        cycles.append(rhos)
    out = {}
    for k in PKGS:
        eng, costs, _, fl = PKGS[k][:4]
        cfg = _cfg(k, schemes=("none", "lz4", "zstd3"))
        table = costs.azure_table()
        fe = fl.FleetEngine(table, cfg)
        probs = [eng.PlacementProblem(schemes=list(cfg.schemes), table=table,
                                      cfg=cfg, **{f: v.copy() for f, v in
                                                  a.items()})
                 for a in arrays]
        out[k] = (fe, fe.solve(probs).plans)
    for a, b in zip(out["t"][1], out["j"][1]):
        _same_plan(a, b)
    return out, cycles


def _run_fleet(setup, cycles, budget_kw=None, **kw):
    ds = {k: PKGS[k][2].ReoptimizationDaemon(
        fe, plans=list(plans),
        budget=PKGS[k][2].MigrationBudget(**(budget_kw or {})),
        **{a: (v[k] if isinstance(v, dict) else v) for a, v in kw.items()})
        for k, (fe, plans) in setup.items()}
    for rhos in cycles:
        _same_report(ds["t"].step(rhos, months=1.0),
                     ds["j"].step(rhos, months=1.0))
        for t in range(len(rhos)):
            _same_plan(ds["t"].plans[t], ds["j"].plans[t])
            np.testing.assert_array_equal(ds["t"]._age_f[t],
                                          ds["j"]._age_f[t])
            np.testing.assert_array_equal(ds["t"]._months_held_f[t],
                                          ds["j"]._months_held_f[t])
    return ds["t"]


@pytest.fixture(scope="module")
def fleet():
    return _fleet_setup()


def test_fleet_unbudgeted_matches_repro_and_the_plain_chain(fleet):
    setup, cycles = fleet
    d = _run_fleet(setup, cycles)
    fe, plans = setup["t"]
    held = [np.zeros(p.problem.n) for p in plans]
    for rhos, rep in zip(cycles, d.history):
        migs, _ = fe.reoptimize(plans, rhos,
                                months_held=[h + 1.0 for h in held])
        held = [np.where(m.moved, 0.0, h + 1.0) for m, h in zip(migs, held)]
        plans = [m.plan for m in migs]
        assert rep.n_selected == sum(m.n_moved for m in migs)
        assert rep.spent_cents == pytest.approx(
            sum(m.total_move_cents for m in migs), rel=1e-12)
    for a, b in zip(d.plans, plans):
        _same_plan(a, b)
    assert sum(r.n_selected for r in d.history) > 0


@pytest.mark.parametrize("case", ["capped", "forecast"])
def test_fleet_shared_budget_matches_repro(fleet, case):
    setup, cycles = fleet
    unb = _run_fleet(setup, cycles)
    cap = 0.4 * max(r.spent_cents for r in unb.history)
    kw = {}
    if case == "forecast":
        kw["forecast_fn"] = {
            "j": [jdaemon.linear_trend_forecast] * len(cycles[0]),
            "t": [tdaemon.linear_trend_forecast] * len(cycles[0])}
    d = _run_fleet(setup, cycles, {"cents_per_cycle": cap}, **kw)
    assert all(r.spent_cents <= cap + 1e-9 for r in d.history)
    assert any(r.n_deferred for r in d.history)


def test_fleet_migrators_over_chaos_match_repro():
    plans = _payload_plans()
    rev = _payload_plans(PAYLOAD_RHO[::-1].copy())
    ds, stores = {}, {}
    for k in PKGS:
        eng, _, dm, fl, st, ch, mg = PKGS[k]
        e = plans[k][0]
        ps = [plans[k][1], rev[k][1]]
        stores[k], keys, migrs = [], [], []
        for i, p in enumerate(ps):
            s = st.TieredStore(e.table)
            keys.append(s.apply_plan(p))
            stores[k].append(s)
            migrs.append(mg.AsyncMigrator(
                ch.ChaosStore(s, seed=i, p_transient=0.4,
                              max_faults_per_op=2),
                sleep_fn=None, max_attempts=6))
        ds[k] = dm.ReoptimizationDaemon(
            fl.FleetEngine(e.table, e.cfg), plans=ps, migrators=migrs,
            store_keys=keys,
            budget=dm.MigrationBudget(cents_per_cycle=2e-4))
    drifts = [payload_drift(PAYLOAD_RHO), payload_drift(PAYLOAD_RHO[::-1])]
    for _ in range(5):
        r = ds["t"].step(drifts, months=1.0)
        _same_report(r, ds["j"].step(drifts, months=1.0))
        assert r.attempted_cents <= 2e-4 + 1e-9
    for a, b in zip(stores["t"], stores["j"]):
        assert meter_sig(a) == meter_sig(b)
        assert state_sig(a) == state_sig(b)
    assert sum(r.n_selected for r in ds["t"].history) > 0


# ---------------------------------------------------- argument validation
def _invalid_cases(k):
    """``{name: thunk}`` of every ``ValueError`` of ``__init__`` (and the
    fleet step's rho count) in package ``k``."""
    eng, costs, dm, fl, st, _, mg = PKGS[k]
    table = costs.azure_table()
    cfg = _cfg(k, tier_whitelist=(1,), schemes=("none",))
    pe = eng.PlacementEngine(table, cfg)
    plan = pe.solve(eng.PlacementProblem(
        spans_gb=np.ones(2), rho=np.ones(2), current_tier=np.full(2, -1),
        R=np.ones((2, 1)), D=np.zeros((2, 1)), schemes=("none",),
        table=table, cfg=cfg))
    se = eng.StreamingEngine(table, _cfg(k, use_compression=False),
                             {"a": 1.0})
    fe = fl.FleetEngine(table, cfg)
    s = st.TieredStore(table)
    m = mg.AsyncMigrator(s, sleep_fn=None)
    D = dm.ReoptimizationDaemon
    f = dm.linear_trend_forecast
    return {
        "plans_outside_fleet": lambda: D(pe, plan=plan, plans=[plan]),
        "forecast_list_outside_fleet": lambda: D(pe, plan=plan,
                                                 forecast_fn=[f]),
        "forecast_list_length": lambda: D(fe, plans=[plan, plan],
                                          forecast_fn=[f]),
        "amortize_streaming": lambda: D(se, amortize_oversized=True),
        "amortize_fleet": lambda: D(fe, plans=[plan],
                                    amortize_oversized=True),
        "amortize_migrator": lambda: D(pe, plan=plan, migrator=m,
                                       amortize_oversized=True),
        "store_and_migrator": lambda: D(pe, plan=plan, store=s, migrator=m),
        "migrators_outside_fleet": lambda: D(pe, plan=plan, migrators=[m]),
        "fleet_plan": lambda: D(fe, plan=plan, plans=[plan]),
        "fleet_no_plans": lambda: D(fe),
        "fleet_store": lambda: D(fe, plans=[plan], store=s),
        "fleet_migrator": lambda: D(fe, plans=[plan], migrator=m),
        "fleet_migrators_length": lambda: D(fe, plans=[plan, plan],
                                            migrators=[m]),
        "fleet_store_keys": lambda: D(fe, plans=[plan, plan],
                                      migrators=[m, m], store_keys=[["a"]]),
        "stream_plan": lambda: D(se, plan=plan),
        "stream_rho_rel_tol": lambda: D(se, rho_rel_tol=0.5),
        "stream_rho_abs_tol": lambda: D(se, rho_abs_tol=1.0),
        "batch_no_plan": lambda: D(pe),
        "fleet_step_rho_count": lambda: D(fe, plans=[plan, plan]).step(
            [np.ones(2)]),
    }


INVALID = ("plans_outside_fleet", "forecast_list_outside_fleet",
           "forecast_list_length", "amortize_streaming", "amortize_fleet",
           "amortize_migrator", "store_and_migrator",
           "migrators_outside_fleet", "fleet_plan", "fleet_no_plans",
           "fleet_store", "fleet_migrator", "fleet_migrators_length",
           "fleet_store_keys", "stream_plan", "stream_rho_rel_tol",
           "stream_rho_abs_tol", "batch_no_plan", "fleet_step_rho_count")


@pytest.mark.parametrize("case", INVALID)
def test_invalid_arguments_raise_as_repro(case):
    assert sorted(_invalid_cases("t")) == sorted(INVALID)
    errs = {}
    for k in PKGS:
        with pytest.raises(ValueError) as e:
            _invalid_cases(k)[case]()
        errs[k] = str(e.value)
    assert errs["t"] == errs["j"]


def test_knapsack_runs_on_the_engines_device(batch, monkeypatch):
    """The budget knapsack is handed the engine's ``cfg.device``."""
    setup, cycles, caps = batch
    cap = caps["tight"]
    seen = []
    real = tdaemon.budgeted_moves

    def spy(*a, **kw):
        seen.append(kw["device"])
        return real(*a, **kw)

    monkeypatch.setattr(tdaemon, "budgeted_moves", spy)
    eng, plan0 = setup["t"]
    d = tdaemon.ReoptimizationDaemon(
        eng, plan=plan0,
        budget=tdaemon.MigrationBudget(cents_per_cycle=cap))
    d.run(cycles[:2])
    assert seen and set(seen) == {"cpu"}
