"""The port's ``StreamingEngine`` against ``repro``'s, batch by batch.

Each case gives each package its own engine (the port updates its state
in place) and feeds both the same access-log batches. After every batch
the two must agree on the ``StreamStepReport`` (counts identical, cents
within rel 1e-6), on the migration plan (partitions, moves, candidates,
tiers and schemes identical) and on the state carried to the next batch
(``_held``). The port then meets the contract ``tests/test_streaming_engine.py``
pins for the reference: the first batch is all new data, a steady stream
moves nothing, drift moves the drifted partition and carries the rest,
the minimum-stay clock accumulates, empty batches are no-ops,
``select_moves`` defers and re-proposes, ``execute_moves`` lands through
``MigrationPlan.land``, ``rho_abs_tol`` keeps a cold lock, ``project_rho``
replaces the observed rates, and COMPREDICT's re-prediction through
``compredict_rd_fn`` (decompression speeds fixed, as the reference's
fixture fixes them) gives identical plans with compression engaged.
"""

import dataclasses

import numpy as np
import pytest
from _torch_parity import predictor_arrays

from repro.core import costs as jcosts
from repro.core import engine as jeng
from repro.data import tpch as jtpch
from repro.data import workloads as jwl
from repro.storage.store import TieredStore as JStore
from repro_torch import convert
from repro_torch.core import costs as tcosts
from repro_torch.core import engine as teng
from repro_torch.data import tpch as ttpch
from repro_torch.data import workloads as twl
from repro_torch.storage.store import TieredStore as TStore

PKGS = {"j": (jeng, jcosts), "t": (teng, tcosts)}
SIZES = {f"d{i}/{j}": 0.5 + 0.1 * j for i in range(6) for j in range(4)}
COLD = frozenset({"d1/0", "d1/1", "d1/2"})
HOT = frozenset({"d0/0", "d0/1"})
PLAN_ARRAYS = ("moved", "candidate", "old_tier", "new_tier", "old_scheme",
               "new_scheme")


def _hot_cold_batch(hot=400.0, cold=0.01):
    return [(("d0/0", "d0/1"), hot), (("d1/0", "d1/1", "d1/2"), cold)]


def _engines(table_fn=lambda c: c.azure_table(), sizes=SIZES, cfg_kw=None,
             **kw):
    """``{pkg: StreamingEngine}``, each on its own state."""
    rds = {k: kw.pop("rd_fn_" + k, None) for k in PKGS}
    out = {}
    for k, (eng, costs) in PKGS.items():
        ckw = dict(use_compression=False, months=1.0)
        ckw.update(cfg_kw or {})
        if k == "t":
            ckw["device"] = "cpu"
        out[k] = eng.StreamingEngine(table_fn(costs), eng.ScopeConfig(**ckw),
                                     dict(sizes), rd_fn=rds[k], **kw)
    return out


def _held(e):
    return {tuple(sorted(f)): [dataclasses.astuple(s) for s in sts]
            for f, sts in e._held.items()}


def _step(engs, batch, held_rtol=1e-12, **kw):
    """One ``ingest_and_reoptimize`` on each engine; returns the port's
    migration after checking it against the reference's. ``held_rtol``
    bounds the carried stored GB and lock-base rates (1e-5 where the
    port's ratios come from the weighted-entropy kernel's float32
    features, the JAX suite's kernel tolerance)."""
    migs = {k: e.ingest_and_reoptimize(batch, **kw) for k, e in engs.items()}
    a, b = migs["t"], migs["j"]
    ra, rb = engs["t"].history[-1], engs["j"].history[-1]
    for f in ("batch", "n_partitions", "n_new", "n_moved", "compacted",
              "n_deferred", "n_failed"):
        assert getattr(ra, f) == getattr(rb, f), f
    for f in ("migration_cents", "penalty_cents", "steady_cents",
              "egress_cents"):
        assert getattr(ra, f) == pytest.approx(getattr(rb, f), rel=1e-6,
                                               abs=1e-12), f
    pa, pb = a.plan.problem.partitions, b.plan.problem.partitions
    assert [(p.files, p.rho) for p in pa] == [(p.files, p.rho) for p in pb]
    for f in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    np.testing.assert_array_equal(a.plan.assignment.tier,
                                  b.plan.assignment.tier)
    np.testing.assert_array_equal(a.plan.assignment.scheme,
                                  b.plan.assignment.scheme)
    held_a, held_b = _held(engs["t"]), _held(engs["j"])
    assert held_a.keys() == held_b.keys()
    for key in held_a:
        np.testing.assert_allclose(held_a[key], held_b[key], rtol=held_rtol)
    return a


def test_first_batch_places_everything_as_new():
    engs = _engines(s_thresh=5.0)
    mig = _step(engs, _hot_cold_batch())
    assert (mig.old_tier == -1).all()
    assert mig.n_moved == 0 and mig.migration_cents == 0.0
    r = engs["t"].history[-1]
    assert r.n_new == r.n_partitions == 2
    tiers = {p.files: int(t) for p, t in
             zip(mig.plan.problem.partitions, mig.plan.assignment.tier)}
    assert tiers[HOT] < tiers[COLD]


def test_steady_stream_is_idempotent():
    engs = _engines(s_thresh=5.0, window=1, drift_threshold=np.inf)
    _step(engs, _hot_cold_batch())
    for _ in range(3):
        mig = _step(engs, _hot_cold_batch())
        assert mig.n_moved == 0 and mig.total_move_cents == 0.0
        np.testing.assert_array_equal(mig.new_tier, mig.old_tier)


def test_drift_moves_the_drifted_partition_and_carries_state():
    engs = _engines(s_thresh=5.0, window=1, drift_threshold=np.inf)
    _step(engs, _hot_cold_batch())
    drifted = _hot_cold_batch(hot=400.0, cold=500.0)
    mig = _step(engs, drifted)
    i = [n for n, p in enumerate(mig.plan.problem.partitions)
         if p.files == COLD]
    assert len(i) == 1
    assert mig.old_tier[i[0]] >= 0
    assert mig.moved[i[0]] and mig.new_tier[i[0]] < mig.old_tier[i[0]]
    assert mig.n_moved == 1 and mig.migration_cents > 0.0
    for _ in range(2):            # charged once, then stable
        assert _step(engs, drifted).n_moved == 0


def test_minimum_stay_clock_carries_across_batches():
    engs = _engines(s_thresh=5.0, window=1, drift_threshold=np.inf)
    for months, want in ((1.0, 0.0), (1.0, 1.0), (2.5, 3.5)):
        _step(engs, _hot_cold_batch(), months=months)
        assert engs["t"]._held[HOT][0].months_held == pytest.approx(want)


def test_empty_batches_are_noop_and_do_not_freeze_s_thresh():
    engs = _engines(s_thresh=5.0)
    for e in engs.values():
        e._s_thresh = None
    mig = _step(engs, [])
    assert mig.plan.problem.n == 0 and engs["t"].partitioner is None
    mig = _step(engs, _hot_cold_batch())
    assert mig.plan.problem.n == 2
    assert engs["t"].partitioner.s_thresh == engs["j"].partitioner.s_thresh


def _two_provider_table(costs):
    def one_tier(storage, read, egress):
        return costs.ProviderCostTable(
            provider=f"p{storage}", egress_out_cents_gb=egress,
            table=costs.CostTable(
                storage_cents_gb_month=np.array([storage]),
                read_cents_gb=np.array([read]),
                write_cents_gb=np.array([0.01]),
                ttfb_seconds=np.array([0.02]),
                capacity_gb=np.array([np.inf]),
                early_delete_months=np.array([0.0]), names=("only",)))
    return costs.multi_cloud_table([one_tier(10.0, 0.01, 0.5),
                                    one_tier(1.0, 5.0, 0.5)])


def test_empty_batch_after_provider_move_reports_zero_egress():
    engs = _engines(_two_provider_table, sizes={"d0/0": 1.0, "d0/1": 1.0},
                    s_thresh=5.0, window=1, drift_threshold=0.5)
    _step(engs, [(("d0/0", "d0/1"), 100.0)])
    mig = _step(engs, [(("d0/0", "d0/1"), 0.001)])
    assert mig.n_moved == 1 and mig.egress_cents > 0.0
    live = engs["t"].history[-1]
    _step(engs, [])
    empty = _step(engs, [])
    rep = engs["t"].history[-1]
    assert empty.plan.problem.n == 0 and rep.egress_cents == 0.0
    assert set(dataclasses.asdict(rep)) == set(dataclasses.asdict(live))
    assert empty.select(np.zeros(0, bool)) is empty


def test_select_moves_defers_and_reproposes_next_batch():
    engs = _engines(s_thresh=5.0, window=1, drift_threshold=np.inf)
    _step(engs, _hot_cold_batch())
    drifted = _hot_cold_batch(hot=400.0, cold=500.0)
    mig = _step(engs, drifted,
                select_moves=lambda m: np.zeros(m.plan.problem.n, bool))
    assert mig.n_candidates >= 1 and mig.n_moved == 0
    assert mig.total_move_cents == 0.0
    assert engs["t"].history[-1].n_deferred == mig.n_candidates
    mig2 = _step(engs, drifted)
    assert mig2.n_moved == mig.n_candidates
    assert engs["t"].history[-1].n_deferred == 0


@pytest.mark.parametrize("fail", ["none", "moved", "new"])
def test_execute_moves_lands_through_the_plan(fail):
    """``execute_moves``: an all-False mask is the synchronous step; a
    failed move reverts to a deferred candidate and re-enters next batch;
    a failed ingestion put re-enters as new data."""
    engs = _engines(s_thresh=5.0, window=1, drift_threshold=np.inf)
    _step(engs, _hot_cold_batch())
    batch = _hot_cold_batch(hot=400.0, cold=500.0)
    if fail == "new":
        batch = batch + [(("d2/0",), 50.0)]

    def execute(m):
        if fail == "moved":
            return m.moved.copy()
        if fail == "new":
            return m.old_tier < 0
        return np.zeros(m.plan.problem.n, bool)

    mig = _step(engs, batch, execute_moves=execute)
    rep = engs["t"].history[-1]
    if fail == "moved":
        assert mig.n_moved == 0 and rep.n_failed == mig.n_candidates >= 1
        assert _step(engs, batch).n_moved == mig.n_candidates
    elif fail == "new":
        assert rep.n_failed == 0 and frozenset({"d2/0"}) not in \
            engs["t"]._held
        assert engs["t"].history[-1].n_new == 1
        _step(engs, batch)
        assert engs["t"].history[-1].n_new == 1
    else:
        assert rep.n_failed == 0 and mig.n_moved >= 1


def test_execute_moves_rejects_a_wrong_shape():
    engs = _engines(s_thresh=5.0)
    for e in engs.values():
        with pytest.raises(ValueError, match="execute_moves"):
            e.ingest_and_reoptimize(_hot_cold_batch(),
                                    execute_moves=lambda m: np.zeros(5, bool))


def test_stream_rho_abs_tol_stabilizes_cold_lock():
    def run(abs_tol):
        engs = _engines(s_thresh=5.0, window=1, drift_threshold=np.inf,
                        rho_abs_tol=abs_tol)
        _step(engs, _hot_cold_batch(cold=0.0))
        refs = []
        for eps in (1e-6, 3e-6, 2e-6):
            _step(engs, _hot_cold_batch(cold=eps))
            refs.append(engs["t"]._held[COLD][0].rho_ref)
        return refs

    assert run(0.5) == [0.0, 0.0, 0.0]
    assert all(r > 0.0 for r in run(0.0))


def test_project_rho_replaces_observed_rates():
    """The forecast hook: the solve and the lock bookkeeping see the
    projected rates, and a projection of the wrong shape is refused."""
    engs = _engines(s_thresh=5.0, window=1, drift_threshold=np.inf)
    _step(engs, _hot_cold_batch())
    proj = lambda parts, rho: np.where(
        [p.files == COLD for p in parts], 600.0, rho)
    mig = _step(engs, _hot_cold_batch(), project_rho=proj)
    i = [p.files for p in mig.plan.problem.partitions].index(COLD)
    assert mig.plan.problem.rho[i] == 600.0 and mig.moved[i]
    for e in engs.values():
        with pytest.raises(ValueError, match="project_rho"):
            e.ingest_and_reoptimize(_hot_cold_batch(),
                                    project_rho=lambda p, r: r[:1])


def test_enterprise_trace_matches_repro_and_syncs_the_store():
    """A month-by-month enterprise trace: identical steps, and each
    package's ``TieredStore`` mirrors its plan with the same meter."""
    ws = {"j": jwl.generate_workload(n_datasets=40, n_months=6, seed=5),
          "t": twl.generate_workload(n_datasets=40, n_months=6, seed=5)}
    wls = {"j": jwl, "t": twl}
    assert wls["t"].dataset_file_sizes(ws["t"]) \
        == wls["j"].dataset_file_sizes(ws["j"])
    engs = _engines(sizes=wls["t"].dataset_file_sizes(ws["t"]),
                    drift_threshold=0.5)
    stores = {"j": JStore(jcosts.azure_table()),
              "t": TStore(tcosts.azure_table())}
    logs = {k: list(wls[k].stream_query_log(ws[k], np.random.default_rng(1)))
            for k in wls}
    assert logs["t"] == logs["j"]
    migs = {}
    for batch in logs["t"]:
        if not batch:
            continue
        mig = _step(engs, batch, months=1.0)
        for k, e in engs.items():
            plan = e.plan
            payloads = [b"x" * max(int(p.span * 1e3), 1)
                        for p in plan.problem.partitions]
            stores[k].sync_plan(plan, payloads=payloads)
            stores[k].advance_months(1.0)
        keys = stores["t"].plan_keys(mig.plan)
        assert sorted(stores["t"].keys()) == sorted(keys)
        for n, key in enumerate(keys):
            assert stores["t"].tier_of(key) == int(
                mig.plan.assignment.tier[n])
        migs[len(migs)] = mig
    assert engs["t"].history[-1].n_partitions > 0
    assert stores["t"].meter.total_cents == pytest.approx(
        stores["j"].meter.total_cents, rel=1e-9)


# fixed decompression speeds (sec/GB), as the reference suite fixes them:
# the real `measure` times decompress calls, so the fit would follow the
# host's load; ratios stay real
_DET_DSPEED = {"zstd-3": 1.0, "zlib-1": 3.0, "zlib-6": 4.0}


@pytest.fixture(scope="module")
def compredict_stream():
    """The reference suite's small TPC-H stream with a fitted SVR
    predictor, and its twin for the port (same tables from the port's own
    generator, the predictor converted from the reference's arrays)."""
    from repro.core import compredict as jcp
    from repro.storage import codecs as jcodecs

    jdb = jtpch.generate(scale_rows=600, seed=9)
    jqs = jtpch.generate_queries(jdb, n_per_template=2, seed=10)
    parts, jrows = jtpch.partitions_from_queries(jdb, jqs)
    tdb = ttpch.generate(scale_rows=600, seed=9)
    tqs = ttpch.generate_queries(tdb, n_per_template=2, seed=10)
    _, trows = ttpch.partitions_from_queries(tdb, tqs)
    schemes = jcodecs.available_schemes(("none", "zstd-3", "zlib-6",
                                         "zlib-1"))
    real = jcp.measure

    def det_measure(codec, raw, repeats=1):
        m = real(codec, raw, repeats=repeats)
        return jcodecs.CodecMeasurement(
            ratio=m.ratio, compress_sec=0.0,
            decompress_sec_per_gb=_DET_DSPEED.get(codec.name, 0.0))

    jcp.measure = det_measure
    try:
        jpred = jcp.CompressionPredictor(model_name="SVR").fit(
            jcp.query_samples(jqs, jdb.tables, max_rows=250)[:30],
            layouts=("col",),
            codecs=[jcodecs.codec_by_name(s) for s in schemes
                    if s != "none"])
    finally:
        jcp.measure = real
    tpred = convert.predictor_from_arrays(predictor_arrays(jpred))
    sizes = {f: jrows[f][0].select(jrows[f][1]).nbytes("col") / 1e9
             for p in parts for f in p.files}
    tsizes = {f: trows[f][0].select(trows[f][1]).nbytes("col") / 1e9
              for f in sizes}
    assert tsizes == sizes
    batches = [[(tuple(sorted(p.files)), p.rho) for p in parts[:4]],
               [(tuple(sorted(p.files)), p.rho * (3.0 if i % 2 else 1.0))
                for i, p in enumerate(parts[:6])]]
    return {"j": (jpred, jrows), "t": (tpred, trows)}, sizes, schemes, \
        batches


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_compredict_stream_matches_repro(compredict_stream, backend):
    """Re-prediction through ``compredict_rd_fn``: the port's numpy
    features and its device features (the weighted-entropy kernel's plain
    version here) give the reference's plans, and compression engages."""
    preds, sizes, schemes, batches = compredict_stream
    rd = {"rd_fn_j": jeng.compredict_rd_fn(*preds["j"], layout="col",
                                           feature_backend="numpy"),
          "rd_fn_t": teng.compredict_rd_fn(*preds["t"], layout="col",
                                           feature_backend=backend,
                                           device="cpu")}
    engs = _engines(sizes=sizes, cfg_kw=dict(use_compression=True,
                                             schemes=schemes),
                    s_thresh=5.0, **rd)
    migs = [_step(engs, b, months=1.0,
                  held_rtol=1e-5 if backend == "device" else 1e-12)
            for b in batches]
    assert (migs[-1].plan.assignment.scheme > 0).any()
    np.testing.assert_allclose(migs[-1].plan.problem.R,
                               engs["j"].plan.problem.R, rtol=1e-5)


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_svr_ratio_beyond_its_samples_matches_repro(backend):
    """Partitions far larger than the SVR's training samples (here 200-row
    samples against partitions of mostly thousands of rows, as the 6,000-row
    samples stand to the TPC-H SF0.1 stream's partitions): the reference's
    and the port's predictors give the same ratios, and both give the
    ratio floor of 1 in every cell (the kernel ridge's prediction falls
    to 0 far from its samples, and ratios are clamped at 1)."""
    from repro.core import compredict as jcp
    from repro.storage import codecs as jcodecs

    jdb = jtpch.generate(scale_rows=20_000, seed=0)
    jqs = jtpch.generate_queries(jdb, n_per_template=2, seed=1,
                                 rows_per_file=500)
    parts, jrows = jtpch.partitions_from_queries(jdb, jqs, rows_per_file=500)
    tdb = ttpch.generate(scale_rows=20_000, seed=0)
    tqs = ttpch.generate_queries(tdb, n_per_template=2, seed=1,
                                 rows_per_file=500)
    _, trows = ttpch.partitions_from_queries(tdb, tqs, rows_per_file=500)
    real = jcp.measure

    def det_measure(codec, raw, repeats=1):
        m = real(codec, raw, repeats=repeats)
        return jcodecs.CodecMeasurement(
            ratio=m.ratio, compress_sec=0.0,
            decompress_sec_per_gb=_DET_DSPEED.get(codec.name, 2.0))

    schemes = ["none", "zlib-1", "lzma-1"]
    jcp.measure = det_measure
    try:
        jpred = jcp.CompressionPredictor(model_name="SVR").fit(
            jcp.query_samples(jqs, jdb.tables, max_rows=200)[:30],
            layouts=("col",),
            codecs=[jcodecs.codec_by_name(s) for s in schemes[1:]])
    finally:
        jcp.measure = real
    tpred = convert.predictor_from_arrays(predictor_arrays(jpred))
    jt = jeng.PartitionStage._partition_tables(parts, jrows)
    tt = teng.PartitionStage._partition_tables(parts, trows)
    assert np.median([t.num_rows for t in jt]) >= 10 * 200
    Rj, _ = jpred.predict_matrix(jt, schemes, "col")
    Rt, _ = tpred.predict_matrix(tt, schemes, "col", feature_backend=backend,
                                 device="cpu")
    np.testing.assert_allclose(Rt, Rj, rtol=1e-5)
    assert (Rj == 1.0).all() and (Rt == 1.0).all()
