"""The port's ``ChaosStore`` and ``AsyncMigrator`` against ``repro``'s.

Both packages solve one shared ``PlacementProblem`` over real payloads
(true compression ratios, a fixed decompression speed per codec: no
truth-mode solve, whose D is wall-clock time), drift it, and land the
migration through each package's own store, migrator and chaos wrapper:

* the fault schedule of one op sequence is identical for seeds 0-2;
* with zero faults and one worker, ``execute`` / ``execute_sync`` leave
  the port's store bit-identical to its own ``migrate`` / ``sync_plan``
  (state and the deterministic meter fields), and to ``repro``'s;
* under transient, corruption and permanent faults the task states,
  attempts, backoff delays (recorded through ``sleep_fn``), retry and
  failed cents and the meter are identical to ``repro``'s migrator;
* the budget cap holds over attempted spend, as in ``repro``;
* four workers land everything with equal cents (rel 1e-9).
"""

import hashlib

import numpy as np
import pytest
from _torch_parity import (PAYLOAD_RHO, PAYLOADS, SMALL_CYCLES,  # noqa: F401
                           STORE_FIELDS, meter_sig, one_torch_thread,
                           payload_drift, payload_plans, state_sig,
                           stream_engines, stream_payload)

from repro.core import migrator as jmig
from repro.storage import chaos as jchaos
from repro.storage import store as jstore
from repro_torch.core import costs as tcosts
from repro_torch.core import migrator as tmig
from repro_torch.storage import chaos as tchaos
from repro_torch.storage import store as tstore

PKGS = {"j": (jstore, jchaos, jmig), "t": (tstore, tchaos, tmig)}


@pytest.fixture(scope="module")
def drifted():
    """``{pkg: (engine, plan, migration)}`` on the shared problem."""
    plans = payload_plans(PAYLOADS, PAYLOAD_RHO, tier_whitelist=(0, 1, 2),
                          months=2.0)
    out = {k: (e, p, e.reoptimize(p, payload_drift(p.problem.rho),
                                  months_held=2.0))
           for k, (e, p) in plans.items()}
    a, b = out["t"][2], out["j"][2]
    for f in ("moved", "candidate", "new_tier", "new_scheme"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert a.n_moved >= 2 and (a.moved & (a.new_scheme != a.old_scheme)).any()
    return out


def _fresh(k, drifted, months=2.0):
    eng, plan, _ = drifted[k]
    s = PKGS[k][0].TieredStore(eng.table)
    keys = s.apply_plan(plan)
    s.advance_months(months)
    return s, keys


def _task_sig(rep):
    return [(t.index, t.key, t.kind, t.new_tier, t.codec, t.state.value,
             t.attempts, t.spent_cents, t.committed_cents, t.backoff_s,
             t.error) for t in rep.tasks]


def _report_sig(rep):
    return (rep.n_rows, rep.n_committed, rep.n_failed, rep.n_rolled_back,
            rep.n_skipped, rep.n_attempts, rep.committed_cents,
            rep.retry_cents, rep.failed_cents, rep.backoff_s)


# ------------------------------------------------------------- chaos store
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_schedule_matches_repro(seed):
    """One op sequence over every faultable op: the same outcome of each
    op, the same bytes back from ``get``, the same counters."""
    def run(k):
        st_mod, ch_mod, _ = PKGS[k]
        s = st_mod.TieredStore()
        for i in range(4):
            s.put(f"k{i}", bytes([i]) * 1000, tier=1)
        ch = ch_mod.ChaosStore(s, seed=seed, p_transient=0.25,
                               p_permanent=0.1, p_corrupt=0.3,
                               max_faults_per_op=3)
        log = []
        for i in range(60):
            key, op = f"k{i % 4}", ("get", "put", "replace", "change_tier",
                                    "delete")[i % 5]
            try:
                if op == "get":
                    out = hashlib.sha256(ch.get(key)).hexdigest()
                elif op == "put":
                    out = ch.put(key, bytes([i]) * 1000, tier=i % 3)
                elif op == "replace":
                    out = ch.replace(key, bytes([i]) * 900, i % 3, "zlib-1")
                elif op == "change_tier":
                    out = ch.change_tier(key, (i + 1) % 3)
                else:
                    out = ch.delete(key)
                    ch.inner.put(key, bytes([i]) * 1000, tier=0)
                log.append((op, "ok", out))
            except ch_mod.TransientStoreError as e:
                log.append((op, "transient", e.status))
            except ch_mod.PermanentStoreError:
                log.append((op, "permanent"))
        st = ch.stats
        return log, (st.n_ops, st.n_transient, st.n_permanent,
                     st.n_corrupt_get, st.n_corrupt_put), meter_sig(s)

    got, want = run("t"), run("j")
    assert got == want
    assert sum(got[1][1:]) > 0


def test_chaos_validates_ops_and_delegates_metadata():
    s = tstore.TieredStore(tcosts.azure_table())
    with pytest.raises(ValueError, match="unknown chaos ops"):
        tchaos.ChaosStore(s, ops=("get", "frobnicate"))
    ch = tchaos.ChaosStore(s, seed=0, p_transient=1.0, ops=("get",))
    ch.put("a", b"x" * 100, tier=0)
    assert ch.has("a") and ch.tier_of("a") == 0
    assert ch.meter is s.meter and ch.inner is s
    with pytest.raises(tchaos.TransientStoreError):
        ch.get("a")
    assert issubclass(tchaos.TransientStoreError, tstore.StoreError)


def test_max_faults_per_op_guarantees_eventual_success():
    s = tstore.TieredStore(tcosts.azure_table())
    s.put("a", b"x" * 1000, tier=0)
    ch = tchaos.ChaosStore(s, seed=0, p_transient=1.0, max_faults_per_op=3)
    outcomes = []
    for _ in range(5):
        try:
            ch.get("a")
            outcomes.append("ok")
        except tchaos.TransientStoreError:
            outcomes.append("t")
    assert outcomes == ["t", "t", "t", "ok", "ok"]


def test_corrupted_put_is_rejected_before_billing():
    s = tstore.TieredStore(tcosts.azure_table())
    ch = tchaos.ChaosStore(s, seed=0, p_corrupt=1.0, ops=("put",))
    raw = b"payload" * 100
    with pytest.raises(tstore.ChecksumError):
        ch.put("a", raw, tier=0,
               expect_checksum=hashlib.sha256(raw).hexdigest())
    assert not s.has("a") and s.meter.write_cents == 0.0


# --------------------------------------------------- zero-fault parity pins
def test_zero_fault_execute_is_bit_identical_to_migrate(drifted):
    mig = drifted["t"][2]
    s1, k1 = _fresh("t", drifted)
    s1.migrate(mig, k1)
    reps = {}
    for k in PKGS:
        s, keys = _fresh(k, drifted)
        reps[k] = (PKGS[k][2].AsyncMigrator(s, sleep_fn=None)
                   .execute(drifted[k][2], keys), s)
    rep, s2 = reps["t"]
    assert rep.n_committed == mig.n_moved and rep.n_failed == 0
    assert rep.n_attempts == mig.n_moved and rep.retry_cents == 0.0
    assert meter_sig(s1) == meter_sig(s2)
    assert state_sig(s1) == state_sig(s2)
    assert meter_sig(reps["j"][1]) == meter_sig(s2)
    assert state_sig(reps["j"][1]) == state_sig(s2)
    assert _task_sig(reps["j"][0]) == _task_sig(rep)


def test_zero_fault_execute_sync_is_bit_identical_to_sync_plan():
    engs, engs2 = stream_engines(), stream_engines()
    s1 = tstore.TieredStore(engs["t"].table)
    stores = {k: PKGS[k][0].TieredStore(e.table) for k, e in engs2.items()}
    migrs = {k: PKGS[k][2].AsyncMigrator(stores[k], sleep_fn=None)
             for k in PKGS}
    for batch in SMALL_CYCLES:
        mig1 = engs["t"].ingest_and_reoptimize(batch, months=1.0)
        s1.advance_months(1.0)
        parts = mig1.plan.problem.partitions
        s1.sync_plan(mig1.plan, payloads=[stream_payload(p) for p in parts])
        reps = {}
        for k, e in engs2.items():
            mig = e.ingest_and_reoptimize(batch, months=1.0)
            stores[k].advance_months(1.0)
            reps[k] = migrs[k].execute_sync(
                mig, [stream_payload(p) for p in mig.plan.problem.partitions])
        assert reps["t"].n_failed == 0 and reps["t"].retry_cents == 0.0
        assert _task_sig(reps["t"]) == _task_sig(reps["j"])
    assert meter_sig(s1) == meter_sig(stores["t"])
    assert state_sig(s1) == state_sig(stores["t"])
    assert meter_sig(stores["j"]) == meter_sig(stores["t"])
    assert state_sig(stores["j"]) == state_sig(stores["t"])


# -------------------------------------------------------- failure handling
FAULTS = {
    "transient": dict(p_transient=0.4, max_faults_per_op=2),
    "corrupt": dict(p_corrupt=0.6, max_faults_per_op=2,
                    ops=("get", "replace")),
    "transient_corrupt": dict(p_transient=0.4, p_corrupt=0.2,
                              max_faults_per_op=2),
    "permanent": dict(p_permanent=0.5),
    "exhausted": dict(p_transient=1.0),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_match_repro(drifted, fault, seed):
    """Task by task, the port's migrator takes the reference's path through
    the same fault schedule: states, attempts, backoff delays, retry and
    failed cents, and the store left behind."""
    runs = {}
    for k, (st_mod, ch_mod, mig_mod) in PKGS.items():
        s, keys = _fresh(k, drifted)
        ch = ch_mod.ChaosStore(s, seed=seed, **FAULTS[fault])
        delays = []
        rep = mig_mod.AsyncMigrator(
            ch, seed=seed + 40, max_attempts=4, base_delay_s=0.01,
            sleep_fn=delays.append).execute(drifted[k][2], keys)
        runs[k] = (rep, delays, s, ch.stats)
    (rt, dt, st, ct), (rj, dj, sj, cj) = runs["t"], runs["j"]
    assert _task_sig(rt) == _task_sig(rj)
    assert _report_sig(rt) == _report_sig(rj)
    assert dt == dj and sum(dt) == pytest.approx(rt.backoff_s)
    assert meter_sig(st) == meter_sig(sj)
    assert state_sig(st) == state_sig(sj)
    assert (ct.n_ops, ct.n_faults) == (cj.n_ops, cj.n_faults)
    assert ct.n_faults > 0
    for f in ("committed_mask", "failed_mask", "unapplied_mask"):
        np.testing.assert_array_equal(getattr(rt, f)(), getattr(rj, f)())
    assert rt.attempted_cents == pytest.approx(
        rt.committed_cents + rt.retry_cents + rt.failed_cents, abs=1e-15)
    if fault == "transient":
        # eventual success: the fault-free bill plus the metered retries
        ref, kr = _fresh("t", drifted)
        ref.migrate(drifted["t"][2], kr)
        assert rt.n_failed == 0
        assert tmig._meter_cents(st.meter) == pytest.approx(
            tmig._meter_cents(ref.meter) + rt.retry_cents, abs=1e-12)
    if fault == "exhausted":
        assert rt.n_committed == 0 and rt.attempted_cents == 0.0
        assert all(t.attempts == 4 for t in rt.tasks)


def test_permanent_failure_rolls_back_with_source_intact(drifted):
    s, keys = _fresh("t", drifted)
    before = state_sig(s)
    mig = drifted["t"][2]
    ch = tchaos.ChaosStore(s, seed=3, p_permanent=1.0)
    rep = tmig.AsyncMigrator(ch, sleep_fn=None).execute(mig, keys)
    assert rep.n_committed == 0 and rep.n_rolled_back == mig.n_moved
    assert all(t.state is tmig.MoveState.ROLLED_BACK and t.attempts == 1
               for t in rep.tasks)
    assert state_sig(s) == before
    landed = mig.land(rep.unapplied_mask())
    assert landed.n_moved == 0
    np.testing.assert_array_equal(landed.deferred, mig.moved)


@pytest.mark.parametrize("seed", [0, 1])
def test_budget_cap_holds_over_attempted_spend(drifted, seed):
    """A cap that fits about one move: the migrator stops launching (and
    retrying) before another full-cost attempt could overrun it; its
    report is the reference's."""
    mig = drifted["t"][2]
    charges = (mig.move_transfer_cents + mig.move_egress_cents
               + mig.move_penalty_cents)[mig.moved]
    cap = float(np.sort(charges)[0] * 1.5)
    reps = {}
    for k, (_, ch_mod, mig_mod) in PKGS.items():
        s, keys = _fresh(k, drifted)
        ch = ch_mod.ChaosStore(s, seed=seed, p_transient=0.5,
                               max_faults_per_op=1)
        reps[k] = mig_mod.AsyncMigrator(ch, sleep_fn=None, max_attempts=5) \
            .execute(drifted[k][2], keys, budget_cents=cap)
    rep = reps["t"]
    assert rep.attempted_cents <= cap + 1e-9
    assert rep.n_skipped > 0
    for t in rep.tasks:
        if t.state is tmig.MoveState.SKIPPED:
            assert t.attempts == 0 and t.spent_cents == 0.0
    assert rep.unapplied_mask().sum() == rep.n_failed + rep.n_skipped
    assert _task_sig(rep) == _task_sig(reps["j"])


def test_workers_land_everything_with_equal_cents(drifted):
    ref, kr = _fresh("t", drifted)
    ref.migrate(drifted["t"][2], kr)
    s, keys = _fresh("t", drifted)
    rep = tmig.AsyncMigrator(s, workers=4, sleep_fn=None).execute(
        drifted["t"][2], keys)
    assert rep.n_committed == drifted["t"][2].n_moved and rep.n_failed == 0
    for f in STORE_FIELDS:
        assert getattr(s.meter, f) == pytest.approx(getattr(ref.meter, f),
                                                    rel=1e-9)
    assert {k: v[:3] for k, v in state_sig(s).items()} == \
           {k: v[:3] for k, v in state_sig(ref).items()}


def test_migrator_validates_arguments_before_any_op(drifted):
    s, keys = _fresh("t", drifted)
    with pytest.raises(ValueError, match="max_attempts"):
        tmig.AsyncMigrator(s, max_attempts=0)
    with pytest.raises(ValueError, match="workers"):
        tmig.AsyncMigrator(s, workers=0)
    sig = meter_sig(s)
    with pytest.raises(ValueError, match="nothing executed"):
        tmig.AsyncMigrator(s, sleep_fn=None).execute(drifted["t"][2],
                                                     keys[:-1])
    assert meter_sig(s) == sig
    e = stream_engines()["t"]
    mig = e.ingest_and_reoptimize(SMALL_CYCLES[0], months=1.0)
    s2 = tstore.TieredStore(e.table)
    with pytest.raises(ValueError, match="nothing executed"):
        tmig.AsyncMigrator(s2, sleep_fn=None).execute_sync(mig, [b"x"])
    assert len(s2.keys()) == 0 and s2.meter.total_cents == 0.0
