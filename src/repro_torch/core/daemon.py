"""Continuous re-optimization daemon — budget-capped online migration.

The paper's optimizer is only as good as its online loop: access rates
drift, and the minimum-stay / tier-change machinery exists precisely so
re-optimization can run continuously without churning storage.
:class:`ReoptimizationDaemon` closes that loop. Each cycle it

1. observes new access rates (batch mode: an (N,) rho vector; streaming
   mode: a query-family batch folded in by the
   :class:`~repro_torch.core.engine.StreamingEngine`), optionally replaced
   by a **forecast** (``forecast_fn`` — e.g. a linear trend over the recent
   rho history, or an ``access_predict``-style fitted model),
2. solves the migration problem with the full hysteresis stack — the
   ``rho_rel_tol`` scheme lock plus the ``rho_abs_tol`` absolute floor
   (:func:`~repro_torch.core.engine.drift_gate`), early-delete penalties
   priced on per-partition residency clocks,
3. **selects** which candidate moves to execute under a per-cycle
   :class:`MigrationBudget` (cents and/or GB) via the savings-per-
   migration-cent knapsack
   (:func:`~repro_torch.core.optassign.budgeted_moves`).
   Unselected moves are deferred, tracked, and re-scored next cycle with
   a priority-aging boost so long-postponed moves eventually win; moves
   whose early-delete penalty still exceeds their projected steady-state
   savings are postponed outright (min-stay-aware deferral),
4. applies the partial :class:`~repro_torch.core.engine.MigrationPlan` —
   to the engine state, and to an attached
   :class:`~repro_torch.storage.store.TieredStore` (``migrate`` in batch
   mode, ``sync_plan`` in streaming mode) with exact metering.

With an infinite budget and ``rho_abs_tol=0`` every cycle is bit-identical
to a plain ``reoptimize`` / ``ingest_and_reoptimize`` call — the daemon
adds control, never drift (pinned by ``tests/test_torch_daemon.py``
against the plain chains). Budget selection only ever *postpones* spend:
deferral bookkeeping keeps charge-once semantics, so cumulative cost
converges to the unbudgeted trajectory (``chip_smoke.py`` phase daemon).

Port of ``repro.core.daemon``: the cycle loop and its bookkeeping are host
numpy, as in the reference; the device work is the engine's solves and
the budget knapsack's ranking, both on the engine's ``cfg.device``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.engine import (MigrationPlan, PlacementEngine,
                                     PlacementPlan, StreamingEngine,
                                     drift_gate)
from repro_torch.core.fleet import FleetEngine
# the shared forecasting sanity layer lives in core/forecast.py;
# re-exported here because linear_trend_forecast is the daemon's default
# forecast_fn building block (and the historical import location)
from repro_torch.core.forecast import (clamp_rho,  # noqa: F401
                                       linear_trend_forecast)
from repro_torch.core.optassign import budgeted_moves
from repro_torch.core.stream import occurrence_keys


@dataclasses.dataclass(frozen=True)
class MigrationBudget:
    """Per-cycle caps on one-off migration spend.

    ``cents_per_cycle`` bounds the cycle's transfer + egress + early-delete
    penalty cents; ``gb_per_cycle`` bounds the stored bytes leaving their
    current cell. ``np.inf`` (the default) disables a cap.
    """

    cents_per_cycle: float = np.inf
    gb_per_cycle: float = np.inf

    @property
    def finite(self) -> bool:
        return bool(np.isfinite(self.cents_per_cycle)
                    or np.isfinite(self.gb_per_cycle))


@dataclasses.dataclass
class DaemonCycleReport:
    """What one daemon cycle observed, selected, deferred, and paid.

    ``migration_cents`` here is the read-out + write-in transfer
    **excluding** egress (unlike ``MigrationPlan.migration_cents``, which
    folds egress in), so ``migration_cents + egress_cents + penalty_cents
    == spent_cents`` — the exact budget charge, guaranteed <= the cap.
    """

    cycle: int
    n_partitions: int
    n_candidates: int                 # moves the solver proposed
    n_selected: int                   # moves executed this cycle
    n_deferred: int                   # moves postponed by the budget
    migration_cents: float            # transfer (read+write), egress excluded
    egress_cents: float
    penalty_cents: float
    spent_cents: float                # migration + egress + penalty
    moved_gb: float                   # stored bytes that left their cell
    steady_cents: float               # steady-state bill of the cycle's plan
    max_deferral_age: int             # oldest pending deferral, in cycles
    n_tenants: int = 1                # > 1 only in fleet mode
    installment_cents: float = 0.0    # banked toward oversized moves this cycle
    prepaid_used_cents: float = 0.0   # prior installments consumed by landings
    # execution-plane outcome (populated when a migrator is attached):
    # moves that failed terminally this cycle are *reverted* in the plan
    # (MigrationPlan.land) and re-enter the candidate set next cycle —
    # spent_cents covers landed moves only, the failure cost is metered
    # separately so no move is ever double-billed
    sla_penalty: float = 0.0          # rho-weighted excess-ms of the
    # cycle's plan (PipelineReport.sla_penalty) — reported, never part of
    # spent_cents/steady_cents accounting as money
    n_failed: int = 0                 # selected moves that failed to land
    retry_cents: float = 0.0          # wasted attempts of landed moves
    failed_cents: float = 0.0         # cents burned by failed moves
    attempted_cents: float = 0.0      # spent + retry + failed — what the
    # per-cycle budget cap is enforced against (== spent_cents without a
    # migrator: the synchronous path lands everything it bills)


class ReoptimizationDaemon:
    """Drives ``reoptimize`` / ``ingest_and_reoptimize`` in a cycle loop
    with budget-capped, hysteresis-guarded migrations.

    Three modes, chosen by the engine handed in:

    * **batch** — ``ReoptimizationDaemon(placement_engine, plan=plan0)``;
      each :meth:`step` takes the cycle's observed (N,) rho vector. The
      daemon owns per-partition residency clocks (``months_held``) and
      deferral ages.
    * **streaming** — ``ReoptimizationDaemon(streaming_engine)``; each
      :meth:`step` takes a query-family batch. Hysteresis tolerances come
      from the streaming engine itself (``rho_rel_tol`` / ``rho_abs_tol``
      constructor args); deferral ages are keyed by partition file-set
      identity so they survive re-partitioning.
    * **fleet** — ``ReoptimizationDaemon(fleet_engine, plans=[...])``;
      each :meth:`step` takes a list of per-tenant rho vectors. All
      tenants' migration solves run in ONE batched assignment dispatch
      and the budget knapsack runs ONCE over the concatenated candidate
      moves — the per-cycle budget is shared fleet-wide. With an
      unbounded budget every tenant's trajectory is bit-identical to its
      own batch-mode daemon.

    ``amortize_oversized=True`` (batch mode) splits a move whose charge
    exceeds the whole per-cycle cents cap across cycles: leftover budget
    is banked into the best such move each cycle (report field
    ``installment_cents``) until its residual charge fits the cap and it
    lands (consuming ``prepaid_used_cents``). Without it such a move is
    deferred forever.

    ``budget=None`` (or an all-inf :class:`MigrationBudget`) reproduces the
    underlying engine's results bit-for-bit. ``store=`` mirrors every
    applied (partial) plan into a metered ``TieredStore``: batch mode calls
    ``store.migrate`` (the store must already hold the initial plan via
    ``apply_plan``; pass ``store_keys`` if you used custom keys), streaming
    mode calls ``store.sync_plan`` with payloads from ``payload_fn``.

    ``migrator=`` (batch/streaming; mutually exclusive with ``store=``)
    routes execution through an
    :class:`~repro_torch.core.migrator.AsyncMigrator` instead of the
    synchronous store calls: moves that fail terminally in a cycle are
    folded back via :meth:`MigrationPlan.land` — reverted in the
    daemon's state, re-planned next cycle as still-candidates — with their
    burned cents metered on the report (``retry_cents`` / ``failed_cents``
    / ``n_failed``), and the per-cycle cents cap is enforced by the
    migrator over *attempted* spend, so retries cannot blow the budget.
    Fleet mode takes ``migrators=`` (one per tenant, wrapping each
    tenant's own store); the shared budget decrements tenant-by-tenant by
    attempted cents. With zero faults the migrator path is bit-identical
    to ``store=``. ``amortize_oversized`` is incompatible with a migrator:
    its budget ledger reasons over residual charges, the execution plane
    over full per-move charges.
    """

    def __init__(self, engine: "PlacementEngine | StreamingEngine | FleetEngine",
                 plan: Optional[PlacementPlan] = None, *,
                 plans: Optional[Sequence[PlacementPlan]] = None,
                 budget: Optional[MigrationBudget] = None,
                 rho_rel_tol: Optional[float] = None,
                 rho_abs_tol: Optional[float] = None,
                 aging: float = 0.5,
                 horizon_months: Optional[float] = None,
                 min_stay_defer: bool = True,
                 selection: str = "auto",
                 amortize_oversized: bool = False,
                 forecast_fn: Optional[Callable] = None,
                 forecast_window: int = 6,
                 store=None, store_keys: Optional[list] = None,
                 payload_fn: Optional[Callable] = None,
                 migrator=None, migrators: Optional[Sequence] = None):
        self.streaming = isinstance(engine, StreamingEngine)
        self.fleet = isinstance(engine, FleetEngine)
        self.engine = engine
        self.budget = budget or MigrationBudget()
        self.aging = float(aging)
        self.horizon_months = horizon_months
        self.min_stay_defer = min_stay_defer
        self.selection = selection
        self.amortize_oversized = amortize_oversized
        self.forecast_fn = forecast_fn
        self.forecast_window = int(forecast_window)
        self.store = store
        self.store_keys = store_keys
        self.payload_fn = payload_fn
        self.migrator = migrator
        self.migrators = list(migrators) if migrators is not None else None
        self.history: List[DaemonCycleReport] = []
        if plans is not None and not self.fleet:
            raise ValueError("plans= is fleet mode — hand the daemon a "
                             "FleetEngine (single-tenant modes take plan=)")
        if isinstance(forecast_fn, (list, tuple)):
            if not self.fleet:
                raise ValueError("a forecast_fn sequence is fleet mode "
                                 "(one per tenant); single-tenant modes "
                                 "take a single callable")
            if plans is not None and len(forecast_fn) != len(plans):
                raise ValueError(f"forecast_fn= needs one callable per "
                                 f"tenant ({len(plans)}), got "
                                 f"{len(forecast_fn)}")
            self.forecast_fn = list(forecast_fn)
        if amortize_oversized and (self.streaming or self.fleet):
            raise ValueError("amortize_oversized is batch-mode only")
        if amortize_oversized and migrator is not None:
            raise ValueError("amortize_oversized is incompatible with a "
                             "migrator: the installment ledger budgets "
                             "residual charges, the execution plane full "
                             "per-move charges")
        if store is not None and migrator is not None:
            raise ValueError("pass either store= (synchronous mirroring) or "
                             "migrator= (resilient execution), not both — "
                             "the migrator wraps its own store")
        if migrators is not None and not self.fleet:
            raise ValueError("migrators= is fleet mode (one per tenant); "
                             "single-tenant modes take migrator=")
        if self.fleet:
            if plan is not None:
                raise ValueError("fleet mode takes plans= (one per tenant), "
                                 "not plan=")
            if plans is None:
                raise ValueError("fleet mode needs the initial per-tenant "
                                 "PlacementPlans (plans=)")
            if store is not None:
                raise ValueError("store mirroring is single-tenant; attach "
                                 "stores outside the fleet daemon")
            if migrator is not None:
                raise ValueError("fleet mode takes migrators= (one per "
                                 "tenant), not migrator=")
            if migrators is not None and len(migrators) != len(plans):
                raise ValueError(f"migrators= needs one migrator per tenant "
                                 f"({len(plans)}), got {len(migrators)}")
            if migrators is not None and store_keys is not None \
                    and len(store_keys) != len(plans):
                raise ValueError("fleet store_keys= must be a per-tenant "
                                 "list of key lists")
            self.plans: List[PlacementPlan] = list(plans)
            self.rho_rel_tol = 0.25 if rho_rel_tol is None else rho_rel_tol
            self.rho_abs_tol = 0.0 if rho_abs_tol is None else rho_abs_tol
            self._months_held_f = [np.zeros(p.problem.n) for p in self.plans]
            self._age_f = [np.zeros(p.problem.n, int) for p in self.plans]
            self._rho_ref_f = [np.asarray(p.problem.rho, np.float64).copy()
                               for p in self.plans]
            self._hist_f = [collections.deque(maxlen=self.forecast_window)
                            for _ in self.plans]
        elif self.streaming:
            if plan is not None:
                raise ValueError("streaming mode derives its plan from the "
                                 "engine; don't pass plan=")
            if rho_rel_tol is not None or rho_abs_tol is not None:
                raise ValueError("hysteresis lives on the StreamingEngine "
                                 "in streaming mode — pass rho_rel_tol/"
                                 "rho_abs_tol to its constructor instead")
            self._ages: Dict[Tuple, int] = {}
            self._rho_hist: Dict[Tuple, collections.deque] = {}
            # consecutive batches each tracked partition has been absent —
            # history is retired only after forecast_window misses, so
            # rolling-window churn doesn't reset calibration for
            # partitions that reappear a batch later
            self._rho_miss: Dict[Tuple, int] = {}
        else:
            if plan is None:
                raise ValueError("batch mode needs the initial "
                                 "PlacementPlan (plan=)")
            self.plan: Optional[PlacementPlan] = plan
            self.rho_rel_tol = 0.25 if rho_rel_tol is None else rho_rel_tol
            self.rho_abs_tol = 0.0 if rho_abs_tol is None else rho_abs_tol
            n = plan.problem.n
            self._months_held = np.zeros(n)
            self._age_arr = np.zeros(n, int)
            # drift-lock base: the rate each scheme was CHOSEN under — kept
            # for locked and deferred partitions (mirrors the streaming
            # engine) so slow drift accumulates and deferred moves stay in
            # the candidate set instead of re-basing away each cycle
            self._rho_ref = np.asarray(plan.problem.rho, np.float64).copy()
            self._batch_hist: collections.deque = collections.deque(
                maxlen=self.forecast_window)
            # amortized move-splitting ledger: cents already banked toward
            # each partition's (oversized) pending move
            self._paid = np.zeros(n)

    # ---------------------------------------------------------- selection
    def _terms(self, mig: MigrationPlan) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
        """(savings, charge, eligible) knapsack inputs for one plan's moves."""
        savings = mig.steady_savings_cents(self.horizon_months)
        charge = (mig.move_transfer_cents + mig.move_egress_cents
                  + mig.move_penalty_cents)
        eligible = mig.candidate.copy()
        if self.min_stay_defer:
            # postpone while the early-delete penalty still exceeds the
            # projected steady-state savings — the clock only helps: the
            # penalty prorates away while savings stay put
            eligible &= ~(mig.move_penalty_cents
                          > np.maximum(savings, 0.0) + 1e-12)
        return savings, charge, eligible

    def _choose(self, mig: MigrationPlan, ages: np.ndarray,
                paid: Optional[np.ndarray] = None) -> np.ndarray:
        """Budget knapsack over the candidate moves (all-True when the
        budget is unbounded — the parity fast path)."""
        cand = mig.candidate
        if not self.budget.finite or not cand.any():
            return np.ones(cand.shape[0], bool)
        savings, charge, eligible = self._terms(mig)
        return budgeted_moves(
            savings, charge, self.budget.cents_per_cycle,
            candidates=eligible, move_gb=mig.old_stored_gb,
            budget_gb=self.budget.gb_per_cycle,
            priority=1.0 + self.aging * np.maximum(ages, 0),
            method=self.selection, paid_cents=paid,
            device=self.engine.cfg.device)

    def _choose_fleet(self, migs: List[MigrationPlan]) -> List[np.ndarray]:
        """ONE knapsack over the concatenated candidate moves of every
        tenant — the per-cycle budget is shared fleet-wide, so a cent spent
        on tenant A's move is a cent unavailable to tenant B."""
        sizes = [m.candidate.shape[0] for m in migs]
        if not self.budget.finite or not any(
                m.candidate.any() for m in migs):
            return [np.ones(s, bool) for s in sizes]
        terms = [self._terms(m) for m in migs]
        keep = budgeted_moves(
            np.concatenate([t[0] for t in terms]) if sizes else np.zeros(0),
            np.concatenate([t[1] for t in terms]),
            self.budget.cents_per_cycle,
            candidates=np.concatenate([t[2] for t in terms]),
            move_gb=np.concatenate([m.old_stored_gb for m in migs]),
            budget_gb=self.budget.gb_per_cycle,
            priority=1.0 + self.aging * np.concatenate(
                [np.maximum(a, 0) for a in self._age_f]),
            method=self.selection, device=self.engine.cfg.device)
        out, off = [], 0
        for s in sizes:
            out.append(keep[off:off + s])
            off += s
        return out

    @staticmethod
    def _spent(mig: MigrationPlan) -> Tuple[float, float, float, float]:
        transfer = float(np.where(mig.moved, mig.move_transfer_cents,
                                  0.0).sum())
        egress = float(np.where(mig.moved, mig.move_egress_cents, 0.0).sum())
        penalty = float(np.where(mig.moved, mig.move_penalty_cents,
                                 0.0).sum())
        gb = float(np.where(mig.moved, mig.old_stored_gb, 0.0).sum())
        return transfer, egress, penalty, gb

    # ------------------------------------------------------------- cycles
    def step(self, observed, months: float = 1.0) -> DaemonCycleReport:
        """Run one cycle. ``observed`` is the (N,) rho vector (batch mode),
        the query-family batch (streaming mode), or a list of per-tenant
        rho vectors (fleet mode); ``months`` is the logical time elapsed
        since the previous cycle."""
        if self.fleet:
            return self._step_fleet(list(observed), months)
        if self.streaming:
            return self._step_stream(observed, months)
        return self._step_batch(np.asarray(observed, np.float64), months)

    def run(self, cycles: Iterable, months: float = 1.0,
            ) -> List[DaemonCycleReport]:
        """Drive :meth:`step` over an iterable of per-cycle observations
        (e.g. ``wl.stream_query_log(...)`` or a list of rho vectors)."""
        return [self.step(obs, months=months) for obs in cycles]

    # ---------------------------------------------------------- batch mode
    def _step_batch(self, rho_obs: np.ndarray, months: float,
                    ) -> DaemonCycleReport:
        self._batch_hist.append(rho_obs)
        rho = (np.asarray(self.forecast_fn(list(self._batch_hist)),
                          np.float64)
               if self.forecast_fn is not None else rho_obs)
        held = self._months_held + months
        full = self.engine.reoptimize(
            self.plan, rho, months_held=held,
            rho_rel_tol=self.rho_rel_tol, rho_abs_tol=self.rho_abs_tol,
            rho_ref=self._rho_ref)
        paid = self._paid if self.amortize_oversized else None
        keep = self._choose(full, self._age_arr, paid=paid)
        mig = full.select(keep)

        exec_rep = None
        if self.migrator is not None:
            # execute BEFORE the state updates: moves that fail to land
            # must revert (deferred-candidate status) so every clock, age
            # and lock base below sees the state actually reached
            self.migrator.store.advance_months(months)
            exec_rep = self.migrator.execute(
                mig, self.store_keys, budget_cents=self._cycle_cap())
            mig = mig.land(exec_rep.unapplied_mask())

        installment = prepaid_used = 0.0
        if self.amortize_oversized and self.budget.finite \
                and np.isfinite(self.budget.cents_per_cycle):
            _, charge, eligible = self._terms(full)
            residual = np.maximum(charge - self._paid, 0.0)
            # landed moves consume their banked credit; the budget charged
            # this cycle was only the residual (budgeted_moves weighed it)
            prepaid_used = float(np.minimum(
                self._paid, charge)[mig.moved].sum())
            self._paid[mig.moved] = 0.0
            # bank the cycle's leftover budget into the best oversized move
            # — one whose residual charge exceeds the whole per-cycle cap,
            # so it could never land outright
            spent = float(residual[mig.moved].sum())
            left = self.budget.cents_per_cycle - spent
            over = eligible & ~keep & (residual
                                       > self.budget.cents_per_cycle)
            if left > 1e-9 and over.any():
                savings = full.steady_savings_cents(self.horizon_months)
                rank = np.where(
                    over,
                    (1.0 + self.aging * np.maximum(self._age_arr, 0))
                    * np.maximum(savings, 1e-9) / np.maximum(residual, 1e-9),
                    -np.inf)
                n = int(rank.argmax())
                installment = float(min(left, residual[n]))
                self._paid[n] += installment

        self._months_held = np.where(mig.moved, 0.0, held)
        deferred = mig.deferred
        self._age_arr = np.where(deferred, self._age_arr + 1, 0)
        # keep the lock base for locked survivors (slow drift accumulates)
        # and for deferred moves (they must re-enter the candidate set);
        # re-base everything that moved or was re-decided while unlocked
        drifted = drift_gate(rho, self._rho_ref, self.rho_rel_tol,
                             self.rho_abs_tol)
        self._rho_ref = np.where(~mig.moved & (~drifted | deferred),
                                 self._rho_ref, rho)
        self.plan = mig.plan
        if self.store is not None:
            self.store.advance_months(months)
            self.store.migrate(mig, self.store_keys)
        return self._report(mig, deferred,
                            int(self._age_arr.max()) if deferred.any()
                            else 0, installment_cents=installment,
                            prepaid_used_cents=prepaid_used,
                            exec_rep=exec_rep)

    def _cycle_cap(self) -> Optional[float]:
        """The cents cap handed to the execution plane (None = uncapped)."""
        cap = self.budget.cents_per_cycle
        return float(cap) if np.isfinite(cap) else None

    # ------------------------------------------------------------ fleet mode
    def _step_fleet(self, rho_obs: List[np.ndarray], months: float,
                    ) -> DaemonCycleReport:
        """One fleet cycle: T migration solves in one batched assignment
        dispatch, then ONE shared-budget knapsack over every tenant's
        candidate moves. With an unbounded budget each tenant's trajectory
        is bit-identical to its own batch-mode daemon (the fleet parity
        contract)."""
        T = len(self.plans)
        if len(rho_obs) != T:
            raise ValueError(f"fleet step expects {T} rho vectors, "
                             f"got {len(rho_obs)}")
        rhos = []
        for t in range(T):
            obs = np.asarray(rho_obs[t], np.float64)
            self._hist_f[t].append(obs)
            fn = (self.forecast_fn[t]
                  if isinstance(self.forecast_fn, list)
                  else self.forecast_fn)
            rhos.append(np.asarray(fn(list(self._hist_f[t])), np.float64)
                        if fn is not None else obs)
        held = [mh + months for mh in self._months_held_f]
        migs, _ = self.engine.reoptimize(
            self.plans, rhos, months_held=held,
            rho_rel_tol=self.rho_rel_tol, rho_abs_tol=self.rho_abs_tol,
            rho_refs=self._rho_ref_f)
        keeps = self._choose_fleet(migs)
        migs = [m.select(k) for m, k in zip(migs, keeps)]

        exec_reps = []
        if self.migrators is not None:
            # sequential per-tenant execution against a SHARED attempted-
            # spend ledger: each tenant's cap is what the fleet has left
            remaining = self._cycle_cap()
            for t, mig in enumerate(migs):
                self.migrators[t].store.advance_months(months)
                keys_t = (self.store_keys[t]
                          if self.store_keys is not None else None)
                rep_t = self.migrators[t].execute(
                    mig, keys_t, budget_cents=remaining)
                exec_reps.append(rep_t)
                if remaining is not None:
                    remaining = max(0.0, remaining - rep_t.attempted_cents)
                migs[t] = mig.land(rep_t.unapplied_mask())

        max_age = 0
        for t, mig in enumerate(migs):
            self._months_held_f[t] = np.where(mig.moved, 0.0, held[t])
            deferred = mig.deferred
            self._age_f[t] = np.where(deferred, self._age_f[t] + 1, 0)
            drifted = drift_gate(rhos[t], self._rho_ref_f[t],
                                 self.rho_rel_tol, self.rho_abs_tol)
            self._rho_ref_f[t] = np.where(
                ~mig.moved & (~drifted | deferred),
                self._rho_ref_f[t], rhos[t])
            self.plans[t] = mig.plan
            if deferred.any():
                max_age = max(max_age, int(self._age_f[t].max()))

        spent = [self._spent(m) for m in migs]
        transfer = sum(s[0] for s in spent)
        egress = sum(s[1] for s in spent)
        penalty = sum(s[2] for s in spent)
        gb = sum(s[3] for s in spent)
        deferreds = [m.deferred for m in migs]
        spent_cents = transfer + egress + penalty
        rep = DaemonCycleReport(
            cycle=len(self.history),
            n_partitions=sum(m.plan.problem.n for m in migs),
            n_candidates=sum(m.n_candidates for m in migs),
            n_selected=sum(m.n_moved for m in migs),
            n_deferred=int(sum(d.sum() for d in deferreds)),
            migration_cents=transfer, egress_cents=egress,
            penalty_cents=penalty,
            spent_cents=spent_cents, moved_gb=gb,
            steady_cents=float(sum(m.plan.report.total_cents
                                   for m in migs)),
            sla_penalty=float(sum(m.plan.report.sla_penalty
                                  for m in migs)),
            max_deferral_age=max_age, n_tenants=T,
            n_failed=sum(r.n_failed for r in exec_reps),
            retry_cents=float(sum(r.retry_cents for r in exec_reps)),
            failed_cents=float(sum(r.failed_cents for r in exec_reps)),
            attempted_cents=(float(sum(r.attempted_cents
                                       for r in exec_reps))
                             if exec_reps else spent_cents))
        self.history.append(rep)
        return rep

    # ------------------------------------------------------ streaming mode
    def _project_stream(self, parts, rho_obs: np.ndarray) -> np.ndarray:
        keys = occurrence_keys(parts)
        out = rho_obs.astype(np.float64).copy()
        # context protocol: a forecast_fn carrying stream_context=True
        # (e.g. AccessForecaster.stream_forecast_fn) also receives the
        # partition's file-set key and stored span — the paper's
        # strongest feature — alongside the scalar rho history
        wants_ctx = bool(getattr(self.forecast_fn, "stream_context", False))
        for i, k in enumerate(keys):
            h = self._rho_hist.setdefault(
                k, collections.deque(maxlen=self.forecast_window))
            h.append(float(rho_obs[i]))
            self._rho_miss.pop(k, None)
            if wants_ctx:
                out[i] = float(self.forecast_fn(
                    list(h), key=k, span_gb=float(parts[i].span)))
            else:
                out[i] = float(self.forecast_fn(list(h)))
        # retire history only after forecast_window CONSECUTIVE absences:
        # a partition that drops out of one batch and reappears in the
        # next (rolling-window churn) keeps its calibration
        for absent in set(self._rho_hist) - set(keys):
            misses = self._rho_miss.get(absent, 0) + 1
            if misses >= self.forecast_window:
                del self._rho_hist[absent]
                self._rho_miss.pop(absent, None)
            else:
                self._rho_miss[absent] = misses
        return out

    def _step_stream(self, batch, months: float) -> DaemonCycleReport:
        captured: Dict[str, object] = {}

        def select(mig: MigrationPlan) -> np.ndarray:
            keys = occurrence_keys(mig.plan.problem.partitions)
            ages = np.array([self._ages.get(k, 0) for k in keys], int)
            captured["keys"] = keys
            return self._choose(mig, ages)

        def execute(mig: MigrationPlan) -> np.ndarray:
            # same store-op order as the synchronous path below:
            # advance the billing clock, then reconcile the plan
            self.migrator.store.advance_months(months)
            parts = mig.plan.problem.partitions or []
            payloads = ([self.payload_fn(p) for p in parts]
                        if self.payload_fn is not None else None)
            rep = self.migrator.execute_sync(
                mig, payloads, budget_cents=self._cycle_cap())
            captured["exec"] = rep
            return rep.unapplied_mask()

        mig = self.engine.ingest_and_reoptimize(
            batch, months=months,
            select_moves=select if self.budget.finite else None,
            project_rho=(self._project_stream
                         if self.forecast_fn is not None else None),
            execute_moves=execute if self.migrator is not None else None)
        if self.migrator is not None and "exec" not in captured:
            # empty step (N == 0): the hook never ran, but the billing
            # clock still advances — identical to the synchronous path
            self.migrator.store.advance_months(months)
        keys = captured.get(
            "keys", occurrence_keys(mig.plan.problem.partitions or []))
        deferred = mig.deferred
        self._ages = {k: self._ages.get(k, 0) + 1
                      for k, d in zip(keys, deferred) if d}
        if self.store is not None:
            self.store.advance_months(months)
            parts = mig.plan.problem.partitions or []
            payloads = ([self.payload_fn(p) for p in parts]
                        if self.payload_fn is not None else None)
            if parts:
                self.store.sync_plan(mig.plan, payloads=payloads)
        return self._report(mig, deferred,
                            max(self._ages.values(), default=0),
                            exec_rep=captured.get("exec"))

    # ------------------------------------------------------------- report
    def _report(self, mig: MigrationPlan, deferred: np.ndarray,
                max_age: int, installment_cents: float = 0.0,
                prepaid_used_cents: float = 0.0,
                exec_rep=None) -> DaemonCycleReport:
        transfer, egress, penalty, gb = self._spent(mig)
        spent = transfer + egress + penalty
        rep = DaemonCycleReport(
            cycle=len(self.history),
            n_partitions=mig.plan.problem.n,
            n_candidates=mig.n_candidates, n_selected=mig.n_moved,
            n_deferred=int(deferred.sum()),
            migration_cents=transfer, egress_cents=egress,
            penalty_cents=penalty,
            spent_cents=spent,
            moved_gb=gb, steady_cents=mig.plan.report.total_cents,
            sla_penalty=mig.plan.report.sla_penalty,
            max_deferral_age=max_age,
            installment_cents=installment_cents,
            prepaid_used_cents=prepaid_used_cents,
            n_failed=exec_rep.n_failed if exec_rep is not None else 0,
            retry_cents=(exec_rep.retry_cents
                         if exec_rep is not None else 0.0),
            failed_cents=(exec_rep.failed_cents
                          if exec_rep is not None else 0.0),
            attempted_cents=(exec_rep.attempted_cents
                             if exec_rep is not None else spent))
        self.history.append(rep)
        return rep
