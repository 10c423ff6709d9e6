"""Resilient asynchronous execution plane for ``MigrationPlan``s.

Port of ``repro.core.migrator``: host code, the same task queue, the same
op sequence and the same seeded backoff as the reference.

Planning and execution are split: the optimizer
(:meth:`~repro_torch.core.engine.PlacementEngine.reoptimize` + the daemon's
budget knapsack) *selects* moves; :class:`AsyncMigrator` *lands* them
against a :class:`~repro_torch.storage.store.TieredStore` as a per-move task
queue with

* **bounded retries** with exponential backoff + seeded jitter on
  transient faults (429/503, in-flight corruption),
* **per-move checksum verification** — the decoded payload is hashed and
  checked against the store's metadata before any delete/commit, and the
  bytes handed back for the re-put are re-verified inside the store's
  atomic :meth:`~repro_torch.storage.store.TieredStore.replace` commit,
* **atomic metadata commit** — a move is either fully billed-and-applied
  or fully rolled back; the source object is never left deleted without
  a committed destination,
* **budget gating over attempted spend** — with ``budget_cents`` set, a
  task (or retry) is only launched while the cycle's *attempted* cents
  (committed + wasted) still leave room for the move's planned charge,
  so retry storms cannot blow through a per-cycle migration cap.

Task lifecycle::

    pending -> in-flight -> committed                     (landed)
                         -> in-flight        (transient: backoff + retry)
                         -> rolled-back      (permanent error mid-move;
                                              partial work undone)
                         -> failed           (retries exhausted)
    pending -> skipped                       (budget gate: never launched)

With **zero injected faults and ``workers=1``** the task queue executes
the exact op sequence of the synchronous ``store.migrate`` /
``store.sync_plan`` paths — bit-identical store state and metered cents
(the parity pin in ``tests/test_torch_chaos_migrator.py``).
``workers > 1`` overlaps the backoff sleeps of independent tasks (store
operations themselves are serialized under an op lock so per-attempt
cents stay attributable);
float accumulation order then depends on scheduling, so parity is
approximate.

Accounting is over the **deterministic** meter fields (storage, read,
write, penalty, egress). Decompression-compute cents are wall-clock
measured by the store and excluded, so retry/failed cents are exactly
reproducible for a fixed chaos seed.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.storage.chaos import PermanentStoreError, TransientStoreError
from repro_torch.storage.store import ChecksumError, TieredStore

__all__ = ["AsyncMigrator", "MoveState", "MoveTask", "MigratorReport"]


class MoveState(str, enum.Enum):
    PENDING = "pending"
    IN_FLIGHT = "in-flight"
    COMMITTED = "committed"
    ROLLED_BACK = "rolled-back"       # permanent error; partial work undone
    FAILED = "failed"                 # retries exhausted
    SKIPPED = "skipped"               # budget gate: never launched


#: terminal states whose plan rows did NOT land (fed back to the planner)
_UNAPPLIED = (MoveState.ROLLED_BACK, MoveState.FAILED, MoveState.SKIPPED)
#: terminal states that count as execution *failures* (skips are deferrals)
_FAILED = (MoveState.ROLLED_BACK, MoveState.FAILED)


@dataclasses.dataclass
class MoveTask:
    """One queued store operation derived from a plan row."""

    index: int                        # plan row; -1 for sync-path deletes
    key: str
    kind: str                         # 'tier' | 'reencode' | 'put' | 'delete'
    new_tier: int = -1
    codec: str = "none"
    payload: Optional[bytes] = None   # raw bytes for 'put'
    charge_cents: float = 0.0         # planned one-off charge (budget gate)
    state: MoveState = MoveState.PENDING
    attempts: int = 0
    spent_cents: float = 0.0          # deterministic cents metered, total
    committed_cents: float = 0.0      # cents of the successful attempt
    backoff_s: float = 0.0            # total backoff delay scheduled
    error: str = ""

    @property
    def retry_cents(self) -> float:
        """Cents burned by attempts that did not commit."""
        return self.spent_cents - self.committed_cents


@dataclasses.dataclass
class MigratorReport:
    """Outcome of one :meth:`AsyncMigrator.execute`/``execute_sync`` run.

    ``committed_cents + retry_cents + failed_cents == attempted_cents`` —
    the exact (deterministic-field) meter delta of the run. ``n_rows`` is
    the plan length, so the masks align with ``MigrationPlan`` arrays.
    """

    tasks: List[MoveTask]
    n_rows: int
    n_committed: int
    n_failed: int                     # rolled-back + retries-exhausted
    n_rolled_back: int
    n_skipped: int                    # budget-gated, never launched
    n_attempts: int
    committed_cents: float            # cents of successful attempts
    retry_cents: float                # wasted attempts of committed tasks
    failed_cents: float               # all cents of failed tasks
    backoff_s: float

    @property
    def attempted_cents(self) -> float:
        return self.committed_cents + self.retry_cents + self.failed_cents

    def _mask(self, states) -> np.ndarray:
        m = np.zeros(self.n_rows, bool)
        for t in self.tasks:
            if t.index >= 0 and t.state in states:
                m[t.index] = True
        return m

    def committed_mask(self) -> np.ndarray:
        return self._mask((MoveState.COMMITTED,))

    def failed_mask(self) -> np.ndarray:
        """Plan rows that terminally failed (rolled back or exhausted)."""
        return self._mask(_FAILED)

    def unapplied_mask(self) -> np.ndarray:
        """Plan rows that did not land (failed OR budget-skipped) — what
        the planner reverts via ``MigrationPlan.land`` and re-plans next
        cycle."""
        return self._mask(_UNAPPLIED)


def _meter_cents(meter) -> float:
    """Deterministic billed cents (excludes wall-clock-measured
    decompression compute, which would make retry accounting
    irreproducible)."""
    return (meter.storage_cents + meter.read_cents + meter.write_cents
            + meter.penalty_cents + meter.egress_cents)


class _Budget:
    """Shared attempted-spend ledger for one execution run."""

    def __init__(self, cap: float):
        self.cap = float(cap)
        self.spent = 0.0

    def admits(self, charge: float) -> bool:
        # an attempt can cost at most the move's planned charge, so gating
        # on it keeps cumulative attempted spend under the cap
        return charge <= self.cap - self.spent + 1e-9


class AsyncMigrator:
    """Executes selected ``MigrationPlan`` moves as a resilient task queue.

    ``store`` is a :class:`TieredStore` or a
    :class:`~repro_torch.storage.chaos.ChaosStore` wrapping one. ``sleep_fn``
    performs the backoff delays (pass ``None`` to skip sleeping —
    delays are still computed and reported — the right setting for tests
    and simulation loops). ``seed`` drives the backoff jitter only; fault
    schedules live in the ChaosStore's own generator.
    """

    def __init__(self, store, *, max_attempts: int = 4,
                 base_delay_s: float = 0.05, backoff_mult: float = 2.0,
                 jitter: float = 0.5, seed: int = 0,
                 verify_checksums: bool = True, workers: int = 1,
                 sleep_fn: Optional[Callable[[float], None]] = time.sleep):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.store = store
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.backoff_mult = float(backoff_mult)
        self.jitter = float(jitter)
        self.verify_checksums = verify_checksums
        self.workers = int(workers)
        self.sleep_fn = sleep_fn
        self._rng = np.random.default_rng(seed)
        self._oplock = threading.Lock()

    # ------------------------------------------------------------ task build
    @staticmethod
    def _move_charges(migration) -> np.ndarray:
        return np.asarray(migration.move_transfer_cents
                          + migration.move_egress_cents
                          + migration.move_penalty_cents, np.float64)

    def execute(self, migration, keys: Optional[list] = None, *,
                budget_cents: Optional[float] = None) -> MigratorReport:
        """Land a (possibly partial) ``MigrationPlan`` — the resilient
        counterpart of :meth:`TieredStore.migrate`.

        Tier-only moves become ``change_tier`` tasks; scheme changes
        become verified-re-encode tasks (get -> checksum -> atomic
        ``replace``). Only ``migration.moved`` rows are queued, so
        budget-deferred candidates are untouched, exactly like the
        synchronous path.
        """
        moved = np.asarray(migration.moved, bool)
        N = int(moved.shape[0])
        if keys is not None and len(keys) != N:
            raise ValueError(f"keys has {len(keys)} entries for a "
                             f"{N}-partition migration; nothing executed")
        schemes = migration.plan.problem.schemes
        charges = self._move_charges(migration)
        tasks: List[MoveTask] = []
        for n in range(N):
            if not moved[n]:
                continue
            key = keys[n] if keys is not None else TieredStore._plan_key(n)
            if migration.new_scheme[n] != migration.old_scheme[n]:
                kind = "reencode"
                codec = schemes[int(migration.new_scheme[n])]
            else:
                kind, codec = "tier", "none"
            tasks.append(MoveTask(
                index=n, key=key, kind=kind,
                new_tier=int(migration.new_tier[n]), codec=codec,
                charge_cents=float(charges[n])))
        return self._run(tasks, N, budget_cents)

    def execute_sync(self, migration, payloads: Optional[list] = None, *,
                     budget_cents: Optional[float] = None) -> MigratorReport:
        """Reconcile the store with a streaming plan — the resilient
        counterpart of :meth:`TieredStore.sync_plan`.

        New partitions become verified ``put`` tasks, codec changes
        verified re-encodes, tier changes ``change_tier`` tasks, and
        vanished ``gpart-*`` objects ``delete`` tasks (``index = -1``:
        not plan rows; a failed delete simply lingers and is retried on
        the next sync). Ingestion puts and garbage deletes are outside
        the migration budget, matching the daemon's knapsack accounting;
        only the *move* tasks are budget-gated.
        """
        plan = migration.plan
        parts = plan.problem.partitions
        if parts is None:
            raise ValueError("plan has no partitions; execute_sync needs "
                             "the partition file sets to key objects")
        if payloads is None:
            payloads = plan.problem.raw_bytes
        if payloads is not None and len(payloads) != len(parts):
            raise ValueError(f"payloads has {len(payloads)} entries for "
                             f"{len(parts)} partitions; nothing executed")
        schemes = plan.problem.schemes
        charges = self._move_charges(migration)
        keys = self.store.plan_keys(plan)
        desired = set(keys)
        tasks: List[MoveTask] = []
        for n, key in enumerate(keys):
            tier = int(plan.assignment.tier[n])
            codec = schemes[int(plan.assignment.scheme[n])]
            if not self.store.has(key):
                if payloads is None:
                    raise ValueError("new partitions need payloads (pass "
                                     "payloads= or build with raw_bytes)")
                tasks.append(MoveTask(index=n, key=key, kind="put",
                                      new_tier=tier, codec=codec,
                                      payload=payloads[n]))
            elif self.store.codec_of(key) != codec:
                tasks.append(MoveTask(index=n, key=key, kind="reencode",
                                      new_tier=tier, codec=codec,
                                      charge_cents=float(charges[n])))
            elif self.store.tier_of(key) != tier:
                tasks.append(MoveTask(index=n, key=key, kind="tier",
                                      new_tier=tier, codec=codec,
                                      charge_cents=float(charges[n])))
        for key in self.store.keys():
            if key.startswith("gpart-") and key not in desired:
                tasks.append(MoveTask(index=-1, key=key, kind="delete"))
        return self._run(tasks, len(parts), budget_cents)

    # --------------------------------------------------------- execution
    def _attempt(self, task: MoveTask) -> None:
        """One attempt of a task's op sequence against the store. Any
        partial billing before a raised fault is the attempt's (wasted)
        retry cents; mutations are atomic per store op, so an aborted
        attempt leaves the source object intact."""
        st = self.store
        if task.kind == "tier":
            st.change_tier(task.key, task.new_tier)
        elif task.kind == "reencode":
            raw = st.get(task.key)
            h = None
            if self.verify_checksums:
                h = hashlib.sha256(raw).hexdigest()
                want = st.checksum(task.key)
                if h != want:
                    raise ChecksumError(
                        f"get {task.key!r}: decoded payload hash "
                        f"{h[:12]} != stored {want[:12]}")
            st.replace(task.key, raw, task.new_tier, task.codec,
                       expect_checksum=h)
        elif task.kind == "put":
            h = (hashlib.sha256(task.payload).hexdigest()
                 if self.verify_checksums else None)
            st.put(task.key, task.payload, task.new_tier, task.codec,
                   expect_checksum=h)
        elif task.kind == "delete":
            st.delete(task.key)
        else:  # pragma: no cover - task construction is internal
            raise ValueError(f"unknown task kind {task.kind!r}")

    def _run_task(self, task: MoveTask, budget: Optional[_Budget]) -> None:
        while True:
            delay = None
            with self._oplock:
                if task.state is MoveState.PENDING and budget is not None \
                        and not budget.admits(task.charge_cents):
                    task.state = MoveState.SKIPPED
                    task.error = "budget exhausted before launch"
                    return
                task.state = MoveState.IN_FLIGHT
                task.attempts += 1
                before = _meter_cents(self.store.meter)
                try:
                    self._attempt(task)
                except (TransientStoreError, ChecksumError) as e:
                    spent = _meter_cents(self.store.meter) - before
                    task.spent_cents += spent
                    if budget is not None:
                        budget.spent += spent
                    task.error = str(e)
                    if task.attempts >= self.max_attempts:
                        task.state = MoveState.FAILED
                        return
                    if budget is not None \
                            and not budget.admits(task.charge_cents):
                        # no room for another full-cost attempt: stop here
                        task.state = MoveState.FAILED
                        task.error += " (budget exhausted mid-retry)"
                        return
                    u = float(self._rng.random())
                    delay = (self.base_delay_s
                             * self.backoff_mult ** (task.attempts - 1)
                             * (1.0 + self.jitter * u))
                    task.backoff_s += delay
                except PermanentStoreError as e:
                    spent = _meter_cents(self.store.meter) - before
                    task.spent_cents += spent
                    if budget is not None:
                        budget.spent += spent
                    task.error = str(e)
                    task.state = MoveState.ROLLED_BACK
                    return
                else:
                    spent = _meter_cents(self.store.meter) - before
                    task.spent_cents += spent
                    task.committed_cents = spent
                    if budget is not None:
                        budget.spent += spent
                    task.state = MoveState.COMMITTED
                    return
            if delay is not None and self.sleep_fn is not None:
                self.sleep_fn(delay)

    def _run(self, tasks: List[MoveTask], n_rows: int,
             budget_cents: Optional[float]) -> MigratorReport:
        budget = (_Budget(budget_cents)
                  if budget_cents is not None and np.isfinite(budget_cents)
                  else None)
        if self.workers == 1 or len(tasks) <= 1:
            for t in tasks:
                self._run_task(t, budget)
        else:
            q: "queue.SimpleQueue[MoveTask]" = queue.SimpleQueue()
            for t in tasks:
                q.put(t)

            def worker():
                while True:
                    try:
                        t = q.get_nowait()
                    except queue.Empty:
                        return
                    self._run_task(t, budget)

            threads = [threading.Thread(target=worker, daemon=True)
                       for _ in range(min(self.workers, len(tasks)))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        committed = [t for t in tasks if t.state is MoveState.COMMITTED]
        failed = [t for t in tasks if t.state in _FAILED]
        return MigratorReport(
            tasks=tasks, n_rows=n_rows,
            n_committed=len(committed), n_failed=len(failed),
            n_rolled_back=sum(t.state is MoveState.ROLLED_BACK
                              for t in tasks),
            n_skipped=sum(t.state is MoveState.SKIPPED for t in tasks),
            n_attempts=sum(t.attempts for t in tasks),
            committed_cents=float(sum(t.committed_cents for t in committed)),
            retry_cents=float(sum(t.retry_cents for t in committed)),
            failed_cents=float(sum(t.spent_cents for t in failed)),
            backoff_s=float(sum(t.backoff_s for t in tasks)))
