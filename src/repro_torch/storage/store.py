"""Tiered cloud object store simulation with exact paper billing semantics.

A copy of ``repro.storage.store`` (the port imports nothing of ``repro``).

Objects live in one of L tiers; every put/get/tier-change is metered with the
:class:`~repro_torch.core.costs.CostTable` parameters (storage-month accrual, read
and write cents/GB, early-deletion penalties, TTFB latency simulation).

This is the storage substrate under the checkpoint manager and the training
data loader; it is also what the SCOPe pipeline optimizes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Dict, Iterable, Optional

import numpy as np

from repro_torch.core.costs import CostTable, azure_table, move_egress_cents_gb
from repro_torch.storage.codecs import codec_by_name


class StoreError(Exception):
    """Base class for store-level failures the execution plane can handle."""


class ChecksumError(StoreError):
    """A payload's hash did not match its expected checksum — the bytes
    were corrupted in flight. Retryable: nothing was billed or mutated."""


@dataclasses.dataclass
class BillingMeter:
    """Accrues cents, mirrors the paper's cost break-up columns.

    Contract: every ``*_cents`` field is real money metered by store
    operations. Serving-SLA latency penalties are **never** cents — they
    live only in ``PipelineReport.sla_penalty`` (raw rho-weighted
    excess-ms) and in the solver objective as ``sla_lambda * penalty``;
    nothing in this meter ever accrues them (pinned by
    ``tests/test_billing_parity.py``)."""

    storage_cents: float = 0.0
    read_cents: float = 0.0
    write_cents: float = 0.0
    compute_cents: float = 0.0      # decompression compute
    penalty_cents: float = 0.0      # early-deletion charges
    egress_cents: float = 0.0       # cross-provider transfer (multi-cloud)
    ttfb_seconds: float = 0.0       # accumulated simulated read latency
    decomp_seconds: float = 0.0
    n_reads: int = 0
    n_writes: int = 0

    @property
    def total_cents(self) -> float:
        return (self.storage_cents + self.read_cents + self.write_cents
                + self.compute_cents + self.penalty_cents + self.egress_cents)

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self) | {"total_cents": self.total_cents}


@dataclasses.dataclass
class _Obj:
    payload: bytes
    raw_gb: float
    stored_gb: float
    tier: int
    codec: str
    created_month: float
    moved_month: float
    checksum: str = ""                # lazy sha256 of the DECODED payload


class TieredStore:
    """In-memory multi-tier object store with cost metering.

    Time is *logical months* advanced by :meth:`advance_months` — storage cost
    accrues per object-month, exactly like a cloud bill at the end of a
    billing period (paper §III).
    """

    def __init__(self, table: Optional[CostTable] = None,
                 simulate_latency: bool = False):
        self.table = table or azure_table()
        self.meter = BillingMeter()
        self.simulate_latency = simulate_latency
        self._objs: Dict[str, _Obj] = {}
        self._month = 0.0
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ time
    @property
    def month(self) -> float:
        return self._month

    def advance_months(self, months: float) -> None:
        """Advance logical time, accruing storage cost for everything held."""
        with self._lock:
            for o in self._objs.values():
                self.meter.storage_cents += (
                    o.stored_gb * self.table.storage_cents_gb_month[o.tier] * months)
            self._month += months

    # ------------------------------------------------------------------- ops
    def put(self, key: str, raw: bytes, tier: int, codec: str = "none",
            expect_checksum: Optional[str] = None) -> int:
        """Store ``raw`` at ``tier`` under ``codec``, metering the write.

        ``expect_checksum`` (a sha256 hexdigest of ``raw``) lets a caller
        verify the bytes arrived intact: on mismatch a :class:`ChecksumError`
        is raised *before* anything is billed or mutated — the retry path
        of the async migrator.
        """
        c = codec_by_name(codec)
        if expect_checksum is not None:
            got = hashlib.sha256(raw).hexdigest()
            if got != expect_checksum:
                raise ChecksumError(
                    f"put {key!r}: payload checksum {got[:12]} != expected "
                    f"{expect_checksum[:12]} (corrupted in flight)")
        payload = c.compress(raw)
        raw_gb = len(raw) / 1e9
        stored_gb = len(payload) / 1e9
        with self._lock:
            self.meter.write_cents += stored_gb * self.table.write_cents_gb[tier]
            self.meter.n_writes += 1
            self._objs[key] = _Obj(payload, raw_gb, stored_gb, tier, codec,
                                   self._month, self._month)
        return len(payload)

    def get(self, key: str) -> bytes:
        o = self._objs[key]
        with self._lock:
            self.meter.read_cents += o.stored_gb * self.table.read_cents_gb[o.tier]
            self.meter.ttfb_seconds += float(self.table.ttfb_seconds[o.tier])
            self.meter.n_reads += 1
        if self.simulate_latency:
            time.sleep(min(float(self.table.ttfb_seconds[o.tier]), 0.05))
        t0 = time.perf_counter()
        raw = codec_by_name(o.codec).decompress(o.payload)
        dt = time.perf_counter() - t0
        with self._lock:
            self.meter.decomp_seconds += dt
            self.meter.compute_cents += dt * self.table.compute_cents_sec
        return raw

    def checksum(self, key: str) -> str:
        """sha256 hexdigest of the object's DECODED payload (what :meth:`get`
        returns when nothing corrupts it). Computed lazily from the stored
        payload and cached; a metadata operation — nothing is billed. The
        async migrator compares this against the hash of a fetched payload
        to detect in-flight read corruption before committing a move."""
        o = self._objs[key]
        if not o.checksum:
            dec = codec_by_name(o.codec).decompress(o.payload)
            o.checksum = hashlib.sha256(dec).hexdigest()
        return o.checksum

    def has(self, key: str) -> bool:
        return key in self._objs

    def codec_of(self, key: str) -> str:
        return self._objs[key].codec

    def _egress_cents_gb(self, old_tier: int, new_tier: int) -> float:
        """Per-GB cross-provider egress for a move; 0 on single-cloud tables."""
        return float(move_egress_cents_gb(self.table, old_tier, new_tier))

    def _early_delete_cents(self, o: _Obj) -> float:
        """Prorated remainder of the minimum-stay storage charge (0 once the
        stay elapsed). Call with the lock held."""
        held = self._month - o.moved_month
        min_stay = float(self.table.early_delete_months[o.tier])
        if held < min_stay:
            return (o.stored_gb * self.table.storage_cents_gb_month[o.tier]
                    * (min_stay - held))
        return 0.0

    def change_tier(self, key: str, new_tier: int) -> None:
        """Tier change = read from old + write to new (+ early-delete penalty;
        + the source provider's egress when the flat tiers of a multi-cloud
        table belong to different providers)."""
        o = self._objs[key]
        if new_tier == o.tier:
            return
        with self._lock:
            self.meter.penalty_cents += self._early_delete_cents(o)
            self.meter.read_cents += o.stored_gb * self.table.read_cents_gb[o.tier]
            self.meter.write_cents += o.stored_gb * self.table.write_cents_gb[new_tier]
            self.meter.egress_cents += (
                o.stored_gb * self._egress_cents_gb(o.tier, new_tier))
            o.tier = new_tier
            o.moved_month = self._month

    def replace(self, key: str, raw: bytes, new_tier: int,
                codec: str = "none",
                expect_checksum: Optional[str] = None) -> int:
        """Atomic delete + put: re-encode/re-tier an existing object in ONE
        commit under the lock.

        The delete-side early-deletion penalty, the write-in of the new
        payload, and the source provider's egress (old stored bytes crossing
        the provider boundary exactly once) are billed together with the
        object swap — or, when compression or checksum validation fails, not
        at all. A failed or interrupted re-encode therefore never leaves the
        source deleted with its penalty charged and nothing re-put: the
        store-side half of the async migrator's rollback contract.

        ``expect_checksum`` (sha256 of ``raw``) is verified before any
        billing, mirroring :meth:`put`.
        """
        c = codec_by_name(codec)
        if expect_checksum is not None:
            got = hashlib.sha256(raw).hexdigest()
            if got != expect_checksum:
                raise ChecksumError(
                    f"replace {key!r}: payload checksum {got[:12]} != "
                    f"expected {expect_checksum[:12]} (corrupted in flight)")
        payload = c.compress(raw)      # may raise -> nothing billed/mutated
        raw_gb = len(raw) / 1e9
        stored_gb = len(payload) / 1e9
        with self._lock:
            o = self._objs[key]
            self.meter.penalty_cents += self._early_delete_cents(o)
            self.meter.write_cents += (
                stored_gb * self.table.write_cents_gb[new_tier])
            self.meter.n_writes += 1
            self.meter.egress_cents += (
                o.stored_gb * self._egress_cents_gb(o.tier, new_tier))
            self._objs[key] = _Obj(payload, raw_gb, stored_gb, new_tier,
                                   codec, self._month, self._month)
        return len(payload)

    def delete(self, key: str) -> None:
        with self._lock:
            o = self._objs.pop(key)
            self.meter.penalty_cents += self._early_delete_cents(o)

    # ------------------------------------------------------------ plan wiring
    @staticmethod
    def _plan_key(n: int) -> str:
        return f"part-{n:06d}"

    def apply_plan(self, plan, keys: Optional[list] = None) -> list:
        """Materialize a ``PlacementPlan`` into the store.

        Puts every partition's raw bytes at its assigned tier with its
        assigned codec; returns the object keys (``part-NNNNNN`` unless
        ``keys`` is given). Write costs are metered exactly like any put.
        """
        raws = plan.problem.raw_bytes
        if raws is None:
            raise ValueError("plan has no raw_bytes; build it with a "
                             "PartitionStage-backed problem")
        if keys is not None and len(keys) != len(raws):
            # validate BEFORE the loop: a short keys list would raise an
            # IndexError mid-way with some puts already billed
            raise ValueError(f"keys has {len(keys)} entries for "
                             f"{len(raws)} partitions; nothing applied")
        schemes = plan.problem.schemes
        out = []
        for n, raw in enumerate(raws):
            key = keys[n] if keys is not None else self._plan_key(n)
            self.put(key, raw, int(plan.assignment.tier[n]),
                     schemes[int(plan.assignment.scheme[n])])
            out.append(key)
        return out

    def migrate(self, migration, keys: Optional[list] = None) -> int:
        """Apply a ``MigrationPlan`` produced by ``PlacementEngine.reoptimize``.

        Tier-only moves go through :meth:`change_tier` (read-out + write-in +
        early-deletion penalty). Scheme changes re-encode: get (read +
        decompression compute), delete (penalty), put (write). Returns the
        number of objects moved.

        Partial plans (``MigrationPlan.select``) work unchanged: only the
        *selected* moves appear in ``migration.moved``, so deferred
        candidates are left untouched and the metered cents equal the
        partial plan's ``migration_cents + penalty_cents`` exactly.

        Shapes and key existence are validated up front — a ``keys`` list
        shorter than ``migration.moved`` (or pointing at absent objects)
        raises :class:`ValueError` *before* any move is billed, so a bad
        call can never leave the meter half-charged.
        """
        n_total = len(migration.moved)
        if keys is not None and len(keys) != n_total:
            raise ValueError(f"keys has {len(keys)} entries for a "
                             f"{n_total}-partition migration; "
                             f"nothing migrated")
        schemes = migration.plan.problem.schemes
        moved_idx = [int(n) for n in range(n_total) if migration.moved[n]]
        moved_keys = [keys[n] if keys is not None else self._plan_key(n)
                      for n in moved_idx]
        missing = [k for k in moved_keys if k not in self._objs]
        if missing:
            raise ValueError(f"unknown object keys {missing[:4]} "
                             f"({len(missing)} of {len(moved_keys)} moves); "
                             f"nothing migrated")
        for n, key in zip(moved_idx, moved_keys):
            if migration.new_scheme[n] != migration.old_scheme[n]:
                # read + atomic delete/put/egress commit (see replace):
                # the source can never end up deleted without a committed
                # destination, and egress is charged exactly once on the
                # old payload crossing the provider boundary
                raw = self.get(key)
                self.replace(key, raw, int(migration.new_tier[n]),
                             schemes[int(migration.new_scheme[n])])
            else:
                self.change_tier(key, int(migration.new_tier[n]))
        return len(moved_idx)

    # -------------------------------------------------------- streaming sync
    @staticmethod
    def partition_key(files: Iterable[str]) -> str:
        """Stable object key for a partition, derived from its file set —
        the identity the streaming engine carries across re-partitionings.
        Distinct from ``apply_plan``'s positional ``part-NNNNNN`` keys."""
        h = hashlib.sha1("\x00".join(sorted(files)).encode()).hexdigest()[:16]
        return f"gpart-{h}"

    @classmethod
    def plan_keys(cls, plan) -> list:
        """Object key per plan partition — the string form of
        ``stream.occurrence_keys``: duplicated file sets (a family can
        coexist with a merge producing the same union) get an
        occurrence-index suffix in plan order."""
        from repro_torch.core.stream import occurrence_keys
        return [cls.partition_key(files) + ("" if c == 0 else f"#{c}")
                for files, c in occurrence_keys(plan.problem.partitions)]

    def sync_plan(self, plan, payloads: Optional[list] = None) -> Dict[str, int]:
        """Reconcile store contents with a (streaming) ``PlacementPlan``.

        Partitions are keyed by :meth:`partition_key`, so this composes with
        ``StreamingEngine``: partitions new to the store are put at their
        assigned tier/codec, survivors are tier-changed or re-encoded as the
        plan demands, and ``gpart-*`` objects whose file set no longer exists
        (merged away by a fold/compaction, or expired from the rolling
        window) are deleted — every step metered exactly like the manual
        ops. Returns op counts ``{"put", "moved", "reencoded", "deleted"}``.
        """
        parts = plan.problem.partitions
        if parts is None:
            raise ValueError("plan has no partitions; sync_plan needs the "
                             "partition file sets to key objects")
        if payloads is None:
            payloads = plan.problem.raw_bytes
        if payloads is not None and len(payloads) != len(parts):
            # validate BEFORE the loop: a misaligned payloads list would
            # raise an IndexError with earlier ops already billed
            raise ValueError(f"payloads has {len(payloads)} entries for "
                             f"{len(parts)} partitions; nothing synced")
        schemes = plan.problem.schemes
        stats = {"put": 0, "moved": 0, "reencoded": 0, "deleted": 0}
        keys = self.plan_keys(plan)
        desired = set(keys)
        for n, (p, key) in enumerate(zip(parts, keys)):
            tier = int(plan.assignment.tier[n])
            codec = schemes[int(plan.assignment.scheme[n])]
            o = self._objs.get(key)
            if o is None:
                if payloads is None:
                    raise ValueError("new partitions need payloads (pass "
                                     "payloads= or build with raw_bytes)")
                self.put(key, payloads[n], tier, codec)
                stats["put"] += 1
            elif o.codec != codec:
                raw = self.get(key)
                self.replace(key, raw, tier, codec)
                stats["reencoded"] += 1
            elif o.tier != tier:
                self.change_tier(key, tier)
                stats["moved"] += 1
        for key in [k for k in self._objs
                    if k.startswith("gpart-") and k not in desired]:
            self.delete(key)
            stats["deleted"] += 1
        return stats

    # ----------------------------------------------------------------- intro
    def tier_of(self, key: str) -> int:
        return self._objs[key].tier

    def months_held(self, keys: Iterable[str]) -> np.ndarray:
        """Per-object months since the last placement/move — the residency
        clocks ``PlacementEngine.reoptimize(months_held=...)`` expects, so a
        daemon driving a live store can price early-delete penalties from
        the store's own ground truth instead of a shadow clock."""
        return np.array([self._month - self._objs[k].moved_month
                         for k in keys], np.float64)

    def stored_gb(self, key: str) -> float:
        return self._objs[key].stored_gb

    def keys(self):
        return list(self._objs)

    def tier_usage_gb(self) -> Dict[int, float]:
        usage: Dict[int, float] = {t: 0.0 for t in range(self.table.num_tiers)}
        for o in self._objs.values():
            usage[o.tier] += o.stored_gb
        return usage
