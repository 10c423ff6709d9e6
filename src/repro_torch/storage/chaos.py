"""Seeded fault injection for the storage execution plane.

A copy of ``repro.storage.chaos`` (the port imports nothing of ``repro``):
the same seed and the same op sequence give the same fault schedule.

:class:`ChaosStore` wraps a :class:`~repro_torch.storage.store.TieredStore` and
injects failures into the data-path operations the async migrator drives
(``get`` / ``put`` / ``replace`` / ``change_tier`` / ``delete``):

* **transient** errors (429/503-style, :class:`TransientStoreError`) —
  raised *before* the inner op runs, so nothing is billed; the caller
  retries with backoff,
* **permanent** errors (:class:`PermanentStoreError`) — the caller must
  give up on the move and roll back,
* **payload corruption** — bytes returned by ``get`` (or handed to
  ``put``/``replace``) are flipped; caught by the migrator's checksum
  verification (or by the store's ``expect_checksum`` validation) before
  any commit.

Everything is driven by one seeded ``np.random.Generator``, so a given
``(seed, op sequence)`` produces exactly the same fault schedule — every
retry and rollback path is deterministically testable (the tests sweep
seeds). ``max_faults_per_op`` caps the injected faults per ``(op, key)``
pair, guaranteeing *eventual success* for retried operations when only
transient/corruption faults are enabled.

All other attributes (``meter``, ``advance_months``, ``checksum``,
``plan_keys``, ...) delegate to the inner store untouched — metadata and
billing are never faulted, only the data path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.storage.store import StoreError, TieredStore


class TransientStoreError(StoreError):
    """A retryable 429/503-style failure: the request never reached the
    store, so nothing was billed or mutated."""

    def __init__(self, message: str, status: int = 503):
        super().__init__(message)
        self.status = status


class PermanentStoreError(StoreError):
    """A non-retryable failure (permission revoked, object lost, bucket
    gone): the caller must abandon the move and roll back."""


@dataclasses.dataclass
class ChaosStats:
    """Injected-fault counters, for assertions and benchmark reporting."""

    n_ops: int = 0                    # data-path operations intercepted
    n_transient: int = 0
    n_permanent: int = 0
    n_corrupt_get: int = 0
    n_corrupt_put: int = 0

    @property
    def n_faults(self) -> int:
        return (self.n_transient + self.n_permanent
                + self.n_corrupt_get + self.n_corrupt_put)


def _flip(raw: bytes) -> bytes:
    """Corrupt a payload by flipping its first byte (checksum-detectable)."""
    if not raw:
        return raw
    return bytes([raw[0] ^ 0xFF]) + raw[1:]


class ChaosStore:
    """Fault-injection wrapper around a :class:`TieredStore`.

    ``p_transient`` / ``p_permanent`` / ``p_corrupt`` are per-operation
    probabilities (independent draws from the seeded generator; error
    draws happen before the op, the corruption draw applies to the bytes
    crossing the boundary). ``ops`` restricts which operations are
    faulted; ``max_faults_per_op`` bounds the injected faults per
    ``(op, key)`` so a bounded-retry caller is guaranteed to succeed
    eventually when permanent faults are disabled.
    """

    _DATA_OPS = ("get", "put", "replace", "change_tier", "delete")

    def __init__(self, inner: TieredStore, *, seed: int = 0,
                 p_transient: float = 0.0, p_permanent: float = 0.0,
                 p_corrupt: float = 0.0,
                 max_faults_per_op: Optional[int] = None,
                 ops: Sequence[str] = _DATA_OPS):
        unknown = set(ops) - set(self._DATA_OPS)
        if unknown:
            raise ValueError(f"unknown chaos ops {sorted(unknown)}; "
                             f"faultable ops are {self._DATA_OPS}")
        self._inner = inner
        self._rng = np.random.default_rng(seed)
        self.p_transient = float(p_transient)
        self.p_permanent = float(p_permanent)
        self.p_corrupt = float(p_corrupt)
        self.max_faults_per_op = max_faults_per_op
        self.ops = tuple(ops)
        self.stats = ChaosStats()
        self._fault_counts: Dict[Tuple[str, str], int] = {}

    # ------------------------------------------------------------ delegation
    def __getattr__(self, name):
        # metadata, billing, and plan wiring pass through unfaulted
        return getattr(self._inner, name)

    @property
    def inner(self) -> TieredStore:
        return self._inner

    # ------------------------------------------------------------- injection
    def _exhausted(self, op: str, key: str) -> bool:
        if self.max_faults_per_op is None:
            return False
        return self._fault_counts.get((op, key), 0) >= self.max_faults_per_op

    def _count(self, op: str, key: str) -> None:
        self._fault_counts[(op, key)] = \
            self._fault_counts.get((op, key), 0) + 1

    def _roll(self, op: str, key: str) -> bool:
        """Pre-op error draw; returns whether to corrupt the payload.

        Both draws are taken unconditionally so the fault schedule for a
        seed depends only on the op sequence, not on earlier outcomes.
        """
        u_err = float(self._rng.random())
        u_corrupt = float(self._rng.random())
        self.stats.n_ops += 1
        if op not in self.ops or self._exhausted(op, key):
            return False
        if u_err < self.p_transient:
            self.stats.n_transient += 1
            self._count(op, key)
            raise TransientStoreError(f"{op} {key!r}: injected 503", 503)
        if u_err < self.p_transient + self.p_permanent:
            self.stats.n_permanent += 1
            self._count(op, key)
            raise PermanentStoreError(f"{op} {key!r}: injected permanent "
                                      f"failure")
        if u_corrupt < self.p_corrupt:
            self._count(op, key)
            return True
        return False

    # -------------------------------------------------------- faulted ops
    def get(self, key: str) -> bytes:
        corrupt = self._roll("get", key)
        raw = self._inner.get(key)
        if corrupt:
            self.stats.n_corrupt_get += 1
            return _flip(raw)
        return raw

    def put(self, key: str, raw: bytes, tier: int, codec: str = "none",
            expect_checksum: Optional[str] = None) -> int:
        corrupt = self._roll("put", key)
        if corrupt:
            self.stats.n_corrupt_put += 1
            raw = _flip(raw)
        return self._inner.put(key, raw, tier, codec,
                               expect_checksum=expect_checksum)

    def replace(self, key: str, raw: bytes, new_tier: int,
                codec: str = "none",
                expect_checksum: Optional[str] = None) -> int:
        corrupt = self._roll("replace", key)
        if corrupt:
            self.stats.n_corrupt_put += 1
            raw = _flip(raw)
        return self._inner.replace(key, raw, new_tier, codec,
                                   expect_checksum=expect_checksum)

    def change_tier(self, key: str, new_tier: int) -> None:
        self._roll("change_tier", key)
        self._inner.change_tier(key, new_tier)

    def delete(self, key: str) -> None:
        self._roll("delete", key)
        self._inner.delete(key)
