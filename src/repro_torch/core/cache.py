"""Serving cache tier: forecast-driven admission in front of the tiered store.

A copy of ``repro.core.cache``: what the batch placement path prices, and
the reactive LRU baseline (:class:`ReactiveLRUCache`). A :class:`CacheConfig` on ``ScopeConfig.cache`` puts a
fixed-capacity hot cache in front of the placement: admitted partitions
serve ``1 - miss_rate`` of their reads at ``hit_latency_ms``. Cache
**storage/fill spend is real cents**; SLA **latency penalties are not
cents** and are reported separately.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.costs import CostTable, Weights

__all__ = ["CacheConfig", "forecast_admission", "cache_access_adjustment",
           "cache_cents", "served_latency_terms", "weighted_p99_ms",
           "ReactiveLRUCache"]


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Serving cache tier parameters (see ``repro.core.cache.CacheConfig``)."""

    capacity_gb: float
    hit_latency_ms: float = 1.0
    storage_cents_gb_month: float = 25.0
    fill_cents_gb: float = 0.0
    miss_rate: float = 0.05
    min_rho: float = 0.0
    p_hot_threshold: float = 0.5


def forecast_admission(rho: np.ndarray, spans_gb: np.ndarray,
                       config: CacheConfig,
                       p_hot: Optional[np.ndarray] = None) -> np.ndarray:
    """(N,) bool admission mask: greedy by rho density under the capacity.
    Deterministic: ties broken by partition index."""
    rho = np.asarray(rho, np.float64)
    spans = np.asarray(spans_gb, np.float64)
    ok = rho >= config.min_rho
    if p_hot is not None:
        ok &= np.asarray(p_hot, np.float64) >= config.p_hot_threshold
    ok &= spans <= config.capacity_gb          # a partition must fit at all
    cached = np.zeros(rho.shape[0], bool)
    if not ok.any():
        return cached
    density = np.where(spans > 0, rho / np.maximum(spans, 1e-12), np.inf)
    # stable sort on -density -> density desc, index asc on ties
    order = np.argsort(-density[ok], kind="stable")
    idx = np.flatnonzero(ok)[order]
    free = float(config.capacity_gb)
    for i in idx:
        if spans[i] <= free:
            cached[i] = True
            free -= float(spans[i])
    return cached


def cache_access_adjustment(rho: np.ndarray, stored_nlk: np.ndarray,
                            decomp_sec: np.ndarray, table: CostTable,
                            weights: Weights, cached: np.ndarray,
                            miss_rate: float) -> np.ndarray:
    """(N,L,K) additive cost delta for cache-served reads; non-cached rows
    get exactly 0.0."""
    access = (table.compute_cents_sec * decomp_sec[:, None, :]
              + table.read_cents_gb[None, :, None] * stored_nlk)
    relief = (weights.beta * (1.0 - float(miss_rate))
              * np.asarray(rho, np.float64)[:, None, None] * access)
    return np.where(np.asarray(cached, bool)[:, None, None], -relief, 0.0)


def cache_cents(spans_gb: np.ndarray, cached: np.ndarray,
                config: CacheConfig, months: float) -> float:
    """Steady cache spend: storage of admitted raw bytes over ``months``
    plus the one-off fill write."""
    gb = float(np.asarray(spans_gb, np.float64)[np.asarray(cached, bool)]
               .sum())
    return gb * (config.storage_cents_gb_month * float(months)
                 + config.fill_cents_gb)


def served_latency_terms(rho: np.ndarray, lat_ms: np.ndarray,
                         cached: Optional[np.ndarray],
                         config: Optional[CacheConfig],
                         ):
    """``(lat_points_ms, weights)``: each partition's backing latency
    weighted by its (miss) traffic, plus ``hit_latency_ms`` weighted by the
    hit traffic of admitted partitions."""
    rho = np.asarray(rho, np.float64)
    lat_ms = np.asarray(lat_ms, np.float64)
    if cached is None or config is None:
        return lat_ms, rho
    cached = np.asarray(cached, bool)
    m = float(config.miss_rate)
    backing_w = np.where(cached, m * rho, rho)
    hit_w = np.where(cached, (1.0 - m) * rho, 0.0)
    return (np.concatenate([lat_ms, np.full(rho.shape[0],
                                            config.hit_latency_ms)]),
            np.concatenate([backing_w, hit_w]))


def weighted_p99_ms(lat_ms: np.ndarray, weights: np.ndarray,
                    q: float = 0.99) -> float:
    """Weighted latency quantile: smallest latency covering ``q`` of the
    access mass. 0.0 when there is no traffic at all."""
    lat_ms = np.asarray(lat_ms, np.float64)
    w = np.asarray(weights, np.float64)
    total = float(w.sum())
    if total <= 0.0 or lat_ms.size == 0:
        return 0.0
    order = np.argsort(lat_ms, kind="stable")
    cum = np.cumsum(w[order])
    i = int(np.searchsorted(cum, q * total, side="left"))
    return float(lat_ms[order][min(i, lat_ms.size - 1)])


class ReactiveLRUCache:
    """Reactive admit-on-access LRU cache — the benchmark baseline.

    No forecast: a partition enters the cache only when it is actually
    read, so the first (spiky) month of traffic is always served from the
    backing tier. Eviction is least-recently-used by access order.
    """

    def __init__(self, capacity_gb: float):
        self.capacity_gb = float(capacity_gb)
        self._sizes: Dict[int, float] = {}     # key -> GB, insertion = LRU
        self._used = 0.0

    @property
    def used_gb(self) -> float:
        return self._used

    def contains(self, key: int) -> bool:
        return key in self._sizes

    def access(self, key: int, gb: float) -> bool:
        """Touch ``key``; admit (evicting LRU victims) if absent.

        Returns True when the access was a HIT (already resident)."""
        hit = key in self._sizes
        if hit:
            self._sizes[key] = self._sizes.pop(key)   # move to MRU end
            return True
        gb = float(gb)
        if gb > self.capacity_gb:
            return False                              # can never fit
        while self._used + gb > self.capacity_gb and self._sizes:
            lru = next(iter(self._sizes))             # oldest insertion
            self._used -= self._sizes.pop(lru)
        self._sizes[key] = gb
        self._used += gb
        return False

    def mask(self, n: int) -> np.ndarray:
        """(n,) bool residency mask over integer keys ``0..n-1``."""
        out = np.zeros(n, bool)
        for k in self._sizes:
            if 0 <= k < n:
                out[k] = True
        return out
