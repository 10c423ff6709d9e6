"""Tiered training-data pipeline with prefetch and straggler mitigation.

A copy of ``repro.data.loader`` (the port imports nothing of ``repro``):
the same shards, the same order and the same numpy batches from a seed.

Data shards (tokenized sequences) live in the TieredStore — their placement
is SCOPe-optimized like any other partition (G-PART groups shards that
training jobs read together; OPTASSIGN tiers them by epoch access rate).

Fault-tolerance / scale features:
  * deterministic shard ownership: shard -> host by stable hash, so a
    restarted host recomputes exactly its assignment (no coordinator);
  * prefetch thread with a bounded queue (overlaps storage latency with
    compute);
  * straggler mitigation: a fetch slower than ``straggler_factor`` x the
    EWMA fetch time is re-issued against the backup replica owner
    (hash+1); first responder wins (speculative retry — MapReduce-style);
  * resumable: iteration order is a seeded permutation, (epoch, index)
    checkpointable alongside the model.
"""

from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.storage.codecs import available_schemes
from repro_torch.storage.store import TieredStore

# Preferred shard codec, degrading to what this environment has installed.
DEFAULT_SHARD_CODEC = available_schemes(("zstd-3", "zlib-1", "none"))[0]


def stable_hash(key: str, salt: int = 0) -> int:
    return int.from_bytes(hashlib.sha256(f"{salt}:{key}".encode()
                                         ).digest()[:8], "big")


def shard_owner(shard: str, n_hosts: int, replica: int = 0) -> int:
    return (stable_hash(shard) + replica) % max(n_hosts, 1)


@dataclasses.dataclass
class LoaderStats:
    fetches: int = 0
    speculative_retries: int = 0
    ewma_fetch_s: float = 0.0


def write_token_shards(store: TieredStore, n_shards: int, rows: int,
                       seq: int, vocab: int, seed: int = 0,
                       tier: int = 1, codec: Optional[str] = None,
                       prefix: str = "data") -> List[str]:
    """Synthetic Zipf-token corpus, sharded into the store."""
    codec = codec or DEFAULT_SHARD_CODEC
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -1.1
    p /= p.sum()
    keys = []
    for i in range(n_shards):
        toks = rng.choice(vocab, size=(rows, seq + 1), p=p).astype(np.int32)
        key = f"{prefix}/{i:05d}"
        store.put(key, toks.tobytes(), tier=tier, codec=codec)
        keys.append(key)
    return keys


class TieredDataLoader:
    def __init__(self, store: TieredStore, shards: Sequence[str],
                 batch: int, seq: int, host_id: int = 0, n_hosts: int = 1,
                 seed: int = 0, prefetch: int = 2,
                 straggler_factor: float = 3.0,
                 fetch_timeout_s: float = 5.0,
                 fetch_fn=None):
        self.store = store
        self.shards = list(shards)
        self.batch, self.seq = batch, seq
        self.host_id, self.n_hosts = host_id, n_hosts
        self.seed = seed
        self.prefetch = prefetch
        self.straggler_factor = straggler_factor
        self.fetch_timeout_s = fetch_timeout_s
        self.stats = LoaderStats()
        # injectable fetch (tests simulate slow replicas / dead hosts)
        self._fetch = fetch_fn or (lambda key, replica: self.store.get(key))

    # ------------------------------------------------------------ ownership
    def my_shards(self, epoch: int) -> List[str]:
        order = sorted(self.shards,
                       key=lambda s: stable_hash(s, salt=self.seed + epoch))
        return [s for s in order
                if shard_owner(s, self.n_hosts) == self.host_id]

    # ------------------------------------------------------------- fetching
    def _timed_fetch(self, key: str, replica: int) -> bytes:
        t0 = time.perf_counter()
        blob = self._fetch(key, replica)
        dt = time.perf_counter() - t0
        st = self.stats
        st.fetches += 1
        st.ewma_fetch_s = dt if st.fetches == 1 else \
            0.8 * st.ewma_fetch_s + 0.2 * dt
        return blob

    def fetch_with_backup(self, key: str) -> bytes:
        """Speculative retry: if the primary fetch exceeds
        straggler_factor x EWMA (or the hard timeout), race the backup."""
        budget = max(self.straggler_factor * self.stats.ewma_fetch_s, 1e-3)
        budget = min(budget, self.fetch_timeout_s)
        result: queue.Queue = queue.Queue()

        def _try(replica: int):
            try:
                result.put((replica, self._timed_fetch(key, replica)))
            except Exception as e:  # noqa: BLE001 — surfaced via queue
                result.put((replica, e))

        t = threading.Thread(target=_try, args=(0,), daemon=True)
        t.start()
        try:
            replica, blob = None, None
            got = result.get(timeout=budget if self.stats.fetches >= 3
                             else self.fetch_timeout_s)
            if isinstance(got[1], Exception):
                raise got[1]
            return got[1]
        except queue.Empty:
            self.stats.speculative_retries += 1
            t2 = threading.Thread(target=_try, args=(1,), daemon=True)
            t2.start()
            got = result.get(timeout=self.fetch_timeout_s)
            if isinstance(got[1], Exception):
                raise got[1]
            return got[1]

    # ------------------------------------------------------------- batching
    def batches(self, epoch: int = 0,
                start_index: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator over {tokens, labels} batches."""
        my = self.my_shards(epoch)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            for key in my[start_index:]:
                blob = self.fetch_with_backup(key)
                toks = np.frombuffer(blob, np.int32).reshape(-1, self.seq + 1)
                q.put(toks)
            q.put(stop)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        buf = np.zeros((0, self.seq + 1), np.int32)
        while True:
            item = q.get()
            if item is stop:
                break
            buf = np.concatenate([buf, item]) if buf.size else item
            while len(buf) >= self.batch:
                chunk, buf = buf[:self.batch], buf[self.batch:]
                yield {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
