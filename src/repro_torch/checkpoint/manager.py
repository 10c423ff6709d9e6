"""SCOPe-managed checkpointing: every checkpoint shard is a data partition
whose (tier, codec) is chosen by OPTASSIGN with COMPREDICT-style predicted
compression stats — the paper's pipeline applied to the framework's own
storage.

* save(step, tree): leaves are chunked into shards; a 64 KiB sample of each
  shard is measured against the candidate codecs (the on-the-fly predictor —
  sampling IS the paper's query-derived-sample idea applied to tensor
  bytes); OPTASSIGN (greedy, Thm 3) then picks (tier, codec) per shard
  given the projected restore rate, which decays with checkpoint age
  exactly like the paper's recency access pattern (Fig 1b).
* Each save re-optimizes OLD checkpoints' placement (the paper's
  beginning-of-billing-period batch re-run): stale checkpoints migrate to
  cool/archive through store.change_tier, paying tier-change costs.
* Writes are async (background thread); the manifest commits LAST, so a
  crash mid-save can never yield a half checkpoint — restore only trusts
  manifests (fault tolerance / restart path).

Port of ``repro.checkpoint.manager``. A tree is dicts, tuples, lists and
``NamedTuple``s of tensors (``None`` is an empty subtree); its leaves are
named and ordered as ``jax.tree_util`` names them (``['k']`` for a dict
key, keys sorted; ``[i]`` for an index; ``.name`` for a ``NamedTuple``
field), and each leaf's bytes and dtype string are the ones the reference
writes (bfloat16 as ml_dtypes' bits), so either package reads the other's
manifests. ``save`` copies every leaf to host bytes before it returns, so
a caller may update the tensors in place while the write runs. The greedy
argmin runs on ``device`` (default ``"cuda"``); sampling, compression and
the store are host code. ``restore`` rebuilds the tree on the device it is
given, or, with a mesh and a tree of ``sharding.Spec``, each rank's pieces
of it (the elastic restore onto any topology).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.costs import (CostTable, Weights, cost_tensor,
                                    latency_feasible)
from repro_torch.core.optassign import greedy_assign
from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed.sharding import Spec, shard_leaf
from repro_torch.storage.codecs import (available_schemes, codec_by_name,
                                        measure)
from repro_torch.storage.store import TieredStore

SHARD_BYTES = 4 << 20          # 4 MiB shards
SAMPLE_BYTES = 64 << 10
CANDIDATE_CODECS = available_schemes(("none", "zlib-1", "zstd-3", "lzma-1"))


@dataclasses.dataclass
class _ShardMeta:
    key: str
    leaf_path: str
    offset: int
    nbytes: int
    codec: str
    tier: int
    sha256: str


def _flatten(tree, path: str, out: List[Tuple[str, Any]]) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{path}[{k!r}]", out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            _flatten(v, f"{path}.{name}", out)
    elif isinstance(tree, (tuple, list)) and not isinstance(tree, Spec):
        for i, v in enumerate(tree):
            _flatten(v, f"{path}[{i}]", out)
    else:
        out.append((path, tree))


def _leaf_paths(tree) -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` in ``jax.tree_util.tree_flatten_with_path``'s
    order and naming."""
    out: List[Tuple[str, Any]] = []
    _flatten(tree, "", out)
    return out


def _leaf_bytes(leaf) -> Tuple[bytes, List[int], str]:
    """A leaf's raw bytes (C order), shape and numpy dtype string."""
    t = torch.as_tensor(leaf).detach()
    raw = t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
    return raw, list(t.shape), str(t.dtype).removeprefix("torch.")


def shard_tree(tree) -> Tuple[list, List[Tuple[str, int, bytes]]]:
    """The manifest's leaf specs ``(path, shape, dtype)`` and the shards
    ``(path, offset, bytes)`` of ``tree``: each leaf's bytes cut into
    ``SHARD_BYTES`` pieces (one empty shard for an empty leaf)."""
    specs, blobs = [], []
    for path, leaf in _leaf_paths(tree):
        raw, shape, dt = _leaf_bytes(leaf)
        specs.append((path, shape, dt))
        for off in range(0, max(len(raw), 1), SHARD_BYTES):
            blobs.append((path, off, raw[off:off + SHARD_BYTES]))
    return specs, blobs


def _restore_rate(age_steps: int, horizon: int = 5) -> float:
    """Projected restores per period: newest checkpoints are the live
    restart targets; older ones are kept for rollback/analysis (recency
    decay, paper Fig 1b)."""
    return 4.0 * float(np.exp(-age_steps / max(horizon, 1)))


class CheckpointManager:
    def __init__(self, store: TieredStore, prefix: str = "ckpt",
                 table: Optional[CostTable] = None,
                 latency_sla_sec: float = 120.0,
                 tier_whitelist: Tuple[int, ...] = (0, 1, 2, 3),
                 keep: int = 8, device: DeviceLike = "cuda"):
        self.store = store
        self.table = table or store.table
        self.prefix = prefix
        self.latency_sla = latency_sla_sec
        self.tiers = tier_whitelist
        self.keep = keep
        self.device = resolve(device)
        self._manifests: Dict[int, dict] = {}
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ save
    def _feasible(self, D: np.ndarray) -> np.ndarray:
        N = D.shape[0]
        feas = latency_feasible(D, np.full(N, self.latency_sla), self.table)
        allowed = np.zeros(self.table.num_tiers, bool)
        allowed[list(self.tiers)] = True
        return feas & allowed[None, :, None]

    @staticmethod
    def measure_shards(blobs: List[bytes]):
        """Spans (GB) and the (N, K) ratio and decompression-seconds
        matrices of the shards over ``CANDIDATE_CODECS``, measured on each
        shard's first ``SAMPLE_BYTES`` (D is wall-clock time)."""
        N = len(blobs)
        K = len(CANDIDATE_CODECS)
        R = np.ones((N, K))
        D = np.zeros((N, K))
        spans = np.array([len(b) / 1e9 for b in blobs])
        for i, b in enumerate(blobs):
            sample = b[:SAMPLE_BYTES]
            for k, name in enumerate(CANDIDATE_CODECS):
                if name == "none":
                    continue
                m = measure(codec_by_name(name), sample)
                R[i, k] = max(m.ratio, 1.0)
                D[i, k] = m.decompress_sec_per_gb * spans[i]
        return spans, R, D

    def assign_shards(self, spans: np.ndarray, R: np.ndarray, D: np.ndarray,
                      rho: float):
        """(tier, codec) per shard: greedy OPTASSIGN on ``device``."""
        N = len(spans)
        cost = cost_tensor(spans, np.full(N, rho), np.full(N, -1), R, D,
                           self.table, Weights(), months=1.0)
        a = greedy_assign(cost, self._feasible(D), device=self.device)
        return a.tier, [CANDIDATE_CODECS[k] for k in a.scheme]

    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Checkpoint ``tree`` at ``step``. The leaves' bytes are taken
        before this returns; the shards and the manifest are written on a
        background thread unless ``blocking``."""
        specs, blobs = shard_tree(tree)
        tiers, codecs = self.assign_shards(
            *self.measure_shards([b for _, _, b in blobs]),
            rho=_restore_rate(0))
        metas: List[_ShardMeta] = []

        def _write():
            for i, (path, off, blob) in enumerate(blobs):
                key = f"{self.prefix}/{step}/{i:05d}"
                self.store.put(key, blob, tier=int(tiers[i]),
                               codec=codecs[i])
                metas.append(_ShardMeta(key, path, off, len(blob),
                                        codecs[i], int(tiers[i]),
                                        hashlib.sha256(blob).hexdigest()))
            manifest = {
                "step": step,
                "leaves": specs,
                "shards": [dataclasses.asdict(m) for m in metas],
                "written": time.time(),
            }
            # manifest commits LAST -> crash mid-save leaves no valid ckpt
            self.store.put(f"{self.prefix}/{step}/MANIFEST",
                           json.dumps(manifest).encode(), tier=0)
            with self._lock:
                self._manifests[step] = manifest
            self._lifecycle(step)

        if blocking:
            _write()
        else:
            self.wait()
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------- lifecycle re-optimize
    def _lifecycle(self, current_step: int) -> None:
        """Re-run OPTASSIGN over ALL retained checkpoints with age-decayed
        restore projections; migrate shards whose optimal tier changed."""
        with self._lock:
            steps = sorted(self._manifests)
        # retention
        for s in steps[:-self.keep] if len(steps) > self.keep else []:
            self.delete(s)
            steps.remove(s)
        for age, s in enumerate(reversed(steps)):
            man = self._manifests[s]
            rho = _restore_rate(age)
            spans = np.array([m["nbytes"] / 1e9 for m in man["shards"]])
            stored_tiers = np.array([self.store.tier_of(m["key"])
                                     for m in man["shards"]])
            N = len(spans)
            R = np.ones((N, 1))
            D = np.zeros((N, 1))
            cost = cost_tensor(spans, np.full(N, rho), stored_tiers, R, D,
                               self.table, Weights(), months=1.0)
            a = greedy_assign(cost, self._feasible(D), device=self.device)
            for m, t in zip(man["shards"], a.tier):
                if int(t) != self.store.tier_of(m["key"]):
                    self.store.change_tier(m["key"], int(t))
                    m["tier"] = int(t)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        with self._lock:
            cached = sorted(self._manifests)
        if cached:
            return cached[-1]
        # cold start: scan the store for manifests
        steps = []
        for key in self.store.keys():
            if key.startswith(f"{self.prefix}/") and key.endswith("MANIFEST"):
                steps.append(int(key.split("/")[1]))
        return max(steps) if steps else None

    def restore(self, like, step: Optional[int] = None, *,
                device: DeviceLike = "cuda", mesh=None, shardings=None):
        """Rebuild ``like``'s tree from checkpoint ``step`` (default: the
        latest) as tensors of each leaf's saved dtype on ``device``.
        Every shard's sha256 is checked. Returns ``(tree, step)``.

        With a ``mesh`` (a DeviceMesh) and ``shardings``, a tree of
        :class:`~repro_torch.distributed.sharding.Spec` shaped like
        ``like`` (``param_specs``, ``zero1_specs``, ...), each leaf is this
        rank's piece of it (``sharding.shard_leaf``): a local tensor, as
        the tensor-parallel layers take them. Leaves are rebuilt one at a
        time on the host and narrowed there before they are copied, so
        the device never holds a whole sharded leaf. A spec that does not
        divide its leaf raises ``ValueError``, as does one of ``mesh`` and
        ``shardings`` without the other."""
        if (mesh is None) != (shardings is None):
            raise ValueError("mesh and shardings go together: give both to "
                             "restore each rank's pieces, or neither")
        specs = dict(_leaf_paths(shardings)) if mesh is not None else {}
        dev = resolve(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        man = self._manifests.get(step)
        if man is None:
            man = json.loads(
                self.store.get(f"{self.prefix}/{step}/MANIFEST").decode())
            with self._lock:
                self._manifests[step] = man
        by_leaf: Dict[str, List[dict]] = {}
        for m in man["shards"]:
            by_leaf.setdefault(m["leaf_path"], []).append(m)
        leaves: Dict[str, torch.Tensor] = {}
        for path, shape, dt in man["leaves"]:       # the shards' order
            buf = bytearray()
            for m in by_leaf[path]:
                blob = self.store.get(m["key"])
                if hashlib.sha256(blob).hexdigest() != m["sha256"]:
                    raise IOError(f"corrupt shard {m['key']}")
                buf.extend(blob)
            dtype = getattr(torch, dt)
            t = (torch.frombuffer(buf, dtype=dtype) if len(buf)
                 else torch.empty(0, dtype=dtype)).reshape(shape)
            if path in specs:
                t = shard_leaf(t, specs[path], mesh)
            leaves[path] = t.to(dev, copy=True)
            del buf, t
        return _rebuild(like, "", leaves), step

    def delete(self, step: int) -> None:
        man = self._manifests.pop(step, None)
        if man is None:
            return
        for m in man["shards"]:
            self.store.delete(m["key"])
        self.store.delete(f"{self.prefix}/{step}/MANIFEST")


def _rebuild(like, path: str, leaves: Dict[str, torch.Tensor]):
    """``like``'s structure with each leaf replaced by the restored tensor
    at its path (the walk and names of :func:`_flatten`)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, f"{path}[{k!r}]", leaves)
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, f"{path}.{name}", leaves)
                            for name, v in zip(like._fields, like)))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, f"{path}[{i}]", leaves)
                          for i, v in enumerate(like))
    return leaves[path]
