"""Sharding rules: parameter spec trees, batch and cache specs, ZeRO-1.

Port of ``repro.distributed.sharding``, the same rules leaf for leaf.
Megatron-style tensor parallelism on the 'model' axis, data parallelism
over ('pod', 'data'):

* embed / lm_head               vocab-sharded
* wq, mlp up/gate               column-parallel (output dim)
* wo, mlp down                  row-parallel (input dim)
* wk/wv                         head-sharded when kv_heads % tp == 0 (or
                                MHA), else replicated (GQA-standard)
* MoE experts_*                 expert-parallel (leading E axis)
* mamba in_z/in_x/conv_x/out_proj  head-channel-sharded; in_bc/in_dt tiny,
                                replicated; per-head vectors (A_log, D,
                                dt_bias) sharded over heads when they divide

A spec is a :class:`Spec`: per tensor dimension an axis name, a tuple of
axis names (sharded over their product, the first major) or None
(replicated), the port's counterpart of ``PartitionSpec``. Leaf specs are
matched by the parameter's name (the nearest dict key above it); stacked
parameters get leading None axes padded by rank. :func:`to_named` turns a
spec into the DTensor placements ``torch.distributed.tensor.distribute_tensor``
takes, ``Shard(i)`` or ``Replicate()`` per mesh dimension.

Under a mesh each rank holds this rank's piece of every leaf as a plain
tensor, which :func:`shard_tree` cuts: the ``torch.chunk`` piece along
each dimension that names an axis, what ``to_named``'s ``Shard(i)``
names. The weights follow ``param_specs`` (the layers' collectives are in
:mod:`repro_torch.distributed.ctx`), the decode cache ``cache_specs``
(sequence over 'model', Mamba's conv_x by channels and its SSM state by
heads), the batch ``batch_specs``, and the optimizer's master weights and
moments ``zero1_specs`` (ZeRO-1: the parameters' specs with one more
dimension over 'data'). :func:`local_bytes` counts what a rank holds and
:func:`reckoned_bytes` what the specs say it holds; the two are equal.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.config import ModelConfig


class Spec(tuple):
    """A partition spec: one entry per tensor dimension, each an axis name,
    a tuple of axis names or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def map_specs(fn, *trees):
    """Apply ``fn`` leaf by leaf over trees of dicts, tuples and lists
    whose leaves are :class:`Spec` (or tensors beside them); None stays
    None. The first tree gives the structure."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, Spec) or not isinstance(t, (dict, tuple, list)):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: map_specs(fn, *(x[k] for x in trees)) for k in t}
    return type(t)(map_specs(fn, *(x[i] for x in trees))
                   for i in range(len(t)))


def _rules(cfg: ModelConfig, tp: int) -> Dict[str, Spec]:
    kv_shardable = cfg.n_kv_heads > 0 and (
        cfg.n_kv_heads % tp == 0 or cfg.n_kv_heads == cfg.n_heads)
    kv = Spec(None, "model") if kv_shardable else Spec(None, None)
    kv_b = Spec("model") if kv_shardable else Spec(None)
    h_shardable = cfg.mamba_heads % tp == 0 if cfg.ssm_state else False
    hvec = Spec("model") if h_shardable else Spec(None)
    return {
        # embedding / head
        "embed": Spec("model", None),
        "lm_head": Spec(None, "model"),
        "final_norm": Spec(None),
        # attention
        "wq": Spec(None, "model"), "bq": Spec("model"),
        "wk": kv, "bk": kv_b, "wv": kv, "bv": kv_b,
        "wo": Spec("model", None),
        "q_norm": Spec(None), "k_norm": Spec(None),
        # MLA
        "w_dkv": Spec(None, None), "kv_norm": Spec(None),
        "w_uk": Spec(None, "model"), "w_uv": Spec(None, "model"),
        # MLP
        "gate": Spec(None, "model"), "up": Spec(None, "model"),
        "down": Spec("model", None),
        # MoE
        "router": Spec(None, None),
        "experts_gate": Spec("model", None, None),
        "experts_up": Spec("model", None, None),
        "experts_down": Spec("model", None, None),
        # norms
        "ln1": Spec(None), "ln2": Spec(None), "lnc": Spec(None),
        "post_ln1": Spec(None), "post_ln2": Spec(None),
        # mamba2
        "in_z": Spec(None, "model"), "in_x": Spec(None, "model"),
        "in_bc": Spec(None, None),
        "in_dt": Spec(None, "model") if h_shardable else Spec(None, None),
        "conv_x_w": Spec(None, "model"), "conv_x_b": Spec("model"),
        "conv_bc_w": Spec(None, None), "conv_bc_b": Spec(None),
        "A_log": hvec, "D": hvec, "dt_bias": hvec,
        "gate_norm": Spec("model"),
        "out_proj": Spec("model", None),
    }


def param_specs(params_tree, cfg: ModelConfig, tp: int):
    """Spec tree matching ``params_tree`` (tensors, meta tensors included,
    or anything with ``ndim``)."""
    rules = _rules(cfg, tp)

    def walk(t, name):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, name) for v in t)
        base = rules.get(name, Spec())
        pad = t.ndim - len(base)
        if pad < 0:
            raise ValueError(f"{name}: rank {t.ndim} below its rule {base}")
        return Spec(*([None] * pad), *base)

    return walk(params_tree, None)


def _dp(mesh, batch: Optional[int] = None):
    """The data-parallel spec entry; None (replication) when the global
    batch does not divide the data axes (e.g. long_500k's batch 1)."""
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in sizes if a in ("pod", "data"))
    total = 1
    for a in dp:
        total *= sizes[a]
    if batch is not None and batch % total != 0:
        return None
    return dp if len(dp) > 1 else dp[0]


def batch_specs(cfg: ModelConfig, mesh, kind: str = "train",
                batch: Optional[int] = None) -> Dict[str, Spec]:
    """Input specs: the batch over ('pod', 'data'); sequence and model
    unsharded for token inputs."""
    dp = _dp(mesh, batch)
    spec = {"tokens": Spec(dp, None), "labels": Spec(dp, None)}
    if cfg.cross_context:
        spec["context"] = Spec(dp, None, None)
    if cfg.encoder_stages is not None:
        spec["frames"] = Spec(dp, None, None)
    return spec


def cache_specs(cfg: ModelConfig, mesh, batch: Optional[int] = None
                ) -> Tuple:
    """Decode caches: batch over the data axes, sequence over 'model' (the
    sequence-sharded decode); mamba states: batch over the data axes,
    heads over 'model' when they divide. The tree mirrors
    ``transformer.init_cache``'s."""
    dp = _dp(mesh, batch)
    kv = Spec(None, dp, "model", None, None)      # (rep, B, S, hkv, hd)
    mla = Spec(None, dp, "model", None)           # (rep, B, S, r + rope)
    h_shardable = cfg.ssm_state and \
        cfg.mamba_heads % axis_sizes(mesh)["model"] == 0
    conv = Spec(None, dp, None, "model")          # (rep, B, W - 1, C)
    ssm = Spec(None, dp, "model" if h_shardable else None, None, None)
    specs = []
    for s in cfg.stages:
        unit = []
        for kind in s.unit:
            if kind in ("attn", "attn_local", "moe", "decoder", "shared_attn"):
                unit.append((kv, kv))
            elif kind in ("mla_dense", "mla_moe"):
                unit.append(mla)
            elif kind == "mamba":
                unit.append((conv, Spec(None, dp, None, None), ssm))
            else:
                unit.append(None)
        specs.append(tuple(unit))
    return tuple(specs)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension
    ``Shard(i)`` for the tensor dimension i that names it, else
    ``Replicate()``."""
    out = []
    for axis in axis_sizes(mesh):
        dims = [i for i, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def to_named(tree, mesh):
    """Spec tree -> tree of DTensor placement tuples (None stays None)."""
    return map_specs(lambda s: placements(s, mesh), tree)


def zero1_specs(spec_tree, struct_tree, dp_axis: str = "data",
                dp_size: int = 16):
    """ZeRO-1: optimizer-state specs = the parameters' specs with the
    first unsharded dimension that divides by ``dp_size`` (and is at least
    that long) sharded over ``dp_axis`` too."""

    def f(spec, leaf):
        entries = list(spec) + [None] * (leaf.ndim - len(spec))
        for i, (e, d) in enumerate(zip(entries, leaf.shape)):
            if e is None and d % dp_size == 0 and d >= dp_size:
                entries[i] = dp_axis
                break
        return Spec(*entries)

    return map_specs(f, spec_tree, struct_tree)


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _coord(mesh, entry) -> Tuple[int, int]:
    """(this rank's index, the number of pieces) along a spec entry: one
    axis, or axes flattened with the first major."""
    sizes = axis_sizes(mesh)
    idx, n = 0, 1
    for a in _axes(entry):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def shard_leaf(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's piece of ``t`` (a view): along each dimension whose
    entry names axes, the ``torch.chunk`` piece of this rank's
    coordinate. A dimension that does not divide is refused, as
    ``jax.device_put`` refuses such a sharding."""
    for dim, e in enumerate(spec):
        if e is None:
            continue
        i, n = _coord(mesh, e)
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"divide over {n} ranks ({e})")
        per = t.shape[dim] // n
        t = t.narrow(dim, i * per, per)
    return t


def shard_tree(tree, specs, mesh):
    """This rank's pieces (views) of a whole tree under its spec tree."""
    return map_specs(lambda s, t: shard_leaf(t, s, mesh), specs, tree)


def leaves(tree) -> list:
    """The leaves of a tree of tensors or of specs, in the
    order of ``transformer.tree_leaves``; None holds none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, Spec):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def local_bytes(tree) -> int:
    """Bytes of the tensors a rank holds in ``tree``."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def reckoned_bytes(structs, specs, mesh) -> int:
    """Bytes a rank holds of whole leaves ``structs`` (meta tensors, or
    any tensors) sharded by ``specs`` on ``mesh``: each leaf's bytes over
    the number of pieces its sharded dimensions are cut into."""
    sizes = axis_sizes(mesh)
    total = 0
    for t, spec in zip(leaves(structs), leaves(specs)):
        pieces = math.prod(sizes[a] for e in spec if e is not None
                           for a in _axes(e))
        total += t.numel() * t.element_size() // pieces
    return total


def spec_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dimension of ``spec`` sharded over ``axis``, or None."""
    for i, e in enumerate(spec):
        if e is not None and axis in _axes(e):
            return i
    return None
